#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card: name and power limit (nvidia-smi); build every kernel of the
   serving path from the sources in this checkout (one nvcc per CUDA
   source, all at once; the Triton rmsnorm compiles at its first call).
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the shapes phi4-mini-3.8b's serving path gives it,
   with its time, the plain version's time, one PyTorch library call
   that computes the same function (a yardstick the port never calls)
   and the least time the card could take (bytes over 3.35 TB/s or
   operations over the peak rate, whichever is larger).  Each attention
   case also holds the kernel's output against plain versions with a
   planted fault (a key tile dropped, a row's own key masked, fp8 / int8
   scales ignored); each of those must fail the tolerance.
3. end to end: phi4-mini-3.8b at full width in bf16 (random weights
   drawn on the card from seed 0) serves 8 requests with prompts of
   64..1024 tokens, staggered arrivals and 32 new tokens each through
   ``repro_torch.launch.serve.serve_paged``, once with whole-prompt
   prefill and once with prefill chunks of 256.  Every kernel's launch
   counter is zeroed before each run and must be > 0 after it.  Then
   the kernel path and the plain path are held against each other on
   the same prompts: first-token logits and 4 teacher-forced decode
   ticks through a fragmented paged pool.

Every result is printed as one JSON object per line.  The last line is
{"ok": true, "device": {...}}; the line before it lists every kernel's
numbers as one JSON object, and the line before that the card.
"""
import dataclasses
import json
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "phi4-mini-3.8b"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK = {"bf16_tensor": 989e12, "fp32": 67e12}
SEED = 0

# bf16 tolerances (atol, rtol), kernel vs plain version on the same
# inputs: both compute in fp32 and round the output to bf16 (one bf16 ulp
# is 2^-8 relative, 2 ulps is under 1e-2); the attention kernels also
# round P (and dequantized fp8 / int8 K, V) to bf16 before their
# tensor-core products.  Every case prints the share of its tolerance
# it used, and planted faults (``controls``) must exceed it.
TOL = {"rmsnorm": (1e-2, 1e-2), "flash_attention": (1e-2, 1e-2),
       "paged_chunk_attention": (8e-3, 1e-2)}
# end to end, kernel path vs plain path at full width: max |difference|
# over max |plain logit| — bf16 rounding differs per op across 32 layers
E2E_REL_TOL = 1.5e-2
KEY_TILE = 64      # keys per tile, BK in kernels/csrc/attn_tile.cuh

KERNEL_META = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                "src/repro/kernels/rmsnorm/kernel.py:36"),
    "flash_attention": (
        "cuda", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:105"),
    "paged_chunk_attention": (
        "cuda", "src/repro_torch/kernels/paged_chunk_attention/csrc/"
        "paged_chunk_attention.cu",
        "src/repro/kernels/paged_chunk_attention/kernel.py:105"),
}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------ measurement ---------------------------------


def _events_ms(run, iters):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters=20, warmup=3):
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed between two events, so the host's launch cost
    (Python, ctypes, Triton's launcher) is not counted."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, iters)
    del graph
    return ms


def host_ms(fn, iters=20, warmup=3):
    """Time per eager ``fn()`` call, launches included — what the
    serving loop pays when the host is the bottleneck."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def bound(nbytes, ops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, ref):
    """max |got - ref|, the share of the tolerance used (the largest
    |got - ref| / (atol + rtol |ref|) over the elements) and whether it
    passes: share <= 1 and every value finite."""
    import torch
    atol, rtol = TOL[name]
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    used = float((err / (atol + rtol * r.abs())).max())
    ok = used <= 1 and bool(torch.isfinite(g).all())
    return float(err.max()), used, ok


def controls(name, got, faulty):
    """The kernel's output held against plain versions with a planted
    fault: each must fail the tolerance (``caught``)."""
    out = []
    for fault, ref in faulty.items():
        err, used, ok = compare(name, got, ref)
        out.append({"fault": fault, "max_abs_err": err, "tol_used": used,
                    "caught": not ok})
    return out


# --------------------------------- kernels ----------------------------------


def check_rmsnorm(dev, n, d):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, d, device=dev, generator=g).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
    got, ref = rmsnorm(x, w), rmsnorm_ref(x, w)
    err, used, ok = compare("rmsnorm", got, ref)
    lib = getattr(F, "rms_norm", None)
    b_ms, b_by = bound(2 * n * d * 2 + d * 2, 4 * n * d, "fp32")
    return {"case": f"n={n},d={d},bf16", "max_abs_err": err,
            "tol_used": used, "ok": ok, "controls": [],
            "ms": time_ms(lambda: rmsnorm(x, w)),
            "host_ms": host_ms(lambda: rmsnorm(x, w)),
            "plain_ms": time_ms(lambda: rmsnorm_ref(x, w)),
            "library_ms": (time_ms(lambda: lib(x, (d,), w, 1e-6))
                           if lib else None),
            "bound_ms": b_ms, "bound_by": b_by}


def check_flash(dev, sq, kv_len, h=24, kvh=8, d=128):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    # the model's (b, s, h, d) layout, seen as (b, h, s, d) like the model
    q = torch.randn(1, sq, h, d, device=dev, generator=g).to(bf)
    k = torch.randn(1, sq, kvh, d, device=dev, generator=g).to(bf)
    v = torch.randn(1, sq, kvh, d, device=dev, generator=g).to(bf)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention(qt, kt, vt, kv_len=kv_len)
    ref = attention_ref(qt, kt, vt, kv_len=kv_len)
    err, used, ok = compare("flash_attention", got, ref)
    ctl = controls("flash_attention", got, {
        "last key tile dropped": attention_ref(
            qt, kt, vt, kv_len=kv_len - KEY_TILE),
        "own key masked": attention_ref(qt, kt, vt, q_offset=-1,
                                        kv_len=kv_len)})
    kr = kt.repeat_interleave(h // kvh, dim=1).contiguous()
    vr = vt.repeat_interleave(h // kvh, dim=1).contiguous()
    qc = qt.contiguous()
    if kv_len == sq:
        lib = lambda: F.scaled_dot_product_attention(qc, kr, vr,  # noqa
                                                     is_causal=True)
    else:
        pos = torch.arange(sq, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv_len)
        lib = lambda: F.scaled_dot_product_attention(qc, kr, vr,  # noqa
                                                     attn_mask=mask)
    # work this input needs: causal pairs among the first kv_len keys
    pairs = sum(min(i + 1, kv_len) for i in range(sq))
    # q read and o written; K and V only below kv_len (never fetched past)
    nbytes = (2 * sq * h * d + 2 * min(sq, kv_len) * kvh * d) * 2
    b_ms, b_by = bound(nbytes, 4 * d * h * pairs, "bf16_tensor")
    return {"case": f"sq=skv={sq},kv_len={kv_len},h={h},kvh={kvh},d={d}",
            "max_abs_err": err, "tol_used": used, "ok": ok,
            "controls": ctl,
            "ms": time_ms(lambda: flash_attention(qt, kt, vt,
                                                  kv_len=kv_len)),
            "host_ms": host_ms(lambda: flash_attention(qt, kt, vt,
                                                       kv_len=kv_len)),
            "plain_ms": time_ms(lambda: attention_ref(qt, kt, vt,
                                                      kv_len=kv_len), 5),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}


def check_paged(dev, *, kv_dtype, T, bs, b=8, h=24, kvh=8, d=128,
                dense_view=False, cap=1024, seed=3):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_chunk_attention import (
        paged_chunk_attention, paged_chunk_attention_ref)
    from repro_torch.models.attention import KV_DTYPES, bits, quantize_kv
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    # per-sequence query positions: a chunk of T ending inside 64..cap
    ends = rng.integers(max(64, T), cap, b)
    pos = np.stack([np.arange(e - T + 1, e + 1) for e in ends])
    pos[0, -min(T, 4):] = -1                  # padding rows -> exact zeros
    if b > 1:
        pos[-1, :] = -1                       # an idle slot
    if dense_view:
        bs, nbmax, nb = cap, 1, b
        tables = np.arange(b, dtype=np.int32)[:, None]
    else:
        nbmax = cap // bs
        nb = b * nbmax + 1
        tables = (rng.permutation(nb - 1)[:b * nbmax] + 1).reshape(
            b, nbmax).astype(np.int32)        # fragmented, block 0 scratch
    kf = torch.randn(nb, bs, kvh, d, device=dev, generator=g)
    vf = torch.randn(nb, bs, kvh, d, device=dev, generator=g)
    kp, ks = quantize_kv(kf, KV_DTYPES[kv_dtype])
    vp, vs = quantize_kv(vf, KV_DTYPES[kv_dtype])
    if kv_dtype == "bfloat16":
        ks = vs = None
    del kf, vf
    q = torch.randn(b, T, h, d, device=dev, generator=g).bfloat16()
    bt = torch.as_tensor(tables, device=dev)
    ps = torch.as_tensor(pos.astype(np.int32), device=dev)
    got = paged_chunk_attention(q, kp, vp, bt, ps, ks, vs)
    ref = paged_chunk_attention_ref(q, kp, vp, bt, ps, ks, vs)
    err, used, ok = compare("paged_chunk_attention", got, ref)
    # planted faults: each sequence's last key tile (the one holding its
    # largest position) skipped; each row's own key masked; for fp8 /
    # int8 pools, the scales ignored
    last = (ps.max(dim=1, keepdim=True).values // KEY_TILE) * KEY_TILE
    faulty = {"last key tile dropped": paged_chunk_attention_ref(
        q, kp, vp, bt, torch.where(ps >= 0, torch.minimum(ps, last - 1), ps),
        ks, vs),
        "own key masked": paged_chunk_attention_ref(
            q, kp, vp, bt, torch.where(ps >= 0, ps - 1, ps), ks, vs)}
    if ks is not None:
        faulty["scales ignored"] = paged_chunk_attention_ref(q, kp, vp, bt,
                                                             ps)
    ctl = controls("paged_chunk_attention", got, faulty)
    pad = ps < 0
    zeros_ok = bool(torch.all(got[pad] == 0))
    # library yardstick: SDPA on K/V gathered and dequantized beforehand
    S = tables.shape[1] * bs
    kg = bits(kp)[bt.long()].view(kp.dtype).reshape(b, S, kvh, d).float()
    vg = bits(vp)[bt.long()].view(vp.dtype).reshape(b, S, kvh, d).float()
    if ks is not None:
        kg = kg * ks[bt.long()].reshape(b, S)[:, :, None, None]
        vg = vg * vs[bt.long()].reshape(b, S)[:, :, None, None]
    grp = h // kvh
    kg = kg.bfloat16().transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    vg = vg.bfloat16().transpose(1, 2).repeat_interleave(grp, 1).contiguous()
    qg = q.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            <= ps[:, None, :, None])
    lib = lambda: F.scaled_dot_product_attention(qg, kg, vg,  # noqa: E731
                                                 attn_mask=mask)
    # what this input needs: q of the rows at a position >= 0, o of every
    # row, each sequence's keys (and their table entries) up to its
    # largest query position, once; every valid (row, key) pair for the
    # products
    elt = kp.element_size()
    need = np.maximum(pos.max(axis=1) + 1, 0)
    rows = int((pos >= 0).sum())
    nbytes = ((rows + b * T) * h * d * 2
              + int(need.sum()) * kvh * d * elt * 2
              + (int(need.sum()) * 4 * 2 if ks is not None else 0)
              + int((-(-need // bs)).sum()) * 4 + ps.numel() * 4)
    pairs = int(np.where(pos >= 0, pos + 1, 0).sum()) * h
    b_ms, b_by = bound(nbytes, 4 * d * pairs, "bf16_tensor")
    view = f"dense-view S={cap}" if dense_view else f"bs={bs}"
    res = {"case": f"{view},T={T},b={b},{kv_dtype},fragmented="
                   f"{not dense_view}",
           "max_abs_err": err, "tol_used": used, "ok": ok and zeros_ok,
           "padding_rows_zero": zeros_ok, "controls": ctl,
           "ms": time_ms(lambda: paged_chunk_attention(q, kp, vp, bt, ps,
                                                       ks, vs)),
           "host_ms": host_ms(lambda: paged_chunk_attention(q, kp, vp, bt,
                                                            ps, ks, vs)),
           "plain_ms": time_ms(lambda: paged_chunk_attention_ref(
               q, kp, vp, bt, ps, ks, vs), 5),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    return res


def kernel_phase(dev):
    cases = {"rmsnorm": [], "flash_attention": [],
             "paged_chunk_attention": []}
    for n in (8, 4096):
        cases["rmsnorm"].append(check_rmsnorm(dev, n, 3072))
    for sq in (512, 2048):
        for kv_len in (sq, sq - sq // 8):
            cases["flash_attention"].append(check_flash(dev, sq, kv_len))
    pc = cases["paged_chunk_attention"]
    for kv_dtype in ("bfloat16", "float8_e4m3", "int8"):
        for T in (1, 16):
            pc.append(check_paged(dev, kv_dtype=kv_dtype, T=T, bs=16))
    for T, b in ((1, 8), (16, 8), (256, 1)):
        pc.append(check_paged(dev, kv_dtype="bfloat16", T=T, bs=0, b=b,
                              dense_view=True))
    return cases


# ------------------------------- end to end ---------------------------------


def request_set(vocab, seed=SEED):
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [64, 1024, 200, 512, 96, 777, 333, 640]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    arrivals = [0, 0, 1, 3, 5, 8, 12, 16]
    return prompts, arrivals


def e2e_run(model, params, prompts, arrivals, dev, prefill_chunk, gen=32):
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_paged
    n_blocks = 2 * sum(-(-(len(p) + gen) // 16) for p in prompts) + 1
    torch.cuda.synchronize()
    reset_launch_counts()
    res = serve_paged(model, params, prompts, gen, arrivals=arrivals,
                      device=dev, n_blocks=n_blocks, block_size=16,
                      max_slots=8, prefill_chunk=prefill_chunk)
    torch.cuda.synchronize()
    counts = launch_counts()
    eng = res["engine"]
    steps = eng.step_count
    m = eng.request_metrics()
    n_tok = sum(len(t) for t in res["tokens"])
    out = {"prefill_chunk": prefill_chunk, "requests": len(prompts),
           "new_tokens_each": gen, "launches": counts,
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "seconds": res["seconds"], "tokens_per_s": n_tok / res["seconds"],
           "ttft_p50_s": m["ttft"]["p50_s"], "ttft_p95_s": m["ttft"]["p95_s"],
           "tpot_p50_s": m["tpot"]["p50_s"], "tpot_p95_s": m["tpot"]["p95_s"],
           "engine_steps": steps,
           "evictions": eng.evictions}
    if any(len(t) != gen for t in res["tokens"]):
        raise AssertionError(f"wrong token counts: "
                             f"{[len(t) for t in res['tokens']]}")
    dead = [k for k, v in counts.items() if v <= 0]
    if dead:
        raise AssertionError(f"kernels never launched on the serving path "
                             f"(prefill_chunk={prefill_chunk}): {dead}")
    return out, res["tokens"]


def teacher_forced(model, params, prompts, forced, dev, n_ticks=4, bs=16,
                   prefill_chunk=0):
    """First-token logits (fresh or chunked prefill) and ``n_ticks``
    decode ticks fed ``forced`` tokens through a fragmented paged pool;
    returns fp32 logits (1 + n_ticks, b, V)."""
    import numpy as np
    import torch
    from repro_torch.serving.paged_cache import PagedKVCache
    cfg = model.cfg
    b = len(prompts)
    lens = [len(p) for p in prompts]
    need = [-(-(n + n_ticks) // bs) for n in lens]
    cache = PagedKVCache(layers=cfg.n_layers, n_blocks=sum(need) + 1,
                         block_size=bs, kv_heads=cfg.n_kv_heads,
                         head_dim=cfg.head_dim, device=dev)
    perm = (np.random.default_rng(5).permutation(sum(need)) + 1).tolist()
    blocks = [[perm.pop() for _ in range(n)] for n in need]
    first = []
    for p, blk in zip(prompts, blocks):
        s = len(p)
        cap = 1 << max(4, (s - 1).bit_length())
        C = min(prefill_chunk or cap, cap)
        cap = -(-cap // C) * C
        state = model.init_seq_state(params, cap, batch_size=1,
                                     dtype=cfg.compute_dtype, device=dev)
        toks = torch.zeros(1, cap, dtype=torch.int32, device=dev)
        toks[0, :s] = torch.as_tensor(p, device=dev)
        pos = torch.arange(cap, dtype=torch.int32, device=dev)[None]
        pos = torch.where(pos < s, pos, torch.full_like(pos, -1))
        for lo in range(0, cap, C):
            state, logits = model.forward(params, state, toks[:, lo:lo + C],
                                          pos[:, lo:lo + C], fresh=lo == 0)
            if lo + C >= s:
                break
        first.append(logits[0].float())
        cache.write_prompt(state["k"][:, 0, :s], state["v"][:, 0, :s],
                           blk[:-(-s // bs)])
        del state
    out = [torch.stack(first)]
    width = 1 << (max(need) - 1).bit_length()
    tables = np.zeros((b, width), np.int32)
    for i, blk in enumerate(blocks):
        tables[i, :len(blk)] = blk
    bt = torch.as_tensor(tables, device=dev)
    for t in range(n_ticks):
        tok = torch.as_tensor([[int(f[t])] for f in forced],
                              dtype=torch.int32, device=dev)
        ln = torch.as_tensor([n + t for n in lens], dtype=torch.int32,
                             device=dev)
        state = {"k": cache.k, "v": cache.v, "block_tables": bt,
                 "lengths": ln}
        _, logits = model.forward(params, state, tok, ln[:, None])
        out.append(logits.float())
    return torch.stack(out)


def profiled(run, top=12):
    """``run()`` once more under torch.profiler: the device's busy share
    of the traced wall time and the device operations by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry import now
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        run()
        torch.cuda.synchronize()
        wall_ms = (now() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies, memsets): one stream, so
    # their sum is the time the card was busy
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top": [{"op": e.key[:80], "calls": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in rows[:top]]}


def e2e_phase(dev):
    import torch
    from repro_torch.launch.serve import build
    from repro_torch.models import build_model
    cfg, model, params = build(ARCH, device=dev, seed=SEED)
    n_params = sum(v.numel() for v in params["layers"].values()) + \
        params["embed"].numel() + params["final_norm_scale"].numel()
    prompts, arrivals = request_set(cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator): two short requests, not kept
    e2e_run(model, params, [prompts[0][:64], prompts[4][:80]], [0, 0], dev,
            0, gen=4)
    runs, tokens = [], None
    for chunk in (0, 256):
        out, toks = e2e_run(model, params, prompts, arrivals, dev, chunk)
        runs.append(out)
        tokens = tokens or toks
        print(json.dumps({"e2e": out}), flush=True)
    # kernel path vs plain path on the same prompts and forced tokens
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                             norm_impl="ref"))
    cmp = []
    for chunk in (0, 256):
        got = teacher_forced(model, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        ref = teacher_forced(plain, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        for i, name in enumerate(["first_token"] +
                                 [f"tick_{t}" for t in range(1, 5)]):
            d = float((got[i] - ref[i]).abs().max())
            scale = float(ref[i].abs().max())
            agree = float((got[i].argmax(-1) == ref[i].argmax(-1))
                          .float().mean())
            cmp.append({"prefill_chunk": chunk, "logits": name,
                        "max_abs_diff": d, "max_abs_plain": scale,
                        "rel": d / scale,
                        "tol_used": d / (E2E_REL_TOL * scale),
                        "argmax_agree": agree,
                        "finite": bool(torch.isfinite(got[i]).all()),
                        "ok": d <= E2E_REL_TOL * scale
                        and bool(torch.isfinite(got[i]).all())})
        del got, ref
    for c in cmp:
        print(json.dumps({"e2e_vs_plain": c}), flush=True)
    # where the whole-prompt cell's time goes (profiler on, so its wall
    # time is not the measurement above)
    prof = profiled(lambda: e2e_run(model, params, prompts, arrivals, dev,
                                    0))
    print(json.dumps({"profile": prof}), flush=True)
    return {"arch": ARCH, "params": n_params,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "runs": runs, "vs_plain": cmp, "rel_tol": E2E_REL_TOL,
            "profile": prof}


# ---------------------------------- main ------------------------------------


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, rmsnorm
    from repro_torch.telemetry import now
    dev = torch.device("cuda:0")
    failures = []
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = now()
    per = build.build_all()
    x = torch.ones(2, 3072, device=dev, dtype=torch.bfloat16)
    rmsnorm.rmsnorm(x, x[0])                       # Triton compiles here
    torch.cuda.synchronize()
    t_build = now() - t0
    print(f"kernel build: {t_build:.1f} s (nvcc per source: "
          f"{json.dumps({k: round(v, 1) for k, v in per.items()})})",
          flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    cases = kernel_phase(dev)
    for name, rows in cases.items():
        for r in rows:
            print(json.dumps({"kernel": name, **r}), flush=True)
            if not r["ok"]:
                failures.append(f"{name} {r['case']}: max_abs_err "
                                f"{r['max_abs_err']}")
            failures += [f"{name} {r['case']}: planted fault "
                         f"'{c['fault']}' passed the tolerance"
                         for c in r["controls"] if not c["caught"]]

    e2e = e2e_phase(dev)
    for c in e2e["vs_plain"]:
        if not c["ok"]:
            failures.append(f"e2e kernel vs plain: {c}")

    # representative main-path case of each kernel: the decode tick for
    # rmsnorm (8 slots) and paged attention (T = 1, bs 16, bf16), a
    # 512-token fresh prefill for flash attention
    rep = {"rmsnorm": 0, "flash_attention": 0, "paged_chunk_attention": 0}
    summary = []
    for name, idx in rep.items():
        r = cases[name][idx]
        route, source, replaces = KERNEL_META[name]
        summary.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "case": r["case"],
            "launches": sum(run["launches"][name] for run in e2e["runs"]),
            "launches_per_run": {
                f"prefill_chunk={run['prefill_chunk']}":
                run["launches"][name] for run in e2e["runs"]},
            "launches_per_step": {
                f"prefill_chunk={run['prefill_chunk']}":
                run["launches_per_step"][name] for run in e2e["runs"]},
            "max_abs_err": r["max_abs_err"], "tol_used": r["tol_used"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"model": {k: e2e[k] for k in
                                ("arch", "params", "peak_mem_gb")}}),
          flush=True)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                        # report and fail the run
        traceback.print_exc()
        sys.exit(1)
