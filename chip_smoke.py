#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card: name and power limit (nvidia-smi); build every kernel from the
   sources in this checkout (one nvcc per CUDA source, all at once; the
   Triton rmsnorm kernels compile at their first call).
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the shapes phi4-mini-3.8b's serving and training
   paths give it, with its time, the plain version's time, one PyTorch
   library call that computes the same function (a yardstick the port
   never calls) and the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate, whichever is larger).
   Each case also holds the kernel's output against plain versions with
   a planted fault (the rmsnorm weight ignored, its projection term or
   last row block dropped; a key tile dropped, a row's own key masked,
   fp8 / int8 scales ignored, delta dropped, the GQA sum over one head);
   each of those must fail the tolerance.  The backward cases also hold
   the forward kernels' residuals (rstd, lse) against the plain
   forward's, and the chain forward kernel -> backward kernels against
   plain forward -> plain backward.  The forward cases time one eager
   call through the op as serving calls it, with no gradient to take
   (``host_ms``), and through the kernel's wrapper alone
   (``host_ms_wrapper``), in turn, the least of five readings each.
3. serving end to end: phi4-mini-3.8b at full width in bf16 (random
   weights drawn on the card from seed 0) serves 8 requests with prompts
   of 64..1024 tokens, staggered arrivals and 32 new tokens each through
   ``repro_torch.launch.serve.serve_paged``, once with whole-prompt
   prefill and once with prefill chunks of 256.  Every serving kernel's
   launch counter is zeroed before each run and must be > 0 after it.
   Then the kernel path and the plain path are held against each other
   on the same prompts: first-token logits and 4 teacher-forced decode
   ticks through a fragmented paged pool.
4. training end to end: phi4-mini-3.8b at full width (bf16 working
   params, fp32 masters and moments, per-layer remat) — the kernel
   path's loss and gradients on one batch of 2 x 2048 tokens against
   the plain path's, and the same with planted faults: four wiring
   faults that must fail the gates (delta dropped, the causal mask off
   by one, the kv heads rolled, rstd = 1 in the rmsnorm backward) and
   three that touch 1/32 of the rows, recorded to show the gates'
   resolution; then 8 AdamW
   steps through
   ``repro_torch.parallel.plan.make_train_step`` with every training
   kernel's launch counter zeroed before and > 0 after, step time,
   tokens/s, model FLOPs utilisation, peak memory, and one profiled
   step.

Every result is printed as one JSON object per line.  The last line is
{"ok": true, "device": {...}}; the line before it lists every kernel's
numbers as one JSON object, and the line before that the card.
"""
import dataclasses
import json
import math
import os
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
       "paged_chunk_attention": (8e-3, 1e-2),
       # backward, kernel vs plain function on the same inputs: dx and
       # dK / dV / dQ are rounded to bf16 once at the end (P and dS also
       # before their tensor-core products); dw is an fp32 sum over rows
       # in another order
       "rmsnorm_bwd_dx": (1e-2, 1e-2), "rmsnorm_bwd_dw": (1e-3, 1e-4),
       "flash_attention_bwd_dkv": (2e-2, 2e-2),
       "flash_attention_bwd_dq": (2e-2, 2e-2),
       # the forward kernels' residuals, which the backward kernels read
       # on the training path: both sides reduce in fp32 in another order
       "rmsnorm_rstd": (0.0, 1e-5),
       # the flash kernel sums P after rounding it to bf16 (its l is the
       # normaliser of the P that multiplies V), each term within 2^-9
       # relative, so its lse lies within log(1 + 2^-9) = 1.95e-3
       "flash_attention_lse": (2e-3, 0.0)}
# end to end, kernel path vs plain path at full width: max |difference|
# over max |plain logit| — bf16 rounding differs per op across 32 layers
E2E_REL_TOL = 1.5e-2
# training, kernel path vs plain path on one batch at full width: the
# loss's relative difference, and per gradient leaf |g - g_plain| /
# |g_plain| (Frobenius norms) — bf16 gradients through 32 layers.  Each
# gate lies between the sound kernel path's reading and the readings of
# the planted faults of ``train_faults``, which must exceed one of them
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GRAD_REL_TOL = 3e-2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 8
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd_dx", "rmsnorm_bwd_dw",
                 "flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
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
    "rmsnorm_bwd_dx": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                       "src/repro/kernels/rmsnorm/kernel.py:76"),
    "rmsnorm_bwd_dw": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                       "src/repro/kernels/rmsnorm/kernel.py:103"),
    "flash_attention_bwd_dkv": (
        "cuda", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:205"),
    "flash_attention_bwd_dq": (
        "cuda", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:289"),
}
SERVING_KERNELS = ("rmsnorm", "flash_attention", "paged_chunk_attention")


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


def time_ms(fn, iters=20, warmup=3, stream=None):
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed between two events, so the host's launch cost
    (Python, ctypes, Triton's launcher) is not counted.  ``stream``: the
    side stream to warm up and capture on (default: warm up on the
    current stream, capture on torch's own side stream)."""
    import torch
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, iters)
    del graph
    return ms


def backward_ms(forward, inputs, grad, iters=20):
    """Device time of one backward of ``forward()`` for ``inputs``.
    Autograd runs each backward op on the stream its forward op ran on,
    so the forward runs on the side stream the graph then captures on."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                               retain_graph=True),
                   iters, stream=side)


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


def host_ms_pair(a, b, reps=5):
    """``host_ms`` of two calls measured in turn ``reps`` times; the
    least reading of each, the one least disturbed by other work on the
    host."""
    ra, rb = [], []
    for _ in range(reps):
        ra.append(host_ms(a))
        rb.append(host_ms(b))
    return min(ra), min(rb)


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


def checked(name, got, ref, faulty=None):
    """``compare`` and ``controls`` as one record."""
    err, used, ok = compare(name, got, ref)
    return {"max_abs_err": err, "tol_used": used, "ok": ok,
            "controls": controls(name, got, faulty or {})}


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
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, d, device=dev, generator=g).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
    got, ref = rmsnorm(x, w), rmsnorm_ref(x, w)
    err, used, ok = compare("rmsnorm", got, ref)
    ctl = controls("rmsnorm", got, {
        "weight ignored": rmsnorm_ref(x, torch.ones_like(w))})
    lib = getattr(F, "rms_norm", None)
    b_ms, b_by = bound(2 * n * d * 2 + d * 2, 4 * n * d, "fp32")
    op_host, wrapper_host = host_ms_pair(lambda: rmsnorm(x, w),
                                         lambda: rmsnorm_fwd(x, w))
    return {"case": f"n={n},d={d},bf16", "max_abs_err": err,
            "tol_used": used, "ok": ok, "controls": ctl,
            "ms": time_ms(lambda: rmsnorm(x, w)),
            "host_ms": op_host, "host_ms_wrapper": wrapper_host,
            "plain_ms": time_ms(lambda: rmsnorm_ref(x, w)),
            "library_ms": (time_ms(lambda: lib(x, (d,), w, 1e-6))
                           if lib else None),
            "bound_ms": b_ms, "bound_by": b_by}


def check_flash(dev, sq, kv_len, h=24, kvh=8, d=128):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
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
    op_host, wrapper_host = host_ms_pair(
        lambda: flash_attention(qt, kt, vt, kv_len=kv_len),
        lambda: flash_attention_fwd(qt, kt, vt, kv_len=kv_len))
    return {"case": f"sq=skv={sq},kv_len={kv_len},h={h},kvh={kvh},d={d}",
            "max_abs_err": err, "tol_used": used, "ok": ok,
            "controls": ctl,
            "ms": time_ms(lambda: flash_attention(qt, kt, vt,
                                                  kv_len=kv_len)),
            "host_ms": op_host, "host_ms_wrapper": wrapper_host,
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


def check_rmsnorm_bwd(dev, n, d):
    """dx and dw kernels against their plain functions on the same x, w,
    dy and rstd.  Faults: dx without its projection term, dw without
    its last block of rows.  Then the training path's hand-off: the
    forward kernel's y and rstd against the plain forward's (fault: the
    mean over all columns but the last), and the chain forward kernel
    -> dx / dw kernels from its own rstd against plain forward -> plain
    backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref,
                                             rmsnorm_fwd_ref)
    from repro_torch.kernels.rmsnorm.kernel import (DW_ROWS, rmsnorm_bwd_dw,
                                                    rmsnorm_bwd_dx,
                                                    rmsnorm_fwd)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, d, device=dev, generator=g).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
    dy = torch.randn(n, d, device=dev, generator=g).bfloat16()
    y, rstd = rmsnorm_fwd_ref(x, w)
    dx, dw = rmsnorm_bwd_dx(x, w, dy, rstd), rmsnorm_bwd_dw(x, dy, rstd)
    dx_ref = rmsnorm_bwd_dx_ref(x, w, dy, rstd)
    dw_ref = rmsnorm_bwd_dw_ref(x, dy, rstd)
    yk, rstd_k = rmsnorm_fwd(x, w, save_rstd=True)
    residual = {"rstd": checked("rmsnorm_rstd", rstd_k, rstd, {
        "last column dropped": torch.rsqrt(
            x[:, :-1].float().square().mean(-1) + 1e-6)}),
        "y": checked("rmsnorm", yk, y)}
    chained = {"rmsnorm_bwd_dx": checked("rmsnorm_bwd_dx",
                                         rmsnorm_bwd_dx(x, w, dy, rstd_k),
                                         dx_ref),
               "rmsnorm_bwd_dw": checked("rmsnorm_bwd_dw",
                                         rmsnorm_bwd_dw(x, dy, rstd_k),
                                         dw_ref)}
    keep = max(n - DW_ROWS, 0)
    ctl = {"rmsnorm_bwd_dx": controls("rmsnorm_bwd_dx", dx, {
        "projection term dropped": dy.float() * w.float() * rstd[:, None]}),
        "rmsnorm_bwd_dw": controls("rmsnorm_bwd_dw", dw, {
            "last row block dropped": rmsnorm_bwd_dw_ref(
                x[:keep], dy[:keep], rstd[:keep])})}
    # library yardstick: autograd of F.rms_norm, dx and dw in one call
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    lib_ms = backward_ms(lambda: F.rms_norm(xl, (d,), wl, 1e-6), (xl, wl),
                         dy)
    plain_ms = time_ms(lambda: (rmsnorm_bwd_dx_ref(x, w, dy, rstd),
                                rmsnorm_bwd_dw_ref(x, dy, rstd)))
    rows = {}
    for name, got, ref, fn, nbytes, ops in (
            ("rmsnorm_bwd_dx", dx, dx_ref,
             lambda: rmsnorm_bwd_dx(x, w, dy, rstd),
             3 * n * d * 2 + d * 2 + n * 4, 8 * n * d),
            ("rmsnorm_bwd_dw", dw, dw_ref,
             lambda: rmsnorm_bwd_dw(x, dy, rstd),
             2 * n * d * 2 + n * 4 + d * 4, 3 * n * d)):
        err, used, ok = compare(name, got, ref)
        b_ms, b_by = bound(nbytes, ops, "fp32")
        rows[name] = {"case": f"n={n},d={d},bf16", "max_abs_err": err,
                      "tol_used": used, "ok": ok, "controls": ctl[name],
                      "residual": residual, "chained": chained[name],
                      "ms": time_ms(fn), "host_ms": host_ms(fn),
                      "plain_ms": plain_ms,
                      "plain_covers": "dx and dw together",
                      "library_ms": lib_ms,
                      "library_covers": "dx and dw together",
                      "bound_ms": b_ms, "bound_by": b_by}
    return rows


def causal_pairs(sq, skv, q_offset, kv_len, causal=True):
    """(query, key) pairs a causal / kv_len mask keeps, per head."""
    import numpy as np
    qpos = q_offset + np.arange(sq)
    lim = np.minimum(qpos + 1, kv_len) if causal else \
        np.full(sq, min(kv_len, skv))
    return int(np.clip(lim, 0, skv).sum())


def check_flash_bwd(dev, *, b, sq, skv, h=24, kvh=8, d=128, q_offset=None,
                    kv_len=None):
    """dK/dV and dQ kernels against the plain backward on the same q, k,
    v, dO, lse and delta (lse and delta from the plain forward), in the
    model's (b, s, h, d) memory layout.  Faults: delta dropped, the last
    key tile dropped, and (dK/dV) the GQA sum over one head only.  Then
    the training path's hand-off: the forward kernel's o and lse against
    the plain forward's (fault: the last key tile dropped), and the
    chain forward kernel -> dK/dV and dQ kernels from its own o and lse
    against plain forward -> plain backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_fwd_ref)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    q_offset = skv - sq if q_offset is None else q_offset
    kv_len = skv if kv_len is None else kv_len
    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16

    def t(s, heads):
        return torch.randn(b, s, heads, d, device=dev,
                           generator=g).to(bf).transpose(1, 2)
    q, k, v, do = t(sq, h), t(skv, kvh), t(skv, kvh), t(sq, h)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1).contiguous()
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    rq, rk, rv = attention_bwd_ref(q, k, v, do, lse, delta, **kw)
    last = (min(kv_len, skv) - 1) // KEY_TILE * KEY_TILE
    o_k, lse_k = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    residual = {"lse": checked("flash_attention_lse", lse_k, lse, {
        "last key tile dropped": attention_fwd_ref(
            q, k, v, causal=True, q_offset=q_offset, kv_len=last)[1]}),
        "o": checked("flash_attention", o_k, o)}
    delta_k = (o_k.float() * do.float()).sum(-1).contiguous()
    chain = (flash_attention_bwd_dkv(q, k, v, do, lse_k, delta_k, **kw)
             + (flash_attention_bwd_dq(q, k, v, do, lse_k, delta_k, **kw),))
    del o_k, delta_k
    # planted faults
    f_delta = attention_bwd_ref(q, k, v, do, lse, torch.zeros_like(delta),
                                **kw)
    f_tile = attention_bwd_ref(q, k, v, do, lse, delta, causal=True,
                               q_offset=q_offset, kv_len=last)
    one = torch.zeros(h, device=dev, dtype=bf)
    one[::h // kvh] = 1
    f_gqa = attention_bwd_ref(q, k, v, do * one[None, :, None, None], lse,
                              delta * one[None, :, None].float(), **kw)

    def both(name, pair, refs):
        (e1, u1, ok1), (e2, u2, ok2) = (compare(name, a, r)
                                        for a, r in zip(pair, refs))
        return max(e1, e2), max(u1, u2), ok1 and ok2

    def ctl(name, pair, faults):
        out = []
        for fault, refs in faults.items():
            err, used, ok = both(name, pair, refs)
            out.append({"fault": fault, "max_abs_err": err,
                        "tol_used": used, "caught": not ok})
        return out

    # library yardstick: SDPA's backward for q, k, v (one call for all
    # three), on the same tensors with the same mask
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
    if sq == skv and kv_len == skv and q_offset == 0:
        def lib_fwd():
            return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                  enable_gqa=True)
    else:
        qpos = q_offset + torch.arange(sq, device=dev)
        kpos = torch.arange(skv, device=dev)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < kv_len)

        def lib_fwd():
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                  enable_gqa=True)
    lib_ms = backward_ms(lib_fwd, (ql, kl, vl), do)
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, do, lse, delta,
                                                 **kw), 3)
    pairs = b * h * causal_pairs(sq, skv, q_offset, kv_len)
    qb, kb = b * h * sq * d * 2, b * kvh * min(skv, kv_len) * d * 2
    rows_b = b * h * sq * 4 * 2                      # lse and delta
    case = (f"b={b},sq={sq},skv={skv},q_offset={q_offset},kv_len={kv_len},"
            f"h={h},kvh={kvh},d={d}")
    out = {}
    for name, pair, refs, faults, fn, nbytes, ops in (
            ("flash_attention_bwd_dkv", (dk, dv), (rk, rv),
             {"delta dropped": f_delta[1:], "last key tile dropped":
              f_tile[1:], "GQA sum over one head": f_gqa[1:]},
             lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw),
             2 * qb + 2 * kb + rows_b + 2 * b * kvh * skv * d * 2,
             8 * d * pairs),
            ("flash_attention_bwd_dq", (dq,), (rq,),
             {"delta dropped": f_delta[:1],
              "last key tile dropped": f_tile[:1]},
             lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
             3 * qb + 2 * kb + rows_b, 6 * d * pairs)):
        if len(pair) == 1:
            err, used, ok = compare(name, pair[0], refs[0])
            faults_out = [{"fault": f, "max_abs_err": e, "tol_used": u,
                           "caught": not c} for f, (e, u, c) in
                          ((f, compare(name, pair[0], r[0]))
                           for f, r in faults.items())]
        else:
            err, used, ok = both(name, pair, refs)
            faults_out = ctl(name, pair, faults)
        b_ms, b_by = bound(nbytes, ops, "bf16_tensor")
        chained = [checked(name, a, r) for a, r in zip(
            chain[:2] if len(pair) == 2 else chain[2:], refs)]
        out[name] = {"case": case, "max_abs_err": err, "tol_used": used,
                     "ok": ok, "controls": faults_out,
                     "residual": residual, "chained": {
                         "max_abs_err": max(c["max_abs_err"]
                                            for c in chained),
                         "tol_used": max(c["tol_used"] for c in chained),
                         "ok": all(c["ok"] for c in chained)},
                     "ms": time_ms(fn),
                     "host_ms": host_ms(fn), "plain_ms": plain_ms,
                     "plain_covers": "dq, dk and dv together",
                     "library_ms": lib_ms,
                     "library_covers": "dq, dk and dv together",
                     "bound_ms": b_ms, "bound_by": b_by}
    return out


def backward_kernel_phase(dev):
    """The four backward kernels, each against its plain function: the
    training step's shapes first (rmsnorm 4096 x 3072, flash b 2 x 2048
    causal), then a decode-sized rmsnorm and ragged flash cases."""
    cases = {n: [] for n in ("rmsnorm_bwd_dx", "rmsnorm_bwd_dw",
                             "flash_attention_bwd_dkv",
                             "flash_attention_bwd_dq")}
    for n in (4096, 8):
        for name, row in check_rmsnorm_bwd(dev, n, 3072).items():
            cases[name].append(row)
    for kw in (dict(b=2, sq=2048, skv=2048),
               dict(b=1, sq=1000, skv=1000),
               dict(b=1, sq=448, skv=512, q_offset=64, kv_len=480),
               dict(b=1, sq=512, skv=512, d=64)):
        for name, row in check_flash_bwd(dev, **kw).items():
            cases[name].append(row)
    return cases


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
    dead = [k for k in SERVING_KERNELS if counts[k] <= 0]
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


# -------------------------------- training ----------------------------------


def train_faults():
    """Planted faults of the training path at full width, each through
    the kernel path's autograd Functions: {fault: (gating, [(module,
    name, replacement), ...])}, the ops modules' kernel wrappers swapped
    for one loss-and-gradients run.  Gating faults touch every row (a
    wiring fault: a mask off by one, a wrong GQA head, a dropped or
    wrong residual) and must fail the gates.  The others touch one key
    tile of 32 or one block of 64 rows of 4096, and are recorded to show
    what the whole-model gates resolve; the kernel cases hold those."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.kernel import DW_ROWS
    fwd, dkv, dq = (fops.flash_attention_fwd, fops.flash_attention_bwd_dkv,
                    fops.flash_attention_bwd_dq)
    dx, dw = rops.rmsnorm_bwd_dx, rops.rmsnorm_bwd_dw

    def short(k, kw):                       # one key tile fewer
        kv = k.shape[2] if kw.get("kv_len") is None else kw["kv_len"]
        return {**kw, "kv_len": kv - KEY_TILE}

    def own_masked(q, k, kw):               # every row's own key masked
        off = k.shape[2] - q.shape[2] if kw.get("q_offset") is None \
            else kw["q_offset"]
        return {**kw, "q_offset": off - 1}

    def rolled(k, v):                       # query head h reads kv head
        return k.roll(1, dims=1), v.roll(1, dims=1)   # h // group - 1

    def dkv_rolled(q, k, v, do, lse, delta, **kw):
        dk_, dv_ = dkv(q, *rolled(k, v), do, lse, delta, **kw)
        return dk_.roll(-1, dims=1), dv_.roll(-1, dims=1)
    return {
        "delta dropped": (True, [
            (fops, "flash_attention_bwd_dkv",
             lambda q, k, v, do, lse, delta, **kw: dkv(
                 q, k, v, do, lse, torch.zeros_like(delta), **kw)),
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, k, v, do, lse, torch.zeros_like(delta), **kw))]),
        "causal mask off by one (own key masked) in all three flash "
        "kernels": (True, [
            (fops, "flash_attention_fwd",
             lambda q, k, v, **kw: fwd(q, k, v, **own_masked(q, k, kw))),
            (fops, "flash_attention_bwd_dkv",
             lambda q, k, v, do, lse, delta, **kw: dkv(
                 q, k, v, do, lse, delta, **own_masked(q, k, kw))),
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, k, v, do, lse, delta, **own_masked(q, k, kw)))]),
        "kv heads rolled by one in all three flash kernels": (True, [
            (fops, "flash_attention_fwd",
             lambda q, k, v, **kw: fwd(q, *rolled(k, v), **kw)),
            (fops, "flash_attention_bwd_dkv", dkv_rolled),
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, *rolled(k, v), do, lse, delta, **kw))]),
        "rmsnorm backward fed rstd = 1": (True, [
            (rops, "rmsnorm_bwd_dx",
             lambda x, w, dy, rstd: dx(x, w, dy, torch.ones_like(rstd))),
            (rops, "rmsnorm_bwd_dw",
             lambda x, dy, rstd: dw(x, dy, torch.ones_like(rstd)))]),
        "flash forward without the last key tile": (False, [
            (fops, "flash_attention_fwd",
             lambda q, k, v, **kw: fwd(q, k, v, **short(k, kw)))]),
        "dQ without the last key tile": (False, [
            (fops, "flash_attention_bwd_dq",
             lambda q, k, v, do, lse, delta, **kw: dq(
                 q, k, v, do, lse, delta, **short(k, kw)))]),
        "dw without its last row block": (False, [
            (rops, "rmsnorm_bwd_dw",
             lambda x, dy, rstd: dw(x[:-DW_ROWS], dy[:-DW_ROWS],
                                    rstd[:-DW_ROWS]))])}


def rel_by_leaf(got, ref, name=""):
    """{leaf: |got - ref| / |ref|} (Frobenius norms, fp32, in chunks of
    16 M elements) over two gradient trees."""
    import torch
    if isinstance(got, dict):
        out = {}
        for k in sorted(got):
            out.update(rel_by_leaf(got[k], ref[k], f"{name}{k}/"))
        return out
    diff = sum(float(torch.sum(torch.square(x.float() - y.float())))
               for x, y in zip(got.reshape(-1).split(1 << 24),
                               ref.reshape(-1).split(1 << 24)))
    norm = sum(float(torch.sum(torch.square(y.float())))
               for y in ref.reshape(-1).split(1 << 24))
    return {name[:-1]: (diff / max(norm, 1e-30)) ** 0.5}


def train_phase(dev):
    """phi4-mini-3.8b at full width trains on the card: random bf16
    weights drawn on the card from SEED, synthetic batches of
    TRAIN_BATCH x TRAIN_SEQ tokens.  First the kernel path and the plain
    path (attn_impl / norm_impl "ref") take the loss and every gradient
    of one batch, before any optimizer state exists, and so do the
    kernel path's planted faults (``train_faults``); then AdamW
    (warmup_cosine(3e-4, 2, 8), fp32 masters and moments) runs
    TRAIN_STEPS steps through ``parallel.plan.make_train_step`` with the
    launch counters zeroed before and read after, and one more step runs
    under the profiler."""
    import statistics

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.telemetry import now
    from repro_torch.train_lib import loss_and_grads
    cfg = get_arch(ARCH)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    B, S = TRAIN_BATCH, TRAIN_SEQ

    def batch(i):
        return {k: torch.as_tensor(v, device=dev) for k, v in
                batch_for_model(cfg, "train", i, B, S, seed=SEED).items()}

    # 1. kernel path against plain path on one batch, then the kernel
    # path with each planted fault against the same plain path
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref"))
    lp, _, gp = loss_and_grads(plain, params, batch(0))
    lp = float(lp)

    def against_plain(patches=()):
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        try:
            lk, _, gk = loss_and_grads(model, params, batch(0))
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        rel = rel_by_leaf(gk, gp)
        del gk
        worst = max(rel, key=rel.get)
        lk = float(lk)
        loss_rel = abs(lk - lp) / abs(lp)
        return {"loss_kernel": lk, "loss_plain": lp, "loss_rel": loss_rel,
                "loss_rel_tol": TRAIN_LOSS_REL_TOL, "grad_rel": rel,
                "grad_rel_max": rel[worst], "grad_rel_max_leaf": worst,
                "grad_rel_tol": TRAIN_GRAD_REL_TOL,
                "within": (loss_rel <= TRAIN_LOSS_REL_TOL
                           and rel[worst] <= TRAIN_GRAD_REL_TOL
                           and math.isfinite(lk))}
    vs_plain = against_plain()
    vs_plain["ok"] = vs_plain.pop("within") and math.isfinite(lp)
    print(json.dumps({"train_vs_plain": vs_plain}), flush=True)
    faults = []
    for fault, (gating, patches) in train_faults().items():
        r = against_plain(patches)
        r = {"fault": fault, "gating": gating,
             "caught": not r.pop("within"),
             **{k: r[k] for k in ("loss_rel", "grad_rel_max",
                                  "grad_rel_max_leaf")}}
        faults.append(r)
        print(json.dumps({"train_fault": r}), flush=True)
    vs_plain["controls"] = faults
    del gp

    # 2. training
    opt = AdamW(lr=warmup_cosine(3e-4, 2, TRAIN_STEPS))
    plan = ParallelPlan(mode="gspmd")
    state = init_state(plan, opt, params)
    del params
    step = make_train_step(plan, model, opt, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = now()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))      # synchronises
        times.append(now() - t0)
        print(json.dumps({"train_step": i, "loss": losses[-1],
                          "seconds": times[-1]}), flush=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = B * S
    med = statistics.median(times)
    pairs = B * causal_pairs(S, S, 0, S)
    flops = 6 * n_params * tokens + \
        12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * pairs
    prof = profiled(lambda: float(step(state, batch(TRAIN_STEPS))[1]["loss"]))
    out = {"arch": ARCH, "params": n_params, "batch": B, "seq": S,
           "steps": TRAIN_STEPS, "losses": losses, "step_s": times,
           "median_step_s": med, "tokens_per_s": tokens / med,
           "model_flops_per_step": flops,
           "mfu_vs_bf16_dense_peak": flops / med / PEAK["bf16_tensor"],
           "peak_mem_gb": peak / 1e9, "launches": counts,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in counts.items()},
           "vs_plain": vs_plain, "profile": prof}
    del state
    torch.cuda.empty_cache()
    failures = []
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"training losses not finite: {losses}")
    if not vs_plain["ok"]:
        failures.append(f"training kernel vs plain: loss_rel "
                        f"{vs_plain['loss_rel']}, worst grad_rel "
                        f"{vs_plain['grad_rel_max']} "
                        f"({vs_plain['grad_rel_max_leaf']})")
    failures += [f"training: planted fault '{f['fault']}' passed the "
                 f"gates" for f in faults if f["gating"] and not f["caught"]]
    dead = [k for k in TRAIN_KERNELS if counts[k] <= 0]
    if dead:
        failures.append(f"kernels never launched on the training path: "
                        f"{dead}")
    return out, failures


# ---------------------------------- main ------------------------------------


def main():
    # the training phase holds ~70 GB in tensors of very different sizes:
    # expandable segments keep the caching allocator from fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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

    cases = {**kernel_phase(dev), **backward_kernel_phase(dev)}
    for name, rows in cases.items():
        for r in rows:
            print(json.dumps({"kernel": name, **r}), flush=True)
            # the case itself, the forward kernel's residuals and the
            # chain forward kernel -> backward kernels
            parts = [("", r)] + [(f" residual {k}", v) for k, v in
                                 r.get("residual", {}).items()]
            if "chained" in r:
                parts.append((" chained", r["chained"]))
            for label, c in parts:
                if not c["ok"]:
                    failures.append(f"{name} {r['case']}{label}: "
                                    f"max_abs_err {c['max_abs_err']}")
                failures += [f"{name} {r['case']}{label}: planted fault "
                             f"'{f['fault']}' passed the tolerance"
                             for f in c.get("controls", [])
                             if not f["caught"]]

    e2e = e2e_phase(dev)
    for c in e2e["vs_plain"]:
        if not c["ok"]:
            failures.append(f"e2e kernel vs plain: {c}")
    torch.cuda.empty_cache()
    train, train_failures = train_phase(dev)
    print(json.dumps({"train": train}), flush=True)
    failures += train_failures

    # representative main-path case of each kernel: the decode tick for
    # rmsnorm (8 slots) and paged attention (T = 1, bs 16, bf16), a
    # 512-token fresh prefill for flash attention, the training step
    # (4096 x 3072 rows, b 2 x 2048 causal) for the backward kernels.
    # launches: per run of each path that ran the kernel, counters
    # zeroed before the run and read after
    summary = []
    for name in KERNEL_META:
        r = cases[name][0]
        route, source, replaces = KERNEL_META[name]
        runs = {f"serve prefill_chunk={run['prefill_chunk']}":
                run["launches"][name] for run in e2e["runs"]
                if name in SERVING_KERNELS}
        per_step = {f"serve prefill_chunk={run['prefill_chunk']} "
                    f"(per engine step)": run["launches_per_step"][name]
                    for run in e2e["runs"] if name in SERVING_KERNELS}
        if name in TRAIN_KERNELS:
            runs[f"train {TRAIN_STEPS} steps"] = train["launches"][name]
            per_step["train (per step)"] = train["launches_per_step"][name]
        summary.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "case": r["case"],
            "launches": sum(runs.values()), "launches_per_run": runs,
            "launches_per_step": per_step,
            "max_abs_err": r["max_abs_err"], "tol_used": r["tol_used"],
            "ms": r["ms"], "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("plain_covers", "library_covers")
               if k in r}})
    print(json.dumps({"model": {k: e2e[k] for k in
                                ("arch", "params", "peak_mem_gb")}}),
          flush=True)
    print(json.dumps({"train_summary": {
        k: train[k] for k in ("median_step_s", "tokens_per_s",
                              "mfu_vs_bf16_dense_peak", "peak_mem_gb",
                              "losses", "launches_per_step")}}),
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
