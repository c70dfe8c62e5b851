#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card: name and power limit (nvidia-smi); build every kernel from the
   sources in this checkout (one nvcc per CUDA source, all at once; the
   Triton rmsnorm kernels compile at their first call); print each
   kernel's ptxas registers and spills, and the count of HGMMA (wgmma)
   instructions in the flash backward library's SASS, which must not be
   0.
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the shapes phi4-mini-3.8b's serving and training
   paths give it, with its time, the plain version's time, one PyTorch
   library call that computes the same function (a yardstick the port
   never calls) and the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate, whichever is larger).
   Each case also holds the kernel's output against plain versions with
   a planted fault (the rmsnorm weight ignored, its projection term or
   last row block dropped; a key tile dropped, a row's own key masked,
   fp8 / int8 scales ignored, delta dropped, the GQA sum over one head,
   one stage of the dK/dV kernel's ring or one of the dQ kernel's key
   tiles skipped); each of those must fail the tolerance.  The backward
   cases also hold the forward kernels' residuals (rstd, lse) against the
   plain forward's, and the chain forward kernel -> backward kernels
   against plain forward -> plain backward; the flash backward kernels
   must repeat bitwise and give dK = dV = 0 past kv_len.  The forward
   cases time one eager call through the op as serving calls it, with
   no gradient to take (``host_ms``), and through the kernel's wrapper
   alone (``host_ms_wrapper``), in turn, the least of five readings
   each.
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
5. MoE serving: qwen2-moe-a2.7b at full width (24 layers, random bf16
   weights from seed 0) serves the same trace over its vocabulary, both
   runs, every serving kernel (the top-k gating forward included)
   launched; logits against the gating-only reference (gate_impl
   "ref") and the whole plain path; one MoE layer at full width against
   the plain route, with experts rolled by one as a planted fault.
6. MoE training: qwen2-moe-a2.7b at full widths with 4 of its 24 layers
   (capacity-limited dispatch): loss and gradients against the plain
   path, the gating-only reference and the plain gating backward (with
   planted gating-backward faults), then 8 AdamW steps as in 4.

7. hybrid serving: zamba2-1.2b at full width and depth (38 Mamba-2
   layers, the shared attention block 6 times, random bf16 weights from
   seed 0) serves the same trace, both runs, every serving kernel (the
   SSD chunk scan included, 38 launches per prompt) launched; logits
   against the SSD-only reference (ssm_impl "ref") and the whole plain
   path.
8. hybrid training: zamba2-1.2b at full width and depth: loss and
   gradients against the plain path and against the plain SSD backward
   in place of the kernel's (with planted SSD-backward faults), then 8
   AdamW steps as in 4, with the SSD kernels' launches per step checked.
9. HaiScale DDP training: gpt2-medium at full width and depth (24
   layers, d 1024) as 8 ranks sharing the card, 2 pods x 4 data, each
   rank 2 x 1024 tokens, gloo collectives staged through pinned host
   memory (``core.grid.Grid(stage="host")``, spawned by
   ``testing.multidev.run_ranks``).  Gates on step 1's synced gradient:
   (i) uncompressed against one process on the whole global batch, (ii)
   overlap on against off, bitwise, (iii) the int8 wire through the
   kernels against the plain quantizer, bitwise, (iv) int8 against
   uncompressed within the quantization bound, (v) planted faults (the
   prescale dropped, a strong rank's shard missing from phase 3, a
   bucket's hook one leaf early) that (i) or (ii) must catch; then 8
   steps with each of the uncompressed and int8 wires (overlap on, every
   kernel's launches counted from the ranks), one with overlap off, and
   the hfreduce of the whole gradient with each wire format.

The kernel cases of phase 2 include both top-k gating kernels at the
MoE shapes (qwen2-moe's decode, prefill and training rows, 64 experts
top-6, 128 top-8, no renorm, tie rows) with planted faults, both SSD
chunk-scan kernels at zamba2's shapes (the training step, prefills of
1024, 200 and 768 tokens, one fp32 case, a 777-token prompt through
the padding wrapper) with planted faults (the carried state dropped,
the diagonal of L masked, dh_final ignored, da's reverse cumsum shifted
by a row, dB summed over half the heads), the reused forward and
backward kernels at zamba2's shapes (head dim 64, rmsnorm over 4096 and
2048), and the int8 quantize / dequantize kernels at the DDP wire's
shapes (one bucket's weak shard, the whole per-rank payload, zero
blocks, values on code boundaries, a length the wrapper pads), held
bitwise against their plain versions, with planted faults (truncation,
the reciprocal multiply, the absmax over half the block with and
without the clip, a neighbour's scale).

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
       # top-k gating, kernel vs plain function on the same fp32 logits:
       # the same arithmetic (accurate expf, a divide by the row sum) with
       # sums in another order; experts must be identical
       "topk_gating": (1e-6, 0.0), "topk_gating_bwd": (1e-6, 1e-5),
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
# rows per tile: BK of the forward kernels (kernels/csrc/attn_tile.cuh),
# TILE of the flash backward's streamed tiles (flash_attention_bwd.cu)
KEY_TILE = 64

# the MoE family: qwen2-moe-a2.7b serves at full width (24 layers) and
# trains at full widths with its depth cut to MOE_TRAIN_LAYERS, so that
# weights, fp32 masters, moments and gradients (~47 GB) fit one card
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_TRAIN_LAYERS = 4
# gating only (gate_impl "auto" against "ref", every other kernel on):
# the two routes' weights differ in fp32 ulps (softmax sums in another
# order), which now and then rounds a bf16 combine weight the other way;
# the served logits are bf16, so the gate counts bf16 ulps of the
# largest logit (the first reading: 1 ulp, or bitwise equal), with
# identical greedy tokens.  Training: the loss within 1e-5 relative
MOE_GATE_LOGIT_ULPS = 2
MOE_GATE_LOSS_TOL = 1e-5
# the routed experts' and the router's gradient leaves, kernel path vs a
# reference whose bf16 rounding differs: a rounding difference upstream
# of a router flips near-tied expert choices and capacity ranks, and
# one token changed in an expert queue of ~336 capacity-limited slots
# moves that expert's gradient by ~sqrt(2 / 336) = 7.7 %.  The gate lies
# between the first readings (5.0-6.5e-2) and the planted gating
# backward faults (>= 0.32)
MOE_ROUTED_GRAD_TOL = 0.2
MOE_ROUTED_LEAVES = ("layers/moe_router", "layers/moe_e_gate",
                     "layers/moe_e_up", "layers/moe_e_down")
# the gating backward kernel in place, forward bitwise the same (kernel
# forward in both, backward kernel vs plain backward): the router's
# gradient within 1e-3 relative norm
MOE_GATE_ROUTER_TOL = 1e-3
# one MoE layer's routed experts at full width in bf16, gating kernel
# route vs plain route on the same inputs: max |difference| over max |y|
# (a weight rounded to the other bf16 neighbour moves its token's y by
# <= 2^-8 relative); experts rolled by one must fail it
MOE_LAYER_TOL = 1e-2
# the MoE kernel path against the whole plain path end to end
MOE_E2E_REL_TOL = E2E_REL_TOL

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
    "topk_gating": ("cuda",
                    "src/repro_torch/kernels/topk_gating/csrc/topk_gating.cu",
                    "src/repro/kernels/topk_gating/kernel.py:50"),
    "topk_gating_bwd": (
        "cuda", "src/repro_torch/kernels/topk_gating/csrc/topk_gating.cu",
        "src/repro/kernels/topk_gating/kernel.py:94"),
    "ssd_scan": ("cuda", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:76"),
    "ssd_scan_bwd": (
        "cuda", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:195"),
    "quantize": ("cuda",
                 "src/repro_torch/kernels/quant_comm/csrc/quant_comm.cu",
                 "src/repro/kernels/quant_comm/kernel.py:34"),
    "dequantize": ("cuda",
                   "src/repro_torch/kernels/quant_comm/csrc/quant_comm.cu",
                   "src/repro/kernels/quant_comm/kernel.py:55"),
}
DENSE_SERVING_KERNELS = ("rmsnorm", "flash_attention",
                         "paged_chunk_attention")
SERVING_KERNELS = DENSE_SERVING_KERNELS + ("topk_gating",)
MOE_TRAIN_KERNELS = TRAIN_KERNELS + ("topk_gating", "topk_gating_bwd")

# the hybrid family: zamba2-1.2b (38 Mamba-2 layers, one shared attention
# block every 6) serves and trains at full width and full depth
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_SERVING_KERNELS = DENSE_SERVING_KERNELS + ("ssd_scan",)
HYBRID_TRAIN_KERNELS = TRAIN_KERNELS + ("ssd_scan", "ssd_scan_bwd")
# SSD chunk scan, kernel vs plain function on the same inputs, max
# |difference| over max |plain|: outputs in bf16 are rounded once at the
# end by both sides (sums in another order can round an element to the
# other bf16 neighbour: up to 2^-7 of the largest value); fp32 outputs
# (h_final, h_prev, da) differ only in the order of fp32 sums
SSD_REL_TOL = {"bf16": 1e-2, "fp32": 1e-4}
# zamba2 serving, the SSD scan alone switched (ssm_impl "ref" against the
# kernel, every other kernel on): bf16 ulps of the largest logit, with
# identical greedy tokens.  The sound kernel reads bitwise equal under
# the init rule; 1 ulp (not 2) so that the SSD kernel with its carry
# dropped, 1.81-2.13 ulps there, fails it
HYBRID_SSD_LOGIT_ULPS = 1
# zamba2 serving, kernel path vs the whole plain path: max |difference|
# over max |plain logit|.  bf16 rounding through 38 + 6 sublayers: the
# first reading was 1.57-1.80e-2 (phi4's gate is 1.5e-2 at 32 layers)
# with the SSD-only logits bitwise equal, and both bf16 paths lay
# 4.1-5.5e-2 from the fp32 forward, the kernel path no farther than the
# plain one (recorded every run in ``hybrid_serve_phase``)
HYBRID_E2E_REL_TOL = 2.5e-2
# zamba2 serving on slow-decay weights: A_log = log(0.05) in every Mamba
# layer (as the CPU tests draw it; a ~ -0.05 dt per step, where the init
# rule's A_log = 1 gives a ~ -1.9), so that the state carried across a
# 256-token chunk matters.  There each SSD forward call of the serving
# path is held at the op (SSD_REL_TOL against the plain forward on the
# same inputs) and the logits at the two gates above; the kernel with
# its carry dropped must fail the op gate and the SSD-only one
SLOW_A_LOG = math.log(0.05)
# zamba2 training, the kernel forward with the plain SSD backward in
# place of the kernel's (the forward bitwise the same) is held at two
# levels: at the op, each of the 38 backward calls' kernel outputs
# against the plain backward's on the same saved inputs (SSD_REL_TOL);
# at the Mamba leaves, the gradients' relative norm against the kernel
# path's within TRAIN_GRAD_REL_TOL.  The leaves cannot hold the plain
# backward to 1e-3: the two backwards round dx, dB and dC to bf16 apart,
# and 38 layers of bf16 backward carry that to ~1.2e-2 (first reading).


def ptxas_lines(log):
    """(kernel, line) for each register and spill line of an nvcc
    ``-Xptxas -v`` log, the kernel named as c++filt demangles it."""
    import re
    fn, out = "", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            try:
                fn = subprocess.run(["c++filt", fn], capture_output=True,
                                    text=True, timeout=30).stdout.strip()
            except OSError:
                pass
            fn = fn.replace("(anonymous namespace)::", "")
        elif "registers" in line or "spill" in line:
            out.append((fn, line.strip()))
    return out


def spills(log):
    """The ptxas lines of an nvcc log that report spilled bytes."""
    import re
    return [(fn, line) for fn, line in ptxas_lines(log)
            if any(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))]


def sass_count(name, opcode):
    """How often ``opcode`` appears in the SASS of kernel library
    ``name`` (cuobjdump from the CUDA toolkit that built it)."""
    from repro_torch.kernels import build
    exe = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {sass.stderr.strip()}")
    return sass.stdout.count(opcode)


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


def bound(nbytes, ops, peak=None):
    """The least time (ms) for ``nbytes`` of memory traffic and ``ops``
    operations at the ``peak`` rate, or ``ops`` {peak: count} for work
    of several types (their times add)."""
    per = ops if isinstance(ops, dict) else {peak: ops}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK[k] for k, n in per.items()) * 1e3
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
                   f"{not dense_view},h={h},kvh={kvh},d={d}",
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


def stage_skipped(q, k, v, do, lse, delta, kw):
    """The plain dK, dV with one stage of the dK/dV kernel's ring lost:
    query head 0's middle 64-row tile contributes nothing (its dO and
    delta zeroed, so its P^T dO and dS^T Q terms vanish)."""
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    sq = q.shape[2]
    lo = (sq // KEY_TILE) // 2 * KEY_TILE
    do_f, delta_f = do.clone(), delta.clone()
    do_f[:, 0, lo:lo + KEY_TILE] = 0
    delta_f[:, 0, lo:lo + KEY_TILE] = 0
    return attention_bwd_ref(q, k, v, do_f, lse, delta_f, **kw)[1:]


def key_tile_skipped(q, k, v, do, lse, delta, rq, kw):
    """The plain dQ with one of the dQ kernel's key tiles lost: the middle
    64-key tile below kv_len contributes nothing (``rq`` minus its
    dS K term, with P and dS as the plain backward forms them)."""
    import torch
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    kv_end = min(skv if kw["kv_len"] is None else kw["kv_len"], skv)
    lo = (kv_end // KEY_TILE) // 2 * KEY_TILE
    hi = min(lo + KEY_TILE, kv_end)
    group, scale = h // kvh, d ** -0.5
    kt = k[:, :, lo:hi].float().repeat_interleave(group, dim=1)
    vt = v[:, :, lo:hi].float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kt) * scale
    qpos = kw["q_offset"] + torch.arange(sq, device=q.device)
    kpos = torch.arange(lo, hi, device=q.device)
    valid = kpos[None, :] <= qpos[:, None]
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vt)
    ds = p * (dp - delta[..., None]) * scale
    return (rq - torch.einsum("bhqk,bhkd->bhqd", ds, kt),)


def check_flash_bwd(dev, *, b, sq, skv, h=24, kvh=8, d=128, q_offset=None,
                    kv_len=None):
    """dK/dV and dQ kernels against the plain backward on the same q, k,
    v, dO, lse and delta (lse and delta from the plain forward), in the
    model's (b, s, h, d) memory layout.  Faults: delta dropped, the last
    key tile dropped, (dK/dV) the GQA sum over one head only and one ring
    stage skipped (one query head's middle 64-row tile: its dO and delta
    zeroed), and (dQ) one middle key tile skipped.  Two launches on the
    same inputs must agree bitwise, and keys at or past kv_len must get
    dK = dV = 0 exactly.  Then the training path's hand-off: the forward
    kernel's o and lse against the plain forward's (fault: the last key
    tile dropped), and the chain forward kernel -> dK/dV and dQ kernels
    from its own o and lse against plain forward -> plain backward."""
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
    again = (flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
             + (flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),))
    bitwise = all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again))
    del again
    kv_end = min(kv_len, skv)
    zero_past = bool((dk[:, :, kv_end:] == 0).all()
                     and (dv[:, :, kv_end:] == 0).all())
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
    dkv_faults = {"delta dropped": f_delta[1:],
                  "last key tile dropped": f_tile[1:],
                  "one ring stage skipped": stage_skipped(
                      q, k, v, do, lse, delta, kw)}
    if h > kvh:
        one = torch.zeros(h, device=dev, dtype=bf)
        one[::h // kvh] = 1
        dkv_faults["GQA sum over one head"] = attention_bwd_ref(
            q, k, v, do * one[None, :, None, None], lse,
            delta * one[None, :, None].float(), **kw)[1:]

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
            ("flash_attention_bwd_dkv", (dk, dv), (rk, rv), dkv_faults,
             lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw),
             2 * qb + 2 * kb + rows_b + 2 * b * kvh * skv * d * 2,
             8 * d * pairs),
            ("flash_attention_bwd_dq", (dq,), (rq,),
             {"delta dropped": f_delta[:1],
              "last key tile dropped": f_tile[:1],
              "one key tile skipped": key_tile_skipped(
                  q, k, v, do, lse, delta, rq, kw)},
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
                     "ok": ok and bitwise and zero_past,
                     "bitwise_repeat": bitwise,
                     "zero_past_kv_len": zero_past, "controls": faults_out,
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
    causal), then a decode-sized rmsnorm and ragged flash cases, then
    zamba2-1.2b's training shapes (rmsnorm over d_inner 4096 and d 2048,
    flash with 32 heads of 64, no grouping), then the flash kernels'
    edges: lengths that are not multiples of their 64 / 128-row tiles
    (129, 200, 1000), GQA groups of 1, 3 and 4, head dims 64 and 128,
    q_offset > 0 and kv_len < skv with whole key tiles past kv_len."""
    cases = {n: [] for n in ("rmsnorm_bwd_dx", "rmsnorm_bwd_dw",
                             "flash_attention_bwd_dkv",
                             "flash_attention_bwd_dq")}
    for n, d in ((4096, 3072), (8, 3072), (4096, 4096), (4096, 2048)):
        for name, row in check_rmsnorm_bwd(dev, n, d).items():
            cases[name].append(row)
    for kw in (dict(b=2, sq=2048, skv=2048),
               dict(b=1, sq=1000, skv=1000),
               dict(b=1, sq=448, skv=512, q_offset=64, kv_len=480),
               dict(b=1, sq=512, skv=512, d=64),
               dict(b=2, sq=2048, skv=2048, h=32, kvh=32, d=64),
               dict(b=2, sq=129, skv=129, h=12, kvh=4, d=64),
               dict(b=2, sq=200, skv=200, h=8, kvh=2, d=128),
               dict(b=2, sq=1000, skv=1000, h=16, kvh=4, d=64),
               dict(b=2, sq=200, skv=1000, h=8, kvh=8, d=128, q_offset=700,
                    kv_len=777)):
        for name, row in check_flash_bwd(dev, **kw).items():
            cases[name].append(row)
    return cases


def kernel_phase(dev):
    """The forward kernels at phi4-mini-3.8b's shapes, then at
    zamba2-1.2b's (the gated rmsnorm over d_inner 4096 and the pre-norms
    over d 2048; the shared block's attention, 32 heads of 64 without
    grouping: fresh prefill, decode tick, prefill chunk, and a 256-token
    continuation chunk against the dense-cache view)."""
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
    hd64 = dict(h=32, kvh=32, d=64)
    for d in (4096, 2048):
        cases["rmsnorm"].append(check_rmsnorm(dev, 4096, d))
    for sq in (512, 2048):
        cases["flash_attention"].append(check_flash(dev, sq, sq, **hd64))
    for T in (1, 16):
        pc.append(check_paged(dev, kv_dtype="bfloat16", T=T, bs=16, **hd64))
    pc.append(check_paged(dev, kv_dtype="bfloat16", T=256, bs=0, b=1,
                          dense_view=True, **hd64))
    return cases


# ------------------------------ top-k gating --------------------------------


def _gating_bwd_faulty(logits, experts, dw, renorm, fault):
    """The plain top-k gating backward with one planted fault: "renorm
    Jacobian dropped" (dwr = dw / S), "c term dropped" or "scattered to
    index + 1" (dp lands on the next expert)."""
    import torch
    p = torch.softmax(logits.float(), dim=-1)
    idx = experts.long()
    wr = torch.gather(p, -1, idx)
    S = torch.clamp(wr.sum(-1, keepdim=True), min=1e-9)
    if not renorm:
        dwr = dw
    elif fault == "renorm Jacobian dropped":
        dwr = dw / S
    else:
        dwr = (dw - (dw * wr / S).sum(-1, keepdim=True)) / S
    if fault == "scattered to index + 1":
        idx = (idx + 1) % p.shape[-1]
    dp = torch.zeros_like(p).scatter_add_(-1, idx, dwr)
    c = 0.0 if fault == "c term dropped" else \
        (dwr * wr).sum(-1, keepdim=True)
    return (p * (dp - c)).to(logits.dtype)


def _gating_library(x, k, renorm=True):
    """The nearest PyTorch composition: softmax -> topk -> divide."""
    import torch
    w, i = torch.topk(torch.softmax(x, dim=-1), k)
    return (w / w.sum(-1, keepdim=True) if renorm else w), i


def gating_verdict(w, e, ref_w, ref_e):
    """Experts identical and weights within TOL["topk_gating"]."""
    err, used, ok = compare("topk_gating", w, ref_w)
    mism = int((e != ref_e).any(dim=-1).sum())
    return {"max_abs_err": err, "tol_used": used,
            "experts_mismatch_rows": mism, "ok": ok and mism == 0}


def check_gating(dev, T, E, k, renorm=True, ties=0, seed=7):
    """Forward and backward kernel against their plain versions on fp32
    logits (T, E): experts identical, weights within 1e-6, dlogits within
    (1e-6, 1e-5) of the plain backward and of autograd through the plain
    forward.  ``ties`` > 0 makes that many rows all-equal (and the next
    all-zero): their experts must be 0..k-1.  Planted faults, where the
    input can show them: forward renorm skipped, ties broken to the
    higher index (tie case), the last expert column ignored; backward
    renorm Jacobian dropped, the c term dropped (renorm=False only: with
    renorm, c = sum(dwr * wr) = 0 in exact arithmetic) and dlogits
    scattered to index + 1."""
    import torch
    from repro_torch.kernels.topk_gating import (topk_gating,
                                                 topk_gating_bwd_ref,
                                                 topk_gating_fwd_ref,
                                                 topk_gating_ref)
    from repro_torch.kernels.topk_gating.kernel import topk_gating_bwd
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, E, device=dev, generator=g) * 2
    if ties:
        x[:ties] = 0.7
        x[ties] = 0.0
    dw = torch.randn(T, k, device=dev, generator=g)
    w, e = topk_gating(x, k=k, renorm=renorm)
    rw, re = topk_gating_fwd_ref(x, k, renorm)
    fwd = gating_verdict(w, e, rw, re)
    fwd["oracle"] = gating_verdict(w, e, *topk_gating_ref(x, k, renorm))
    if ties:
        want = torch.arange(k, device=dev, dtype=torch.int32)
        fwd["tie_rows_ok"] = bool((e[:ties + 1] == want).all())
        fwd["ok"] = fwd["ok"] and fwd["tie_rows_ok"]
    faults = {"last expert column ignored": topk_gating_fwd_ref(
        x[:, :-1].contiguous(), k, renorm)}
    if renorm:
        faults["renorm skipped"] = topk_gating_fwd_ref(x, k, False)
    if ties:
        # flipping the expert axis makes the first maximal index the
        # highest original one
        fw, fe = topk_gating_fwd_ref(x.flip(-1).contiguous(), k, renorm)
        faults["ties broken to the higher index"] = (fw, E - 1 - fe)
    fwd["controls"] = [{"fault": f, **gating_verdict(w, e, *r)}
                       for f, r in faults.items()]
    for c in fwd["controls"]:
        c["caught"] = not c.pop("ok")

    dl = topk_gating_bwd(x, e, dw, k, renorm)
    err, used, ok = compare("topk_gating_bwd", dl,
                            topk_gating_bwd_ref(x, e, dw, k, renorm))
    xr = x.clone().requires_grad_()
    auto = torch.autograd.grad(topk_gating_ref(xr, k, renorm)[0], xr, dw)[0]
    a_err, a_used, a_ok = compare("topk_gating_bwd", dl, auto)
    bfaults = ["scattered to index + 1"]
    bfaults += ["renorm Jacobian dropped"] if renorm else ["c term dropped"]
    bwd = {"max_abs_err": err, "tol_used": used, "ok": ok and a_ok,
           "vs_autograd": {"max_abs_err": a_err, "tol_used": a_used,
                           "ok": a_ok},
           "controls": controls("topk_gating_bwd", dl, {
               f: _gating_bwd_faulty(x, e, dw, renorm, f)
               for f in bfaults})}
    # bounds: the logits read, the outputs written, once each
    f_bytes = T * E * 4 + T * k * 8
    b_bytes = 2 * T * E * 4 + T * k * 8
    case = f"T={T},E={E},k={k},renorm={renorm}" + (f",ties={ties}"
                                                   if ties else "")
    xl = x.clone().requires_grad_()
    for rec, fn, plain, lib, (b_ms, b_by) in (
            (fwd, lambda: topk_gating(x, k=k, renorm=renorm),
             lambda: topk_gating_fwd_ref(x, k, renorm),
             lambda: _gating_library(x, k, renorm),
             bound(f_bytes, T * E * (4 + 2 * k), "fp32")),
            (bwd, lambda: topk_gating_bwd(x, e, dw, k, renorm),
             lambda: topk_gating_bwd_ref(x, e, dw, k, renorm), None,
             bound(b_bytes, T * E * (6 + k), "fp32"))):
        rec.update({"case": case, "ms": time_ms(fn), "host_ms": host_ms(fn),
                    "plain_ms": time_ms(plain),
                    "library_ms": (time_ms(lib) if lib else backward_ms(
                        lambda: _gating_library(xl, k, renorm)[0], (xl,),
                        dw)),
                    "library_covers": (
                        "torch.softmax -> torch.topk -> divide: no one "
                        "PyTorch call computes this function" if lib else
                        "autograd of torch.softmax -> torch.topk -> "
                        "divide"),
                    "bound_ms": b_ms, "bound_by": b_by})
    return {"topk_gating": fwd, "topk_gating_bwd": bwd}


# the first forward case is the decode tick, the first backward case the
# training step (the rows the kernel summary reports)
GATING_CASES = [dict(T=8, E=60, k=4), dict(T=4096, E=60, k=4),
                dict(T=1024, E=60, k=4), dict(T=4096, E=64, k=6),
                dict(T=4096, E=128, k=8),
                dict(T=4096, E=60, k=4, renorm=False),
                dict(T=1024, E=60, k=4, ties=3)]


def gating_phase(dev):
    """Both top-k gating kernels at the MoE path's shapes: qwen2-moe's
    training step (4096 x 60, top-4), decode tick (8 rows) and prefill
    bucket (1024), deepseekmoe-16b's (64 experts, top-6) and qwen3-moe's
    (128, top-8) gating, one case without renorm and one with tie rows."""
    cases = {"topk_gating": [], "topk_gating_bwd": []}
    for kw in GATING_CASES:
        for name, row in check_gating(dev, **kw).items():
            cases[name].append(row)
    cases["topk_gating_bwd"].insert(0, cases["topk_gating_bwd"].pop(1))
    return cases


# ------------------------------ SSD chunk scan -------------------------------


def ssd_inputs(dev, b, l, h, c, dtype, p=64, n=64, seed=8):
    """x, a, B, C, dy and dL/dh_final on the card.  a is drawn in
    [-2/c, 0], so the state carried across a chunk keeps at least e^-2
    of itself: a dropped carry or an ignored dh_final shows (under the
    model's init, a ~ -1.9 per step, no state survives a chunk)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, l, h, p, device=dev, generator=g).to(dtype)
    a = -torch.rand(b, l, h, device=dev, generator=g) * (2.0 / c)
    B = (torch.randn(b, l, n, device=dev, generator=g) / n ** 0.5).to(dtype)
    C = (torch.randn(b, l, n, device=dev, generator=g) / n ** 0.5).to(dtype)
    dy = torch.randn(b, l, h, p, device=dev, generator=g).to(dtype)
    dhf = torch.randn(b, h, p, n, device=dev, generator=g)
    return x, a, B, C, dy, dhf


def ssd_verdict(outs, refs, faulty):
    """Each output against its plain version: max |difference| over max
    |plain| within SSD_REL_TOL of the output's dtype.  ``faulty`` {fault:
    {output: plain version with the fault}}: each fault must fail the
    gate on one of its outputs (``caught``)."""
    import torch

    def rel(name, got, ref):
        tol = SSD_REL_TOL["fp32" if got.dtype == torch.float32 else "bf16"]
        g, r = got.float(), ref.float()
        err = float((g - r).abs().max())
        used = err / max(float(r.abs().max()), 1e-30) / tol
        return err, used, used <= 1 and bool(torch.isfinite(g).all())

    rows = {k: rel(k, v, refs[k]) for k, v in outs.items()}
    ctl = []
    for fault, frefs in faulty.items():
        res = [rel(k, outs[k], r) for k, r in frefs.items()]
        ctl.append({"fault": fault,
                    "max_abs_err": max(e for e, _, _ in res),
                    "tol_used": max(u for _, u, _ in res),
                    "caught": not all(ok for _, _, ok in res)})
    return {"max_abs_err": max(e for e, _, _ in rows.values()),
            "tol_used": max(u for _, u, _ in rows.values()),
            "ok": all(ok for _, _, ok in rows.values()),
            "outputs": {k: {"max_abs_err": e, "tol_used": u}
                        for k, (e, u, _) in rows.items()},
            "controls": ctl}


def ssd_fwd_faults(x, a, B, C, c, ry):
    """Plain forwards with a planted fault: the diagonal of L masked out
    (y without its s = l term, (C_l . B_l) x_l), and, over several chunks,
    the carried state dropped between chunks (each chunk from zero)."""
    from repro_torch.kernels.ssd_scan import ssd_fwd_ref
    diag = (C.float() * B.float()).sum(-1)[:, :, None, None] * x.float()
    out = {"diagonal of L masked out": {"y": (ry.float() - diag).to(ry.dtype)}}
    b, l = x.shape[:2]
    if l > c:
        per = [t.reshape(b * (l // c), c, *t.shape[2:]) for t in (x, a, B, C)]
        out["carried state dropped between chunks"] = {
            "y": ssd_fwd_ref(*per, c)[0].reshape(x.shape)}
    return out


def ssd_da_shifted(da, c):
    """da's reverse cumsum shifted by one row: sum over u > t within the
    chunk instead of u >= t."""
    import torch
    b, l, h = da.shape
    d = da.reshape(b, l // c, c, h)
    return torch.cat([d[:, :, 1:], torch.zeros_like(d[:, :, :1])],
                     2).reshape(b, l, h)


# planted faults of the SSD backward: the outputs each one shows in
SSD_BWD_FAULTS = {"dh_final ignored": ("dx", "da", "dB", "dC"),
                  "da's reverse cumsum shifted by one row": ("da",),
                  "dB summed over half the heads": ("dB",)}


def ssd_faulty_bwd(fault, x, a, B, C, hprev, dy, dhfin, chunk):
    """The plain SSD backward (dx, da, dB, dC), with ``fault`` (a key of
    SSD_BWD_FAULTS) planted when given; "dB summed over half the heads"
    takes dB from a backward whose odd heads' dy and dh_final are 0."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_bwd_ref
    if fault == "dh_final ignored":
        dhfin = torch.zeros_like(dhfin)
    dx, da, dB, dC = ssd_bwd_ref(x, a, B, C, hprev, dy, dhfin, chunk)
    if fault == "da's reverse cumsum shifted by one row":
        da = ssd_da_shifted(da, chunk)
    elif fault == "dB summed over half the heads":
        even = torch.arange(dy.shape[2], device=dy.device) % 2 == 0
        dB = ssd_bwd_ref(x, a, B, C, hprev, dy * even[:, None].to(dy.dtype),
                         dhfin * even[:, None, None], chunk)[2]
    return dx, da, dB, dC


def ssd_bwd_faults(x, a, B, C, hprev, dy, dhf, c):
    """{fault: {output: plain backward with the fault}} over
    SSD_BWD_FAULTS, each on the outputs it shows in."""
    names = ("dx", "da", "dB", "dC")
    out = {}
    for fault, shows in SSD_BWD_FAULTS.items():
        got = dict(zip(names, ssd_faulty_bwd(fault, x, a, B, C, hprev, dy,
                                             dhf, c)))
        out[fault] = {k: got[k] for k in shows}
    return out


def ssd_work(b, l, h, c, p=64, n=64):
    """Multiply-adds the SSD scan needs, (forward, backward), each as
    {peak: count}.  C B^T (the causal pairs times n) is shared by all
    heads (B and C have one group), so it counts once per (batch, chunk);
    the rest counts per (batch, head, chunk).  Products of two bf16
    inputs (C B^T, and backward dy x^T: the pairs times p) are priced at
    the bf16 tensor-core rate, the products with an fp32 operand (L, the
    carried state) at the fp32 rate: forward, the pairs times p (the
    weighted sum of x) plus 2 c p n (the carried state's two terms);
    backward, the pairs times 2 n + p (dx, dB, dC) plus 4 c p n (the
    carried state's four terms)."""
    pairs = c * (c + 1) // 2
    chunks = b * (l // c)
    cb = chunks * pairs * n
    return ({"bf16_tensor": cb,
             "fp32": chunks * h * (pairs * p + 2 * c * p * n)},
            {"bf16_tensor": cb + chunks * h * pairs * p,
             "fp32": chunks * h * (pairs * (2 * n + p) + 4 * c * p * n)})


def check_ssd(dev, b, l, h, c, dtype="bfloat16", train=False):
    """Forward and backward kernel against their plain functions on the
    same inputs: y, h_final and (over several chunks) h_prev; dx, da, dB,
    dC from the plain forward's h_prev, and chained from the kernel
    forward's own h_prev.  Planted faults as in ``ssd_fwd_faults`` /
    ``ssd_bwd_faults``.  The forward is timed as its caller runs it:
    saving h_prev for training, not for a prefill."""
    import torch
    from repro_torch.kernels.ssd_scan import (ssd_bwd_ref, ssd_fwd_ref,
                                              ssd_scan)
    from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_bwd,
                                                     ssd_scan_fwd)
    dt = getattr(torch, dtype)
    x, a, B, C, dy, dhf = ssd_inputs(dev, b, l, h, c, dt)
    y, hfin, hprev = ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=True)
    ry, rh, rhp = ssd_fwd_ref(x, a, B, C, c)
    outs, refs = {"y": y, "h_final": hfin}, {"y": ry, "h_final": rh,
                                             "h_prev": rhp}
    if l > c:
        outs["h_prev"] = hprev
    fwd = ssd_verdict(outs, refs, ssd_fwd_faults(x, a, B, C, c, ry))
    names = ("dx", "da", "dB", "dC")
    rg = dict(zip(names, ssd_bwd_ref(x, a, B, C, rhp, dy, dhf, c)))
    bwd = ssd_verdict(
        dict(zip(names, ssd_scan_bwd(x, a, B, C, rhp, dy, dhf, chunk=c))),
        rg, ssd_bwd_faults(x, a, B, C, rhp, dy, dhf, c))
    bwd["chained"] = ssd_verdict(
        dict(zip(names, ssd_scan_bwd(x, a, B, C, hprev, dy, dhf, chunk=c))),
        rg, {})
    del y, hfin, hprev
    es = x.element_size()
    f_flops, b_flops = ({k: 2 * v for k, v in w.items()}
                        for w in ssd_work(b, l, h, c))
    f_bytes = ((2 * x.numel() + B.numel() + C.numel()) * es + a.numel() * 4
               + rh.numel() * 4 + (rhp.numel() * 4 if train else 0))
    b_bytes = ((3 * x.numel() + 2 * (B.numel() + C.numel())) * es
               + 2 * a.numel() * 4 + (rhp.numel() + dhf.numel()) * 4)
    case = f"b={b},l={l},h={h},p=64,n=64,c={c},{dtype}" + (
        ",saves h_prev (training)" if train else "")
    none = "none: no single PyTorch call computes an SSD chunk scan"
    op_host, wrapper_host = host_ms_pair(
        lambda: ssd_scan(x, a, B, C, chunk=c),
        lambda: ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=train))
    fwd.update({"case": case,
                "ms": time_ms(lambda: ssd_scan_fwd(x, a, B, C, chunk=c,
                                                   save_hprev=train)),
                "host_ms": op_host, "host_ms_wrapper": wrapper_host,
                "plain_ms": time_ms(lambda: ssd_fwd_ref(x, a, B, C, c), 3),
                "library_ms": None, "library_covers": none,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(f_bytes, f_flops)))})
    bk = lambda: ssd_scan_bwd(x, a, B, C, rhp, dy, dhf, chunk=c)  # noqa
    bwd.update({"case": case, "ms": time_ms(bk), "host_ms": host_ms(bk),
                "plain_ms": time_ms(lambda: ssd_bwd_ref(x, a, B, C, rhp, dy,
                                                        dhf, c), 3),
                "library_ms": None, "library_covers": none,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(b_bytes, b_flops)))})
    return {"ssd_scan": fwd, "ssd_scan_bwd": bwd}


def check_ssd_padded(dev, l=777, c=256, h=64):
    """A prompt length that is not a chunk multiple, through ``ops.
    ssd_scan`` (which pads to 1024 with zero x, a, B, C): y, h_final and
    the gradients of sum(y * dy) + sum(h_final * dh) through the SSDScan
    Function (both kernels) against autograd of the plain chunked scan
    on the same inputs padded by hand."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm_common import ssd_chunked
    x, a, B, C, dy, dhf = ssd_inputs(dev, 1, l, h, c, torch.bfloat16)
    l_p = -(-l // c) * c

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, a, B, C)]
        y, hf = fn(*leaves)
        loss = (y.float() * dy.float()).sum() + (hf * dhf).sum()
        return {"y": y.detach(), "h_final": hf.detach(),
                **dict(zip(("dx", "da", "dB", "dC"),
                           torch.autograd.grad(loss, leaves)))}

    def plain(*t):
        padded = [F.pad(v, [0, 0] * (v.dim() - 2) + [0, l_p - l]) for v in t]
        y, hf = ssd_chunked(*padded, c)
        return y[:, :l], hf

    got, ref = run(lambda *t: ssd_scan(*t, chunk=c)), run(plain)
    case = f"b=1,l={l} (padded to {l_p}),h={h},p=64,n=64,c={c},bfloat16"
    fwd = ssd_verdict({k: got[k] for k in ("y", "h_final")}, ref, {})
    bwd = ssd_verdict({k: got[k] for k in ("dx", "da", "dB", "dC")}, ref, {})
    return {"ssd_scan": {"case": case, **fwd},
            "ssd_scan_bwd": {"case": case, "reference": "autograd of the "
                             "plain chunked scan", **bwd}}


# the first case of each kernel is the training step (the row the kernel
# summary reports), then whole-prompt prefills of zamba2's serving trace
SSD_CASES = [dict(b=2, l=2048, h=64, c=256, train=True),
             dict(b=1, l=1024, h=64, c=256), dict(b=1, l=200, h=64, c=200),
             dict(b=1, l=768, h=64, c=256),
             dict(b=1, l=512, h=64, c=256, dtype="float32")]


def ssd_phase(dev):
    """Both SSD chunk-scan kernels at zamba2-1.2b's shapes (64 heads of
    64, state 64): the training step (b 2 x 2048), prefills of 1024 (4
    chunks), 200 (one chunk of 200) and 768 (the head of a 777-token
    prompt), one fp32 case, and a 777-token prompt through the padding
    wrapper."""
    cases = {"ssd_scan": [], "ssd_scan_bwd": []}
    for kw in SSD_CASES:
        for name, row in check_ssd(dev, **kw).items():
            cases[name].append(row)
    for name, row in check_ssd_padded(dev).items():
        cases[name].append(row)
    return cases


# ------------------------------- end to end ---------------------------------


def request_set(vocab, seed=SEED):
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [64, 1024, 200, 512, 96, 777, 333, 640]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    arrivals = [0, 0, 1, 3, 5, 8, 12, 16]
    return prompts, arrivals


def e2e_run(model, params, prompts, arrivals, dev, prefill_chunk, gen=32,
            kernels=DENSE_SERVING_KERNELS):
    """One serving run of the trace with the launch counters zeroed
    before and read after; fails if a kernel of ``kernels`` never
    launched."""
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
    dead = [k for k in kernels if counts[k] <= 0]
    if dead:
        raise AssertionError(f"kernels never launched on the serving path "
                             f"(prefill_chunk={prefill_chunk}): {dead}")
    return out, res["tokens"]


def cat_batch(trees):
    """Per-sequence state trees (batch 1 each) joined along the batch."""
    import torch
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: cat_batch([t[k] for t in trees]) for k in t0}
    if isinstance(t0, list):
        return [cat_batch([t[i] for t in trees]) for i in range(len(t0))]
    return torch.cat(trees, 0)


def teacher_forced(model, params, prompts, forced, dev, n_ticks=4, bs=16,
                   prefill_chunk=0):
    """First-token logits (fresh or chunked prefill) and ``n_ticks``
    decode ticks fed ``forced`` tokens through a fragmented paged pool;
    returns fp32 logits (1 + n_ticks, b, V).  Prefill follows the
    engine: attention-only families pad to a power-of-two bucket, the
    hybrid runs exact-length chunks and its mamba states ride into the
    decode ticks beside the pool."""
    import numpy as np
    import torch
    from repro_torch.serving.paged_cache import PagedKVCache
    cfg = model.cfg
    b = len(prompts)
    lens = [len(p) for p in prompts]
    need = [-(-(n + n_ticks) // bs) for n in lens]
    cache = PagedKVCache(layers=model.paged_kv_layers,
                         n_blocks=sum(need) + 1, block_size=bs,
                         kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                         device=dev)
    keys = tuple(model.paged_state_extras(1, device=dev))
    perm = (np.random.default_rng(5).permutation(sum(need)) + 1).tolist()
    blocks = [[perm.pop() for _ in range(n)] for n in need]
    first, extras = [], []
    for p, blk in zip(prompts, blocks):
        s = len(p)
        if model.prefill_padding_ok:
            cap = 1 << max(4, (s - 1).bit_length())
            C = min(prefill_chunk or cap, cap)
            cap = -(-cap // C) * C
        else:
            cap, C = s, prefill_chunk or s
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
        extras.append({k: state[k] for k in keys})
        cache.write_prompt(state["k"][:, 0, :s], state["v"][:, 0, :s],
                           blk[:-(-s // bs)])
        del state
    extras = cat_batch(extras) if keys else {}
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
                 "lengths": ln, **extras}
        state, logits = model.forward(params, state, tok, ln[:, None])
        extras = {k: state[k] for k in keys}
        out.append(logits.float())
    return torch.stack(out)


def profiled(run, top=12):
    """``run()`` once more under torch.profiler: the device's busy share
    of the traced wall time, the device operations by time, and the
    device time of the port's attention kernels."""
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

    def op(e):
        return {"op": e.key[:80], "calls": e.count,
                "device_ms": dev_us(e) / 1e3}
    # the port's attention kernels (flash forward and backward, paged)
    attn = [e for e in rows if "flash_" in e.key or "paged_chunk" in e.key]
    attn_ms = sum(dev_us(e) for e in attn) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top": [op(e) for e in rows[:top]],
            "attention": {"device_ms": attn_ms,
                          "share_of_busy": attn_ms / busy_ms,
                          "ops": [op(e) for e in attn]}}


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
        cmp += logit_rows(got, ref, E2E_REL_TOL, prefill_chunk=chunk)
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


def with_patches(patches, fn):
    """``fn()`` with each (module, name, replacement) of ``patches``
    swapped in for the call."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, new in patches:
        setattr(mod, name, new)
    try:
        return fn()
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def loss_grads_against(model, params, batch, ref_loss, ref_grads,
                       patches=(), loss_tol=TRAIN_LOSS_REL_TOL,
                       grad_tol=TRAIN_GRAD_REL_TOL, leaves=None,
                       leaf_tol=None):
    """The loss and every gradient of ``model`` on ``batch``, with the
    ``patches`` [(module, name, replacement)] swapped in for the run,
    against ``ref_loss`` / ``ref_grads``: the loss's relative difference
    and per leaf |g - g_ref| / |g_ref|.  ``within``: the loss within
    ``loss_tol`` and every leaf (or every leaf named in ``leaves``)
    within ``grad_tol``, or within its own tolerance in ``leaf_tol``.
    The worst leaf is the one that uses the most of its tolerance."""
    from repro_torch.train_lib import loss_and_grads
    lk, _, gk = with_patches(patches, lambda: loss_and_grads(model, params,
                                                             batch))
    rel = rel_by_leaf(gk, ref_grads)
    del gk
    tol = {k: (leaf_tol or {}).get(k, grad_tol) for k in rel
           if leaves is None or k in leaves}
    worst = max(tol, key=lambda k: rel[k] / tol[k])
    lk = float(lk)
    loss_rel = abs(lk - ref_loss) / abs(ref_loss)
    return {"loss_kernel": lk, "loss_ref": ref_loss, "loss_rel": loss_rel,
            "loss_rel_tol": loss_tol, "grad_rel": rel,
            "grad_rel_max": rel[worst], "grad_rel_max_leaf": worst,
            "grad_rel_tol": tol[worst],
            "within": (loss_rel <= loss_tol and rel[worst] <= tol[worst]
                       and math.isfinite(lk))}


def fault_row(fault, gating, r):
    row = {"fault": fault, "gating": gating, "caught": not r.pop("within"),
           **{k: r[k] for k in ("loss_rel", "grad_rel_max",
                                "grad_rel_max_leaf")}}
    print(json.dumps({"train_fault": row}), flush=True)
    return row


def train_steps(model, params, cfg, dev, kernels, n_flop_params, label,
                attn_layers=None, extra_flops=0):
    """AdamW (warmup_cosine(3e-4, 2, TRAIN_STEPS), fp32 masters and
    moments) for TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ synthetic
    tokens through ``parallel.plan.make_train_step``, the launch counters
    zeroed before and read after, then one step under the profiler.
    MFU counts 6 * n_flop_params * tokens + 12 * L * h * d * causal
    pairs (L: ``attn_layers``, default every layer) + ``extra_flops``.
    Returns (results, failures); frees the state."""
    import statistics

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.telemetry import now
    B, S = TRAIN_BATCH, TRAIN_SEQ
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
        b = train_batch(cfg, dev, i)
        torch.cuda.synchronize()
        t0 = now()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))      # synchronises
        times.append(now() - t0)
        print(json.dumps({f"{label}_step": i, "loss": losses[-1],
                          "seconds": times[-1]}), flush=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = B * S
    med = statistics.median(times)
    pairs = B * causal_pairs(S, S, 0, S)
    L = cfg.n_layers if attn_layers is None else attn_layers
    flops = 6 * n_flop_params * tokens + \
        12 * L * cfg.n_heads * cfg.head_dim * pairs + extra_flops
    prof = profiled(lambda: float(step(state, train_batch(
        cfg, dev, TRAIN_STEPS))[1]["loss"]))
    out = {"batch": B, "seq": S, "steps": TRAIN_STEPS, "losses": losses,
           "step_s": times, "median_step_s": med,
           "tokens_per_s": tokens / med, "model_flops_per_step": flops,
           "mfu_vs_bf16_dense_peak": flops / med / PEAK["bf16_tensor"],
           "peak_mem_gb": peak / 1e9, "launches": counts,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in counts.items()},
           "profile": prof}
    del state
    torch.cuda.empty_cache()
    failures = []
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{label}: losses not finite: {losses}")
    dead = [k for k in kernels if counts[k] <= 0]
    if dead:
        failures.append(f"{label}: kernels never launched on the training "
                        f"path: {dead}")
    return out, failures


def train_batch(cfg, dev, i):
    import torch
    from repro_torch.data.synthetic import batch_for_model
    return {k: torch.as_tensor(v, device=dev) for k, v in batch_for_model(
        cfg, "train", i, TRAIN_BATCH, TRAIN_SEQ, seed=SEED).items()}


def train_phase(dev):
    """phi4-mini-3.8b at full width trains on the card: random bf16
    weights drawn on the card from SEED, synthetic batches of
    TRAIN_BATCH x TRAIN_SEQ tokens.  First the kernel path and the plain
    path (attn_impl / norm_impl "ref") take the loss and every gradient
    of one batch, before any optimizer state exists, and so do the
    kernel path's planted faults (``train_faults``); then
    ``train_steps``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train_lib import loss_and_grads
    cfg = get_arch(ARCH)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    b0 = train_batch(cfg, dev, 0)

    # 1. kernel path against plain path on one batch, then the kernel
    # path with each planted fault against the same plain path
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref"))
    lp, _, gp = loss_and_grads(plain, params, b0)
    lp = float(lp)
    vs_plain = loss_grads_against(model, params, b0, lp, gp)
    vs_plain["ok"] = vs_plain.pop("within") and math.isfinite(lp)
    print(json.dumps({"train_vs_plain": vs_plain}), flush=True)
    vs_plain["controls"] = [
        fault_row(fault, gating, loss_grads_against(model, params, b0, lp,
                                                    gp, patches))
        for fault, (gating, patches) in train_faults().items()]
    del gp

    # 2. training
    out, failures = train_steps(model, params, cfg, dev, TRAIN_KERNELS,
                                n_params, "train")
    out = {"arch": ARCH, "params": n_params, **out, "vs_plain": vs_plain}
    if not vs_plain["ok"]:
        failures.append(f"training kernel vs plain: loss_rel "
                        f"{vs_plain['loss_rel']}, worst grad_rel "
                        f"{vs_plain['grad_rel_max']} "
                        f"({vs_plain['grad_rel_max_leaf']})")
    failures += [f"training: planted fault '{f['fault']}' passed the "
                 f"gates" for f in vs_plain["controls"]
                 if f["gating"] and not f["caught"]]
    return out, failures


# ----------------------------------- MoE ------------------------------------


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at magnitude ``x`` > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def logit_rows(got, ref, rel_tol=None, bf16_ulps=None, same_argmax=False,
               **labels):
    """One comparison row per logits set (first token, 4 decode ticks):
    max |got - ref| against ``rel_tol`` times max |ref|, or against
    ``bf16_ulps`` bf16 ulps of max |ref| (and, with ``same_argmax``,
    every greedy token identical)."""
    import torch
    rows = []
    for i, name in enumerate(["first_token"] +
                             [f"tick_{t}" for t in range(1, len(got))]):
        d = float((got[i] - ref[i]).abs().max())
        scale = float(ref[i].abs().max())
        tol = rel_tol * scale if bf16_ulps is None else \
            bf16_ulps * bf16_ulp(scale)
        agree = float((got[i].argmax(-1) == ref[i].argmax(-1))
                      .float().mean())
        finite = bool(torch.isfinite(got[i]).all())
        ok = d <= tol and finite
        if same_argmax:
            ok = ok and agree == 1.0
        rows.append({**labels, "logits": name, "max_abs_diff": d,
                     "max_abs_ref": scale, "rel": d / scale,
                     "tol_used": d / tol, "argmax_agree": agree,
                     "finite": finite, "ok": ok})
    return rows


def rolled_experts_patch():
    """The planted wiring fault of the MoE path: the gating kernel's
    experts rolled by one (expert e's tokens go to expert e + 1)."""
    from repro_torch.kernels import topk_gating as gating
    gate = gating.topk_gating

    def rolled(logits, *, k, renorm=True, impl="auto"):
        w, e = gate(logits, k=k, renorm=renorm, impl=impl)
        return w, (e + 1) % logits.shape[-1]
    return [(gating, "topk_gating", rolled)]


def moe_layer_check(cfg, params, dev):
    """Layer 0's routed experts of the full-width model (its bf16
    weights; shared experts off, so y is the routed part alone) on
    unit-RMS inputs: the gating kernel route against the plain route
    (gate_impl "ref") at a decode tick (8 tokens) and a prefill bucket
    (1024), dropless, and at the training step (4096, capacity-limited),
    within MOE_LAYER_TOL of max |y|; experts rolled by one in the
    kernel's output must fail that gate."""
    import torch
    from repro_torch.models.moe import apply_moe
    routed = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                              d_shared=0))
    plain = dataclasses.replace(routed, gate_impl="ref")
    lp = {k[4:]: v[0] for k, v in params["layers"].items()
          if k.startswith("moe_")}
    g = torch.Generator(device=dev).manual_seed(11)
    rows = []
    with torch.no_grad():
        for T, dropless in ((8, True), (1024, True), (4096, False)):
            h = torch.randn(1, T, cfg.d_model, device=dev,
                            generator=g).bfloat16()

            def y(c):
                return apply_moe(c, lp, h, dropless=dropless, _aux=False)[0]
            got, ref = y(routed), y(plain)
            bad = with_patches(rolled_experts_patch(), lambda: y(routed))
            scale = float(ref.abs().max())
            d, f = (float((x - ref).abs().max()) for x in (got, bad))
            rows.append({"tokens": T, "dropless": dropless,
                         "max_abs_diff": d, "max_abs_ref": scale,
                         "rel": d / scale, "tol": MOE_LAYER_TOL,
                         "fault_rel": f / scale,
                         "ok": d <= MOE_LAYER_TOL * scale,
                         "fault_caught": f > MOE_LAYER_TOL * scale})
            print(json.dumps({"moe_layer_vs_plain": rows[-1]}), flush=True)
    return rows


def moe_serve_phase(dev):
    """qwen2-moe-a2.7b at full width (24 layers, random bf16 weights
    drawn on the card from SEED, not cut) serves the phi4 trace over its
    own vocabulary, whole-prompt and in prefill chunks of 256; every
    serving kernel, the gating kernel included, must launch.  Then the
    kernel path against two references on the same prompts and forced
    tokens (first-token logits and 4 decode ticks through a fragmented
    paged pool): gating only (gate_impl "ref", every other kernel on)
    within MOE_GATE_LOGIT_ULPS bf16 ulps with identical greedy tokens,
    and the whole plain path within MOE_E2E_REL_TOL.  The planted fault
    (experts rolled by one) is recorded against the whole plain path and
    must fail ``moe_layer_check``."""
    import torch
    from repro_torch.launch.serve import build
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, model, params = build(MOE_ARCH, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in tree_leaves(params))
    prompts, arrivals = request_set(cfg.vocab_size)
    e2e_run(model, params, [prompts[0][:64], prompts[4][:80]], [0, 0], dev,
            0, gen=4, kernels=SERVING_KERNELS)
    runs, tokens = [], None
    for chunk in (0, 256):
        out, toks = e2e_run(model, params, prompts, arrivals, dev, chunk,
                            kernels=SERVING_KERNELS)
        runs.append(out)
        tokens = tokens or toks
        print(json.dumps({"moe_e2e": out}), flush=True)
    gate_ref = build_model(dataclasses.replace(cfg, gate_impl="ref"))
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref",
                                            gate_impl="ref"))
    cmp, plain0 = [], None
    for chunk in (0, 256):
        got = teacher_forced(model, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        ref = teacher_forced(gate_ref, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        cmp += logit_rows(got, ref, bf16_ulps=MOE_GATE_LOGIT_ULPS,
                          same_argmax=True, route="gating only",
                          prefill_chunk=chunk)
        ref = teacher_forced(plain, params, prompts, tokens, dev,
                             prefill_chunk=chunk)
        cmp += logit_rows(got, ref, MOE_E2E_REL_TOL, route="whole path",
                          prefill_chunk=chunk)
        plain0 = ref if chunk == 0 else plain0
        del got
    bad = with_patches(rolled_experts_patch(), lambda: teacher_forced(
        model, params, prompts, tokens, dev))
    fault = logit_rows(bad, plain0, MOE_E2E_REL_TOL,
                       route="experts rolled by one (planted fault, "
                             "recorded)", prefill_chunk=0)
    del bad, plain0
    for c in cmp + fault:
        print(json.dumps({"moe_e2e_vs_plain": c}), flush=True)
    layer = moe_layer_check(cfg, params, dev)
    prof = profiled(lambda: e2e_run(model, params, prompts, arrivals, dev, 0,
                                    kernels=SERVING_KERNELS))
    print(json.dumps({"moe_profile": prof}), flush=True)
    out = {"arch": MOE_ARCH, "params": n_params,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "runs": runs, "vs_plain": cmp, "gate_only_bf16_ulps":
           MOE_GATE_LOGIT_ULPS, "rel_tol": MOE_E2E_REL_TOL,
           "fault_rel_max": max(r["rel"] for r in fault),
           "layer_vs_plain": layer, "profile": prof}
    del params
    torch.cuda.empty_cache()
    failures = [f"moe serving {c['route']}: {c}" for c in cmp if not c["ok"]]
    failures += [f"moe layer, {r['tokens']} tokens: {r}" for r in layer
                 if not r["ok"] or not r["fault_caught"]]
    return out, failures


def gating_train_faults():
    """Planted faults of the gating backward on the training path: the
    TopKGating Function's kernel swapped for the plain backward with
    one fault ("c term dropped" is invisible with renorm)."""
    from repro_torch.kernels.topk_gating import ops
    return {f: [(ops, "topk_gating_bwd",
                 lambda logits, experts, dw, k, renorm, f=f:
                 _gating_bwd_faulty(logits, experts, dw, renorm, f))]
            for f in ("renorm Jacobian dropped", "scattered to index + 1")}


def moe_train_phase(dev):
    """qwen2-moe-a2.7b at full widths with its depth cut to
    MOE_TRAIN_LAYERS trains on the card (capacity-limited dispatch,
    groups of 512, cap 42).  On one batch, the kernel path against:
    (1) the plain path (attention, rmsnorm and gating "ref") at the
    training gates, the routed leaves at MOE_ROUTED_GRAD_TOL; (2) the
    gating-only reference (gate_impl "ref", every other kernel on): loss
    within MOE_GATE_LOSS_TOL, ``moe_router`` within MOE_ROUTED_GRAD_TOL;
    (3) the kernel forward with the plain gating backward (the forward
    bitwise the same): ``moe_router`` within MOE_GATE_ROUTER_TOL, which
    the planted gating-backward faults must fail.  Then ``train_steps``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.topk_gating import ops as gating_ops
    from repro_torch.kernels.topk_gating import topk_gating_bwd_ref
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train_lib import loss_and_grads
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_active = cfg.active_param_count()
    b0 = train_batch(cfg, dev, 0)
    router = ("layers/moe_router",)
    routed_tol = {k: MOE_ROUTED_GRAD_TOL for k in MOE_ROUTED_LEAVES}
    checks = {}
    for name, ref_model, patches, kw in (
            ("vs_plain", build_model(dataclasses.replace(
                cfg, attn_impl="ref", norm_impl="ref", gate_impl="ref")),
             (), dict(leaf_tol=routed_tol)),
            ("vs_gate_ref", build_model(dataclasses.replace(
                cfg, gate_impl="ref")), (),
             dict(loss_tol=MOE_GATE_LOSS_TOL, grad_tol=MOE_ROUTED_GRAD_TOL,
                  leaves=router)),
            ("vs_plain_gating_backward", model,
             [(gating_ops, "topk_gating_bwd", topk_gating_bwd_ref)],
             dict(loss_tol=MOE_GATE_LOSS_TOL, grad_tol=MOE_GATE_ROUTER_TOL,
                  leaves=router))):
        lr, _, gr = with_patches(patches, lambda: loss_and_grads(
            ref_model, params, b0))
        lr = float(lr)
        r = loss_grads_against(model, params, b0, lr, gr, **kw)
        r["ok"] = r.pop("within") and math.isfinite(lr)
        print(json.dumps({f"moe_train_{name}": r}), flush=True)
        if name == "vs_plain_gating_backward":
            r["controls"] = [
                fault_row(fault, True, loss_grads_against(
                    model, params, b0, lr, gr, fault_patches, **kw))
                for fault, fault_patches in gating_train_faults().items()]
        checks[name] = r
        del gr
    out, failures = train_steps(model, params, cfg, dev, MOE_TRAIN_KERNELS,
                                n_active, "moe_train")
    out = {"arch": MOE_ARCH, "n_layers": MOE_TRAIN_LAYERS,
           "params": n_params, "active_params": n_active, **out, **checks}
    for name, r in checks.items():
        if not r["ok"]:
            failures.append(f"moe training {name}: loss_rel {r['loss_rel']}"
                            f", worst grad_rel {r['grad_rel_max']} "
                            f"({r['grad_rel_max_leaf']})")
    failures += [f"moe training: planted fault '{f['fault']}' passed the "
                 f"gating backward gate"
                 for f in checks["vs_plain_gating_backward"]["controls"]
                 if not f["caught"]]
    return out, failures


# --------------------------------- hybrid -----------------------------------


def ssd_carry_dropped(fwd):
    """The planted fault of the hybrid serving path: the SSD forward
    ``fwd`` run on each chunk alone (the carried state dropped between
    chunks; h_final is the last chunk's)."""
    def dropped(x, a, B, C, *, chunk, save_hprev=False):
        b, l = x.shape[:2]
        per = [t.reshape(b * (l // chunk), chunk, *t.shape[2:])
               for t in (x, a, B, C)]
        y, hf = fwd(*per, chunk=chunk)
        return y.reshape(x.shape), hf.reshape(b, l // chunk,
                                              *hf.shape[1:])[:, -1]
    return dropped


def ssd_forward_probe(fwd):
    """A stand-in for ``ops.ssd_scan_fwd`` on the serving path: each call
    runs ``fwd`` (the kernel, or one with a planted fault) and the plain
    forward on the same inputs, records y and h_final against the plain
    ones (``ssd_verdict``) and returns ``fwd``'s.  Returns (stand-in,
    list of per-call verdicts)."""
    from repro_torch.kernels.ssd_scan import ssd_fwd_ref
    calls = []

    def probe(x, a, B, C, *, chunk, save_hprev=False):
        got = fwd(x, a, B, C, chunk=chunk, save_hprev=save_hprev)
        ry, rh = ssd_fwd_ref(x, a, B, C, chunk)[:2]
        calls.append(ssd_verdict({"y": got[0], "h_final": got[1]},
                                 {"y": ry, "h_final": rh}, {}))
        return got
    return probe, calls


def slow_decay(params):
    """``params`` with every Mamba layer's A_log set to SLOW_A_LOG."""
    import torch
    m = params["mamba"]
    return {**params, "mamba": {
        **m, "A_log": torch.full_like(m["A_log"], SLOW_A_LOG)}}


def hybrid_serve_phase(dev):
    """zamba2-1.2b at full width and depth (38 Mamba-2 layers, the shared
    block 6 times; random bf16 weights drawn on the card from SEED)
    serves the phi4 trace over its own vocabulary, whole-prompt and in
    prefill chunks of 256, through exact-length prefill chunks and
    per-slot mamba state pools; every serving kernel, the SSD scan
    included, must launch: 38 times per prompt (every whole-prompt
    prefill, and the first chunk of a chunked one; at least that when
    evictions replay prefills).  Then the kernel path against two
    references on the same prompts and forced tokens (first-token logits
    and 4 decode ticks through a fragmented paged pool): the SSD scan
    only (ssm_impl "ref", every other kernel on) within
    HYBRID_SSD_LOGIT_ULPS bf16 ulps with identical greedy tokens, which
    the SSD kernel with its carry dropped must fail, and the whole plain
    path within HYBRID_E2E_REL_TOL; both bf16 paths against the fp32
    forward are recorded.  Then on slow-decay weights (SLOW_A_LOG),
    whole prompts: every SSD forward call held at the op, and the same
    two logits gates; the dropped carry must fail the op gate and the
    SSD-only one."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import build
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, model, params = build(HYBRID_ARCH, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in tree_leaves(params))
    prompts, arrivals = request_set(cfg.vocab_size)
    e2e_run(model, params, [prompts[0][:64], prompts[4][:80]], [0, 0], dev,
            0, gen=4, kernels=HYBRID_SERVING_KERNELS)
    runs, tokens, failures = [], None, []
    for chunk in (0, 256):
        out, toks = e2e_run(model, params, prompts, arrivals, dev, chunk,
                            kernels=HYBRID_SERVING_KERNELS)
        want, got = cfg.n_layers * len(prompts), out["launches"]["ssd_scan"]
        # a replayed request prefills again: then at least ``want``
        out["ssd_scan_launches_expected"] = (
            want if out["evictions"] == 0 else f">= {want} "
            f"({out['evictions']} evictions replayed)")
        if got < want or (out["evictions"] == 0 and got != want):
            failures.append(f"hybrid serving (prefill_chunk={chunk}): "
                            f"ssd_scan launched {got} times, expected "
                            f"{out['ssd_scan_launches_expected']}")
        runs.append(out)
        tokens = tokens or toks
        print(json.dumps({"hybrid_e2e": out}), flush=True)
    ssd_ref = build_model(dataclasses.replace(cfg, ssm_impl="ref"))
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref", ssm_impl="ref"))
    f32 = build_model(dataclasses.replace(
        cfg, compute_dtype="float32", attn_impl="ref", norm_impl="ref",
        ssm_impl="ref"))
    dropped = [(ssd_ops, "ssd_scan_fwd",
                ssd_carry_dropped(ssd_ops.ssd_scan_fwd))]

    def forced(m, p, chunk=0, patches=()):
        return with_patches(list(patches), lambda: teacher_forced(
            m, p, prompts, tokens, dev, prefill_chunk=chunk))

    def against_fp32(p, got, ref, **labels):
        # both bf16 paths against the plain forward in fp32 on fp32
        # copies of the same weights (recorded: what the gates sit in)
        p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.float())
               for k, v in p.items()}
        truth = forced(f32, p32)
        del p32
        return [r for route, x in (("kernel path vs fp32 forward", got),
                                   ("plain path vs fp32 forward", ref))
                for r in logit_rows(x, truth, HYBRID_E2E_REL_TOL,
                                    route=f"{route} (recorded)", **labels)]

    cmp, recorded, controls = [], [], []
    for chunk in (0, 256):
        got, ref = forced(model, params, chunk), forced(ssd_ref, params, chunk)
        cmp += logit_rows(got, ref, bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                          same_argmax=True, route="ssd only",
                          prefill_chunk=chunk)
        if chunk == 0:
            rows = logit_rows(forced(model, params, patches=dropped), ref,
                              bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                              same_argmax=True, route="ssd only",
                              prefill_chunk=0)
            controls.append({"fault": "SSD kernel with its carry dropped",
                             "check": "ssd only logits",
                             "tol_used": max(r["tol_used"] for r in rows),
                             "caught": not all(r["ok"] for r in rows)})
        ref = forced(plain, params, chunk)
        cmp += logit_rows(got, ref, HYBRID_E2E_REL_TOL, route="whole path",
                          prefill_chunk=chunk)
        if chunk == 0:
            recorded += against_fp32(params, got, ref, prefill_chunk=0)
        del got, ref

    # slow decay: the carried state matters; whole prompts
    slow = slow_decay(params)
    probe, calls = ssd_forward_probe(ssd_ops.ssd_scan_fwd)
    got = forced(model, slow, patches=[(ssd_ops, "ssd_scan_fwd", probe)])
    slow_op = op_summary(calls)
    probe, calls = ssd_forward_probe(ssd_carry_dropped(ssd_ops.ssd_scan_fwd))
    bad = forced(model, slow, patches=[(ssd_ops, "ssd_scan_fwd", probe)])
    bad_op = op_summary(calls)
    controls.append({"fault": "SSD kernel with its carry dropped",
                     "check": "slow decay, each SSD forward call at the op",
                     "tol_used": bad_op["tol_used"],
                     "caught": not bad_op["ok"]})
    ref = forced(ssd_ref, slow)
    lab = dict(prefill_chunk=0, weights="slow decay")
    cmp += logit_rows(got, ref, bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                      same_argmax=True, route="ssd only", **lab)
    rows = logit_rows(bad, ref, bf16_ulps=HYBRID_SSD_LOGIT_ULPS,
                      same_argmax=True, route="ssd only", **lab)
    controls.append({"fault": "SSD kernel with its carry dropped",
                     "check": "slow decay, ssd only logits",
                     "tol_used": max(r["tol_used"] for r in rows),
                     "caught": not all(r["ok"] for r in rows)})
    del bad
    ref = forced(plain, slow)
    cmp += logit_rows(got, ref, HYBRID_E2E_REL_TOL, route="whole path",
                      **lab)
    recorded += against_fp32(slow, got, ref, **lab)
    del got, ref, slow
    for c in cmp + recorded:
        print(json.dumps({"hybrid_e2e_vs_plain": c}), flush=True)
    print(json.dumps({"hybrid_slow_decay_op": slow_op,
                      "hybrid_serve_controls": controls}), flush=True)
    prof = profiled(lambda: e2e_run(model, params, prompts, arrivals, dev, 0,
                                    kernels=HYBRID_SERVING_KERNELS))
    print(json.dumps({"hybrid_profile": prof}), flush=True)
    out = {"arch": HYBRID_ARCH, "params": n_params,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "runs": runs, "vs_plain": cmp, "slow_decay_op": slow_op,
           "controls": controls, "recorded": recorded,
           "ssd_only_bf16_ulps": HYBRID_SSD_LOGIT_ULPS,
           "rel_tol": HYBRID_E2E_REL_TOL, "profile": prof}
    del params
    torch.cuda.empty_cache()
    failures += [f"hybrid serving {c['route']}: {c}" for c in cmp
                 if not c["ok"]]
    if not slow_op["ok"]:
        failures.append(f"hybrid serving, slow decay: an SSD forward call "
                        f"failed the op gate: {slow_op}")
    failures += [f"hybrid serving: planted fault '{c['fault']}' passed "
                 f"the {c['check']}" for c in controls if not c["caught"]]
    return out, failures


# planted faults of the SSD backward on the training path (dh_final
# ignored cannot show there: training never reads h_final, so its
# cotangent is zero)
SSD_TRAIN_FAULTS = ("da's reverse cumsum shifted by one row",
                    "dB summed over half the heads")


def ssd_backward_probe(fault=None):
    """A stand-in for ``ops.ssd_scan_bwd``: each call runs the backward
    kernel and the plain backward (with ``fault``) on the same saved
    inputs, records the kernel's outputs against the plain ones
    (``ssd_verdict``) and returns the plain ones — the plain SSD
    backward in place of the kernel's, the forward untouched.  Returns
    (stand-in, list of per-call verdicts)."""
    from repro_torch.kernels.ssd_scan import kernel
    names = ("dx", "da", "dB", "dC")
    calls = []

    def bwd(x, a, B, C, hprev, dy, dhfin, *, chunk):
        got = kernel.ssd_scan_bwd(x, a, B, C, hprev, dy, dhfin, chunk=chunk)
        ref = ssd_faulty_bwd(fault, x, a, B, C, hprev, dy, dhfin, chunk)
        calls.append(ssd_verdict(dict(zip(names, got)),
                                 dict(zip(names, ref)), {}))
        return ref
    return bwd, calls


def op_summary(calls):
    return {"calls": len(calls),
            "tol_used": max(c["tol_used"] for c in calls),
            "ok": all(c["ok"] for c in calls)}


def hybrid_train_phase(dev):
    """zamba2-1.2b at full width and depth trains on the card (nothing
    cut): random bf16 weights drawn on the card from SEED, batches of
    TRAIN_BATCH x TRAIN_SEQ.  On one batch, the kernel path against (1)
    the plain path (attention, rmsnorm and SSD "ref") at the training
    gates, and (2) the kernel forward with the plain SSD backward in
    place of the kernel's (the forward bitwise the same): each backward
    call's kernel outputs within SSD_REL_TOL of the plain ones on the
    same inputs, which the planted SSD-backward faults must fail, and
    every Mamba leaf within TRAIN_GRAD_REL_TOL (faults recorded there).
    Then ``train_steps``: launches per step must be
    2 x 38 forward (the recompute of remat included) and 38 backward.
    MFU counts the shared block once per invocation and the SSD scan's
    multiply-adds, forward and backward (``ssd_work``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.zamba import n_attn_invocations
    from repro_torch.train_lib import loss_and_grads
    cfg = get_arch(HYBRID_ARCH)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    inv = n_attn_invocations(cfg)
    shared = sum(p.numel() for p in params["shared"].values())
    n_flop = n_params + (inv - 1) * shared
    b0 = train_batch(cfg, dev, 0)
    mamba_leaves = tuple(f"mamba/{k}" for k in params["mamba"])

    # (1) the kernel path against the plain path
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref", ssm_impl="ref"))
    lp, _, gp = loss_and_grads(plain, params, b0)
    lp = float(lp)
    vs_plain = loss_grads_against(model, params, b0, lp, gp)
    vs_plain["ok"] = vs_plain.pop("within") and math.isfinite(lp)
    print(json.dumps({"hybrid_train_vs_plain": vs_plain}), flush=True)
    del gp

    # (2) the plain SSD backward in place of the kernel's, held at the op
    # and at the Mamba leaves; then each planted fault the same way
    probe, calls = ssd_backward_probe()
    lr, _, gr = with_patches([(ssd_ops, "ssd_scan_bwd", probe)],
                             lambda: loss_and_grads(model, params, b0))
    lr = float(lr)
    kw = dict(loss_tol=MOE_GATE_LOSS_TOL, leaves=mamba_leaves)
    bwd = loss_grads_against(model, params, b0, lr, gr, **kw)
    bwd["op"] = op_summary(calls)
    bwd["ok"] = bwd.pop("within") and bwd["op"]["ok"]
    print(json.dumps({"hybrid_train_vs_plain_ssd_backward": bwd}), flush=True)
    bwd["controls"] = []
    for fault in SSD_TRAIN_FAULTS:
        probe, calls = ssd_backward_probe(fault)
        r = loss_grads_against(model, params, b0, lr, gr,
                               [(ssd_ops, "ssd_scan_bwd", probe)], **kw)
        op = op_summary(calls)
        row = {"fault": fault, "caught": not op["ok"],
               "op_tol_used": op["tol_used"],
               "leaves_caught": not r["within"],
               "grad_rel_max": r["grad_rel_max"],
               "grad_rel_max_leaf": r["grad_rel_max_leaf"]}
        print(json.dumps({"train_fault": row}), flush=True)
        bwd["controls"].append(row)
    del gr
    checks = {"vs_plain": vs_plain, "vs_plain_ssd_backward": bwd}
    s = cfg.ssm
    ssd_macs = sum(sum(w.values()) for w in ssd_work(
        TRAIN_BATCH, TRAIN_SEQ, s.expand * cfg.d_model // s.head_dim,
        s.chunk_size, s.head_dim, s.state_size))
    out, failures = train_steps(model, params, cfg, dev, HYBRID_TRAIN_KERNELS,
                                n_flop, "hybrid_train", attn_layers=inv,
                                extra_flops=2 * ssd_macs * cfg.n_layers)
    out = {"arch": HYBRID_ARCH, "params": n_params,
           "flop_params": n_flop, **out, **checks}
    want = {"ssd_scan": 2 * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    for k, v in want.items():
        if out["launches_per_step"][k] != v:
            failures.append(f"hybrid training: {k} launched "
                            f"{out['launches_per_step'][k]} times per step, "
                            f"expected {v}")
    for name, r in checks.items():
        if not r["ok"]:
            failures.append(f"hybrid training {name}: loss_rel "
                            f"{r['loss_rel']}, worst grad_rel "
                            f"{r['grad_rel_max']} ({r['grad_rel_max_leaf']})")
    failures += [f"hybrid training: planted fault '{f['fault']}' passed the "
                 f"SSD backward's op gate"
                 for f in checks["vs_plain_ssd_backward"]["controls"]
                 if not f["caught"]]
    return out, failures


# ---------------------------------- main ------------------------------------



# ---------------------- int8 quantize / dequantize --------------------------

# the gpt2-medium DDP path's int8 weak phase: each rank's weak shard of a
# 25 MB bf16 bucket holds 25 MiB / 2 B / 4 strong ranks = 3 276 800
# elements, and the whole gradient's weak shards 353 553 408 / 4
QBLOCK = 256
BUCKET_SHARD = 25 * 1024 * 1024 // 2 // 4
WEAK_PAYLOAD = 353_553_408 // 4


def _quant_plain(x, fault=None):
    """The plain quantizer (``quant_comm.ref``'s arithmetic, written out
    so that a planted fault can change one step of it)."""
    import torch
    n = x.shape[0]
    xb = x.reshape(n // QBLOCK, QBLOCK).float()
    amax = xb.abs()
    if fault and "half the block" in fault:
        amax = amax[:, :QBLOCK // 2]
    scale = amax.amax(dim=1, keepdim=True) * torch.tensor(1 / 127,
                                                          dtype=torch.float32)
    den = torch.clamp(scale, min=1e-12)
    if fault == "x * (1/scale) in place of division":
        r = torch.round(xb * (1.0 / den))
    elif fault == "truncation in place of half-even rounding":
        r = torch.trunc(xb / den)
    else:
        r = torch.round(xb / den)
    if fault != "absmax over half the block, clip at ±127 dropped":
        r = torch.clamp(r, -127, 127)
    return r.to(torch.int8).reshape(n), scale[:, 0]


def _quant_library(x):
    """The nearest PyTorch composition (no one call quantizes
    blockwise): view -> abs().amax -> mul -> div -> round -> clamp ->
    to(int8)."""
    import torch
    xb = x.view(-1, QBLOCK).float()
    s = xb.abs().amax(dim=1, keepdim=True) * (1 / 127)
    q = (xb / s.clamp(min=1e-12)).round().clamp(-127, 127).to(torch.int8)
    return q, s


def _dequant_library(q, s, dtype):
    """to(float) -> mul, in the output dtype."""
    import torch
    return (q.view(-1, QBLOCK).to(torch.float32) * s[:, None]).to(dtype)


def quant_inputs(dev, kind, n, dtype, seed=9):
    """Gradient-like values (normal times a log-normal spread), blocks of
    zeros, or values on k + 0.5 code boundaries of their block's scale
    (the absmax planted in each block's last element)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "boundary":
        nb = n // QBLOCK
        A = torch.exp(torch.rand(nb, 1, device=dev, generator=g) * 9 - 6)
        s = A * torch.tensor(1 / 127, dtype=torch.float32)
        k = torch.randint(-127, 127, (nb, QBLOCK), device=dev, generator=g)
        x = (k.float() + 0.5) * s
        x[:, -1] = A[:, 0]
        return x.reshape(-1).to(dtype)
    x = torch.randn(n, device=dev, generator=g) * torch.exp(
        torch.randn(n, device=dev, generator=g))
    if kind == "zeros":
        x.view(-1, QBLOCK)[::3] = 0
    return x.to(dtype)


def bitwise(got, ref):
    """A bitwise gate: max |difference| (0 when the bits agree), and
    tol_used 0 or inf."""
    import torch
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else
              0.0 for a, b in zip(got, ref))
    return err, (0.0 if same else math.inf), same


def check_quant(dev, kind, n, dtype, pad_to=1):
    """quantize and dequantize (to fp32 and to bf16) against the plain
    versions on the same inputs, bitwise; planted faults must differ:
    truncation, the reciprocal multiply (boundary case), the absmax over
    half the block with and without the clip at ±127 (there the block's
    absmax is not among the values the faulty max saw, so only the clip
    keeps the codes in range; with the block's own absmax no finite input
    reaches the clip: |x| / fl(A fl(1/127)) <= 127 (1 + 2^-22)), and the
    dequantize with each block scaled by its neighbour's scale."""
    import torch
    from repro_torch.core.compression import _padded
    from repro_torch.kernels.quant_comm import (dequantize, dequantize_ref,
                                                quantize, quantize_ref)
    x = quant_inputs(dev, kind, n, dtype)
    if pad_to > 1:                 # the int8 wire's padding (int8_psum)
        x, _ = _padded(x, pad_to, keep=(dtype,))
    n = x.shape[0]
    q, s = quantize(x)
    rq, rs = quantize_ref(x)
    err, used, ok = bitwise((q, s), (rq, rs))
    faults = ["truncation in place of half-even rounding",
              "absmax over half the block, clip kept",
              "absmax over half the block, clip at ±127 dropped"]
    if kind == "boundary":
        faults.append("x * (1/scale) in place of division")
    ctl = []
    for f in faults:
        fe, fu, fok = bitwise((q, s), _quant_plain(x, f))
        ctl.append({"fault": f, "max_abs_err": fe, "tol_used": fu,
                    "caught": not fok, "codes_differing":
                    int((q != _quant_plain(x, f)[0]).sum())})
    case = f"{kind} n={n} {str(dtype).split('.')[-1]}"
    fwd = {"case": case, "max_abs_err": err, "tol_used": used, "ok": ok,
           "codes_differing": int((q != rq).sum()), "controls": ctl}
    in_b = x.element_size()
    for rec, fn, plain, lib, nbytes in (
            (fwd, lambda: quantize(x), lambda: quantize_ref(x),
             lambda: _quant_library(x), n * (in_b + 1) + n // QBLOCK * 4),):
        rec.update(_quant_times(fn, plain, lib, nbytes, n))
    bwd = []
    for out_dtype in (torch.bfloat16, torch.float32):
        d = dequantize(q, s, out_dtype=out_dtype)
        rd = dequantize_ref(q, s, out_dtype)
        e2, u2, ok2 = bitwise((d,), (rd,))
        fd = dequantize_ref(q, torch.roll(s, 1), out_dtype)
        fe, fu, fok = bitwise((d,), (fd,))
        rec = {"case": f"{case} -> {str(out_dtype).split('.')[-1]}",
               "max_abs_err": e2, "tol_used": u2, "ok": ok2, "controls": [
                   {"fault": "each block scaled by its neighbour's scale",
                    "max_abs_err": fe, "tol_used": fu, "caught": not fok}]}
        out_b = d.element_size()
        rec.update(_quant_times(
            lambda: dequantize(q, s, out_dtype=out_dtype),
            lambda: dequantize_ref(q, s, out_dtype),
            lambda: _dequant_library(q, s, out_dtype),
            n * (1 + out_b) + n // QBLOCK * 4, n))
        bwd.append(rec)
    return fwd, bwd


def _quant_times(fn, plain, lib, nbytes, n):
    b_ms, b_by = bound(nbytes, 4 * n, "fp32")
    return {"ms": time_ms(fn), "host_ms": host_ms(fn),
            "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
            "library_covers": "the nearest PyTorch composition (no one "
                              "call quantizes blockwise), the same ops as "
                              "the plain version",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


QUANT_CASES = [dict(kind="gradient", n=BUCKET_SHARD, dtype="bfloat16"),
               dict(kind="gradient", n=BUCKET_SHARD, dtype="float32"),
               dict(kind="gradient", n=WEAK_PAYLOAD, dtype="bfloat16",
                    pad_to=2 * QBLOCK),
               dict(kind="zeros", n=QBLOCK * 4096, dtype="float32"),
               dict(kind="boundary", n=QBLOCK * 4096, dtype="float32")]


def quant_phase(dev):
    """Both quant_comm kernels at the int8 weak phase's shapes: one
    bucket's weak shard (bf16, as the path quantizes it, and fp32), the
    whole per-rank weak payload padded as the wire pads it, blocks of
    zeros and values on code boundaries; then a length only the
    wrapper's padding takes (``int8_roundtrip``)."""
    import torch
    from repro_torch.core.compression import int8_roundtrip
    cases = {"quantize": [], "dequantize": []}
    for kw in QUANT_CASES:
        kw = dict(kw, dtype=getattr(torch, kw["dtype"]))
        fwd, bwd = check_quant(dev, **kw)
        cases["quantize"].append(fwd)
        cases["dequantize"] += bwd
        torch.cuda.empty_cache()
    x = quant_inputs(dev, "gradient", 1_000_003, torch.float32)
    err, used, ok = bitwise((int8_roundtrip(x),),
                            (int8_roundtrip(x, impl="ref"),))
    cases["quantize"].append({"case": "int8_roundtrip n=1000003 -> "
                              "1000192 by the wrapper", "max_abs_err": err,
                              "tol_used": used, "ok": ok, "controls": []})
    return cases


# ------------------- HaiScale DDP: gpt2-medium, 8 ranks ---------------------

# gpt2-medium (the paper's own HaiScale DDP model, Fig. 8) at full width
# and depth trains as 8 ranks sharing the card: 2 pods x 4 data, each
# rank a batch of 2 x 1024 tokens (global 16 x 1024), collectives staged
# through pinned host memory over gloo (HFReduce's own path)
DDP_ARCH = "gpt2-medium"
DDP_PODS, DDP_DATA = 2, 4
DDP_BATCH, DDP_SEQ, DDP_STEPS = 2, 1024, 8
DDP_WIRES = ("", "bf16", "fp8", "int8")
# gate (i), the synced uncompressed gradient against one process on the
# global batch: the training gates above (both sides bf16; the synced one
# adds 8 ranks' bf16 gradients in bf16 on the host)
DDP_FAULTS = {
    # fault -> the gate that must catch it
    "prescale dropped": "i",
    "one strong rank's shard left out of phase 3": "i",
    "a bucket's hook fires one leaf early": "ii",
}


def ddp_global_batch(cfg, i):
    from repro_torch.data.synthetic import batch_for_model
    return batch_for_model(cfg, "train", i, DDP_BATCH * DDP_PODS * DDP_DATA,
                           DDP_SEQ, seed=SEED)


def _early_hook_step():
    """A ``DDPStep`` whose first bucket starts its sync one leaf early:
    the bucket's last leaf has no gradient yet when the bucket is
    flattened, so it goes on the wire as zeros (what ``_flatten`` sends
    for a leaf without a gradient)."""
    from repro_torch.core.ddp import DDPStep

    class EarlyHookStep(DDPStep):
        def _flatten(self, leaves, b):
            if b == 0:
                i1 = self.ranges[0][1]
                leaves = leaves[:i1 - 1] + [leaves[i1 - 1].detach()] + \
                    leaves[i1:]
            return super()._flatten(leaves, b)
    return EarlyHookStep


def _ddp_fault(fault, grid):
    """(module, attribute, replacement) that plants ``fault`` in this
    rank's DDP path; the early hook is a subclass of the step
    (``_early_hook_step``), not a replacement."""
    import importlib
    ddp = importlib.import_module("repro_torch.core.ddp")
    # the module: the package's attribute of that name is the function
    hfreduce = importlib.import_module("repro_torch.core.hfreduce")
    if fault == "prescale dropped":
        orig = ddp.hfreduce
        return ddp, "hfreduce", lambda x, **kw: orig(x, **{**kw,
                                                          "prescale": None})
    orig = hfreduce.all_gather

    def gather(x, group):
        out = orig(x, group)
        if group is grid.strong:
            out[x.shape[0]:2 * x.shape[0]] = 0
        return out
    return hfreduce, "all_gather", gather


def _same_bits(a, b):
    import torch
    from repro_torch.models.params import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _rel_leaves(got, ref):
    """Per leaf |g - ref| / |ref| (Frobenius); ``ref`` leaves on the
    host."""
    from repro_torch.models.params import tree_leaves
    out = []
    for g, r in zip(tree_leaves(got), ref):
        r = r.to(g.device).float()
        out.append(float((g.float() - r).norm() / r.norm().clamp(min=1e-30)))
    return out


def _int8_bound(grid, flats):
    """Gate (iv) on this rank's weak shards of every bucket (``flats``:
    the buckets of the real local gradient on the bf16 wire): the int8
    weak phase against the uncompressed one on the same prescaled shard,
    element by element within 1/2 (s_pod0 + s_pod1 + s_requant)
    (1 + 2^-8) + one bf16 ulp, where s_pod is each pod's 256-block scale
    (absmax fl(1/127)) of the int8 wire's padded shard and s_requant the
    reduced block's (max |out| / 127): half a code for each
    quantization, half a bf16 ulp for each side's final rounding.  Also
    times ``hfreduce`` over the whole gradient with each wire format
    (run c) and returns each one's relative distance to the
    uncompressed sync."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.compression import int8_psum, make_weak_psum
    from repro_torch.core.grid import all_gather, all_reduce, reduce_scatter
    from repro_torch.core.hfreduce import _pad_to, hfreduce
    from repro_torch.telemetry import now
    P, inv = grid.pods, torch.tensor(1.0 / grid.size, dtype=torch.bfloat16)
    worst, n_el = 0.0, 0
    for flat in flats:
        shard = reduce_scatter(_pad_to(flat, grid.data)[0], grid.strong) * inv
        m = shard.shape[0]
        pad = (-m) % (P * QBLOCK)

        def blocks(v):
            return F.pad(v.float(), (0, pad)).reshape(-1, QBLOCK)
        u = blocks(all_reduce(shard, grid.weak))
        o = blocks(int8_psum(shard, grid.weak))
        X = F.pad(all_gather(shard, grid.weak).reshape(P, -1).float(),
                  (0, pad)).reshape(P, -1, QBLOCK)
        s_pods = (X.abs().amax(-1) * torch.tensor(1 / 127)).sum(0)
        del X
        half = 0.5 * (s_pods + o.abs().amax(-1) / 127) * (1 + 2 ** -8)
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
            o.abs(), u.abs()).clamp(min=1e-30))) - 7)
        worst = max(worst, float(((o - u).abs() / (half[:, None] + ulp))
                                 .max()))
        n_el += m
        del u, o, ulp
    times, ref, sq = {}, None, {}
    for wire in DDP_WIRES:
        psum = make_weak_psum(wire)
        torch.cuda.synchronize()
        t0 = now()
        outs = [hfreduce(f, strong=grid.strong, weak=grid.weak,
                         weak_psum=psum, prescale=1.0 / grid.size)
                for f in flats]
        torch.cuda.synchronize()
        times[wire] = now() - t0
        if ref is None:
            ref = outs
        sq[wire] = sum(float((o.float() - r.float()).square().sum())
                       for o, r in zip(outs, ref))
        del outs
    norm = sum(float(r.float().square().sum()) for r in ref)
    return {"bound_used_max": worst, "ok": worst <= 1.0,
            "weak_elements": n_el, "hfreduce_s": times,
            "rel_to_uncompressed": {w: math.sqrt(v / norm)
                                    for w, v in sq.items()}}


def ddp_rank(grid, device, ref_path):
    """One rank of the DDP phase: the gates on step 1's synced gradient,
    then DDP_STEPS training steps with each of "" and "int8" (overlap
    on), then one step with overlap off.  Returns numbers only; rank 0
    also holds gate (i) against the one-process reference in
    ``ref_path``."""
    import statistics

    import torch
    from repro_torch import train_lib
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import bucketing
    from repro_torch.core import ddp as ddp_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.telemetry import get_registry, now
    dev = torch.device(device)
    cfg = get_arch(DDP_ARCH)
    model = build_model(cfg)
    ref = torch.load(ref_path) if grid.rank == 0 else None
    b0 = ddp_global_batch(cfg, 0)

    def opt():
        return AdamW(lr=warmup_cosine(3e-4, 2, DDP_STEPS))

    def step_of(compress, overlap=True, impl="auto"):
        return ddp_mod.make_ddp_train_step(
            model, opt(), grid, ParallelPlan(mode="ddp", compress=compress,
                                             overlap=overlap),
            device=dev, quant_impl=impl)

    def spans():
        reg = get_registry()
        return {k: reg.histogram(f"span.{k}").sum
                for k in ("ddp.sync", "ddp.wait", "train.step")}

    out = {"rank": grid.rank, "runs": {}}
    for compress in ("", "int8"):
        params = model.init(SEED, device=dev, dtype="bfloat16")
        on = step_of(compress)
        loss_on, _, g_on = on.loss_and_grads(params, b0)
        loss_off, _, g_off = step_of(compress, overlap=False).loss_and_grads(
            params, b0)
        run = {"buckets": len(on.ranges), "loss_step1": float(loss_on),
               "gate_ii": {"grads_bitwise": _same_bits(g_on, g_off),
                           "loss_bitwise": bool(loss_on == loss_off)}}
        del g_off
        if compress == "int8":
            _, _, g_ref = step_of(compress, impl="ref").loss_and_grads(
                params, b0)
            run["gate_iii"] = {"grads_bitwise": _same_bits(g_on, g_ref)}
            del g_ref, g_on
            _, _, local = train_lib.loss_and_grads(
                model, params, {k: torch.as_tensor(v[grid.rows(len(v))],
                                                   device=dev)
                                for k, v in b0.items()})
            leaves = tree_leaves(local)
            del local
            flats = [bucketing.flatten_leaves(leaves[i0:i1],
                                              on.bucket_plan.wire_dtype)
                     for i0, i1 in on.ranges]
            del leaves
            run["gate_iv"] = _int8_bound(grid, flats)
            del flats
        else:
            if ref is not None:
                run["gate_i"] = {"loss_rel": abs(float(loss_on) - ref["loss"])
                                 / abs(ref["loss"]),
                                 "grad_rel": _rel_leaves(g_on, ref["grads"])}
            faults = {}
            for fault, gate in DDP_FAULTS.items():
                if gate == "ii":
                    step = _early_hook_step()(
                        model, opt(), grid,
                        ParallelPlan(mode="ddp", compress=compress), dev)
                    _, _, fg = step.loss_and_grads(params, b0)
                else:
                    mod, attr, repl = _ddp_fault(fault, grid)
                    orig = getattr(mod, attr)
                    setattr(mod, attr, repl)
                    try:
                        _, _, fg = step_of(compress).loss_and_grads(params,
                                                                    b0)
                    finally:
                        setattr(mod, attr, orig)
                rec = {"gate": gate}
                if gate == "ii":
                    rec["grads_bitwise"] = _same_bits(fg, g_on)
                elif ref is not None:
                    rec["grad_rel"] = _rel_leaves(fg, ref["grads"])
                faults[fault] = rec
                del fg
            run["faults"] = faults
            del g_on
        torch.cuda.empty_cache()

        # training through the port's entry point (what launch/train.py
        # runs); counters and spans zeroed just before the steps
        o = opt()
        plan = ParallelPlan(mode="ddp", compress=compress)
        state = init_state(plan, o, params, grid=grid)
        del params
        step = make_train_step(plan, model, o, device=dev, grid=grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        get_registry().reset()
        reset_launch_counts()
        losses, times = [], []
        for i in range(DDP_STEPS):
            batch = ddp_global_batch(cfg, i)
            torch.cuda.synchronize()
            t0 = now()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(now() - t0)
        counts = launch_counts()
        run.update({"losses": losses, "step_s": times,
                    "train_step_spans":
                        get_registry().histogram("span.train.step").count,
                    "median_step_s": statistics.median(times),
                    "spans_s": spans(), "launches": counts,
                    "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        # one more step with overlap off: every bucket's sync exposed
        off = make_train_step(
            ParallelPlan(mode="ddp", compress=compress, overlap=False),
            model, o, device=dev, grid=grid)
        get_registry().reset()
        torch.cuda.synchronize()
        t0 = now()
        state, m = off(state, ddp_global_batch(cfg, DDP_STEPS))
        float(m["loss"])
        run["no_overlap"] = {"step_s": now() - t0, "spans_s": spans()}
        out["runs"][compress or "uncompressed"] = run
        del state, step, off
        torch.cuda.empty_cache()
    return out


def ddp_phase(dev):
    """gpt2-medium at full width and depth trains with HaiScale DDP as
    DDP_PODS x DDP_DATA ranks sharing the card (``run_ranks``, gloo,
    host-staged).  First the parent takes the loss and gradient of one
    process on the whole global batch of step 1 (then frees it), the
    reference of gate (i); every rank then runs ``ddp_rank``.  Gates:
    (i) the synced uncompressed gradient within TRAIN_GRAD_REL_TOL per
    leaf and the loss within TRAIN_LOSS_REL_TOL; (ii) overlap on = off,
    gradients and loss bitwise, for "" and "int8"; (iii) the int8 sync
    through the kernels = through the plain versions, bitwise; (iv) int8
    against uncompressed within the quantization bound
    (``_int8_bound``); (v) the planted faults of DDP_FAULTS fail their
    gate.  Returns (results, failures)."""
    import statistics

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.testing.multidev import run_ranks
    from repro_torch.train_lib import loss_and_grads
    cfg = get_arch(DDP_ARCH)
    model = build_model(cfg)
    params = model.init(SEED, device=dev, dtype="bfloat16")
    n_params = sum(p.numel() for p in tree_leaves(params))
    b0 = {k: torch.as_tensor(v, device=dev)
          for k, v in ddp_global_batch(cfg, 0).items()}
    loss, _, grads = loss_and_grads(model, params, b0)
    ref_dir = ROOT / "build" / "ddp_phase"
    ref_dir.mkdir(parents=True, exist_ok=True)
    ref_path = ref_dir / "reference.pt"
    torch.save({"loss": float(loss),
                "grads": [g.cpu() for g in tree_leaves(grads)]}, ref_path)
    names = _leaf_names(params)
    del params, grads, b0, loss
    torch.cuda.empty_cache()

    ranks = run_ranks(ddp_rank, DDP_PODS, DDP_DATA, device=str(dev),
                      stage="host", args=(str(ref_path),), timeout=600)
    ref_path.unlink()
    r0 = ranks[0][0]
    failures = []
    world = DDP_PODS * DDP_DATA
    tokens = world * DDP_BATCH * DDP_SEQ
    flops = 6 * n_params * tokens + 12 * cfg.n_layers * cfg.n_heads * \
        cfg.head_dim * world * DDP_BATCH * causal_pairs(DDP_SEQ, DDP_SEQ, 0,
                                                         DDP_SEQ)
    out = {"arch": DDP_ARCH, "params": n_params, "pods": DDP_PODS,
           "data": DDP_DATA, "batch_per_rank": DDP_BATCH, "seq": DDP_SEQ,
           "steps": DDP_STEPS, "model_flops_per_step": flops, "runs": {}}
    for key, run in r0["runs"].items():
        all_runs = [r["runs"][key] for r, _ in ranks]
        med = statistics.median(run["step_s"])
        gi = run.get("gate_i")
        summary = {
            "buckets": run["buckets"], "losses": run["losses"],
            "median_step_s": med, "tokens_per_s": tokens / med,
            "mfu_vs_bf16_dense_peak": flops / med / PEAK["bf16_tensor"],
            "peak_mem_gb_per_rank": max(r["peak_mem_gb"] for r in all_runs),
            "rank0_sync_s_per_step": run["spans_s"]["ddp.sync"] / DDP_STEPS,
            "rank0_exposed_wait_s_per_step":
                run["spans_s"]["ddp.wait"] / DDP_STEPS,
            "rank0_train_step_spans": run["train_step_spans"],
            "no_overlap": run["no_overlap"],
            "launches_per_step": {
                k: sum(r["launches"][k] for r in all_runs) / DDP_STEPS
                for k in ("quantize", "dequantize", "flash_attention",
                          "flash_attention_bwd_dkv",
                          "flash_attention_bwd_dq")},
            "launches": {k: sum(r["launches"][k] for r in all_runs)
                         for k in run["launches"]},
            "gate_ii": run["gate_ii"]}
        if not all(math.isfinite(x) for x in run["losses"]):
            failures.append(f"ddp {key}: losses not finite")
        for r in all_runs:
            if r["train_step_spans"] != DDP_STEPS:
                failures.append(f"ddp {key}: {r['train_step_spans']} of "
                                f"{DDP_STEPS} steps ran through "
                                "parallel.make_train_step")
            if not all(r["gate_ii"].values()):
                failures.append(f"ddp {key}: overlap on and off differ "
                                f"(gate ii): {r['gate_ii']}")
        if gi is not None:
            worst = max(range(len(gi["grad_rel"])),
                        key=lambda i: gi["grad_rel"][i])
            summary["gate_i"] = {
                "loss_rel": gi["loss_rel"],
                "grad_rel_max": gi["grad_rel"][worst],
                "grad_rel_max_leaf": names[worst],
                "ok": gi["loss_rel"] <= TRAIN_LOSS_REL_TOL and
                max(gi["grad_rel"]) <= TRAIN_GRAD_REL_TOL}
            if not summary["gate_i"]["ok"]:
                failures.append(f"ddp: synced gradient vs one process "
                                f"(gate i): {summary['gate_i']}")
            ctl = []
            for fault, rec in run["faults"].items():
                row = {"fault": fault, "gate": rec["gate"]}
                if rec["gate"] == "ii":
                    row["caught"] = not rec["grads_bitwise"]
                else:
                    row["grad_rel_max"] = max(rec["grad_rel"])
                    row["caught"] = row["grad_rel_max"] > TRAIN_GRAD_REL_TOL
                ctl.append(row)
                if not row["caught"]:
                    failures.append(f"ddp: planted fault '{fault}' passed "
                                    f"gate ({rec['gate']})")
            summary["controls"] = ctl
        if "gate_iii" in run:
            summary["gate_iii"] = run["gate_iii"]
            summary["gate_iv"] = {
                "bound_used_max": max(r["gate_iv"]["bound_used_max"]
                                      for r in all_runs),
                "hfreduce_s_rank0": run["gate_iv"]["hfreduce_s"],
                "rel_to_uncompressed": run["gate_iv"]["rel_to_uncompressed"]}
            for r in all_runs:
                if not r["gate_iii"]["grads_bitwise"]:
                    failures.append("ddp int8: kernels and plain versions "
                                    "differ (gate iii)")
                if not r["gate_iv"]["ok"]:
                    failures.append(f"ddp int8: outside the quantization "
                                    f"bound (gate iv): {r['gate_iv']}")
            for k in ("quantize", "dequantize"):
                if summary["launches"][k] <= 0:
                    failures.append(f"ddp int8: kernel {k} never launched "
                                    "on the DDP path")
        for k in ("flash_attention", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq"):
            if summary["launches"][k] <= 0:
                failures.append(f"ddp {key}: kernel {k} never launched")
        out["runs"][key] = summary
        print(json.dumps({"ddp_run": key, **summary}), flush=True)
    return out, failures


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


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
        for fn, line in ptxas_lines(log):
            print(f"ptxas {name} {fn}: {line}", flush=True)
    if "flash_attention_bwd" in build.build_logs:
        failures += [f"flash_attention_bwd {fn}: ptxas spills: {line}"
                     for fn, line in
                     spills(build.build_logs["flash_attention_bwd"])]
    else:
        print("ptxas flash_attention_bwd: library from the build cache, its "
              "ptxas lines (spills) not read in this run", flush=True)
    hgmma = sass_count("flash_attention_bwd", "HGMMA")
    print(json.dumps({"sass": "flash_attention_bwd", "HGMMA": hgmma}),
          flush=True)
    if hgmma == 0:
        failures.append("flash_attention_bwd: no HGMMA (wgmma) instruction "
                        "in its SASS")

    def timed(name, fn):
        t = now()
        out = fn()
        print(json.dumps({"phase": name, "seconds": now() - t}), flush=True)
        return out

    cases = {}
    for name, phase in (("kernels", kernel_phase),
                        ("backward kernels", backward_kernel_phase),
                        ("gating kernels", gating_phase),
                        ("ssd kernels", ssd_phase),
                        ("quant kernels", quant_phase)):
        cases.update(timed(name, lambda: phase(dev)))
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

    e2e = timed("phi4 serving", lambda: e2e_phase(dev))
    for c in e2e["vs_plain"]:
        if not c["ok"]:
            failures.append(f"e2e kernel vs plain: {c}")
    torch.cuda.empty_cache()
    train, train_failures = timed("phi4 training", lambda: train_phase(dev))
    print(json.dumps({"train": train}), flush=True)
    failures += train_failures
    torch.cuda.empty_cache()
    moe_e2e, moe_failures = timed("moe serving",
                                  lambda: moe_serve_phase(dev))
    failures += moe_failures
    moe_train, moe_failures = timed("moe training",
                                    lambda: moe_train_phase(dev))
    print(json.dumps({"moe_train": moe_train}), flush=True)
    failures += moe_failures
    torch.cuda.empty_cache()
    hybrid_e2e, hybrid_failures = timed("hybrid serving",
                                        lambda: hybrid_serve_phase(dev))
    failures += hybrid_failures
    hybrid_train, hybrid_failures = timed("hybrid training",
                                          lambda: hybrid_train_phase(dev))
    print(json.dumps({"hybrid_train": hybrid_train}), flush=True)
    failures += hybrid_failures
    torch.cuda.empty_cache()
    ddp, ddp_failures = timed("ddp training", lambda: ddp_phase(dev))
    failures += ddp_failures

    # representative main-path case of each kernel: the decode tick for
    # rmsnorm (8 slots), paged attention (T = 1, bs 16, bf16) and top-k
    # gating (8 x 60, top-4), a 512-token fresh prefill for flash
    # attention, the training step (4096 x 3072 rows, b 2 x 2048 causal,
    # 4096 x 60 gating, zamba2's b 2 x 2048 SSD scan) for the backward
    # kernels and the SSD forward.  launches: per run of each path that
    # ran the kernel, counters zeroed before the run and read after
    summary = []
    for name in KERNEL_META:
        r = cases[name][0]
        route, source, replaces = KERNEL_META[name]
        runs, per_step = {}, {}
        for arch, serve, kernels in (
                (ARCH, e2e, DENSE_SERVING_KERNELS),
                (MOE_ARCH, moe_e2e, SERVING_KERNELS),
                (HYBRID_ARCH, hybrid_e2e, HYBRID_SERVING_KERNELS)):
            if name not in kernels:
                continue
            for run in serve["runs"]:
                key = f"{arch} serve prefill_chunk={run['prefill_chunk']}"
                runs[key] = run["launches"][name]
                per_step[f"{key} (per engine step)"] = \
                    run["launches_per_step"][name]
        for arch, tr, kernels in (
                (ARCH, train, TRAIN_KERNELS),
                (MOE_ARCH, moe_train, MOE_TRAIN_KERNELS),
                (HYBRID_ARCH, hybrid_train, HYBRID_TRAIN_KERNELS)):
            if name in kernels:
                runs[f"{arch} train {TRAIN_STEPS} steps"] = \
                    tr["launches"][name]
                per_step[f"{arch} train (per step)"] = \
                    tr["launches_per_step"][name]
        for key, run in ddp["runs"].items():
            if run["launches"].get(name, 0):
                label = f"{DDP_ARCH} ddp {key} {DDP_STEPS} steps, " \
                        f"{DDP_PODS * DDP_DATA} ranks"
                runs[label] = run["launches"][name]
                per_step[f"{label} (per step)"] = \
                    run["launches"][name] / DDP_STEPS
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
    for label, tr in (("train_summary", train),
                      ("moe_train_summary", moe_train),
                      ("hybrid_train_summary", hybrid_train)):
        print(json.dumps({label: {
            k: tr[k] for k in ("median_step_s", "tokens_per_s",
                               "mfu_vs_bf16_dense_peak", "peak_mem_gb",
                               "losses", "launches_per_step")}}),
            flush=True)
    print(json.dumps({"ddp_summary": ddp}), flush=True)
    for label, serve in (("moe_serve_summary", moe_e2e),
                         ("hybrid_serve_summary", hybrid_e2e)):
        print(json.dumps({label: {
            "peak_mem_gb": serve["peak_mem_gb"],
            "device_busy_share": serve["profile"]["device_busy_share"],
            "runs": [{k: run[k] for k in (
                "prefill_chunk", "seconds", "tokens_per_s", "ttft_p50_s",
                "ttft_p95_s", "tpot_p50_s", "tpot_p95_s", "engine_steps",
                "launches")} for run in serve["runs"]]}}), flush=True)
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
