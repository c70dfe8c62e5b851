"""ctypes bindings of the CUDA top-k gating kernels, forward and backward
(``csrc/topk_gating.cu``; the source's header says which TPU kernels they
replace, what bounds them and how).

Each wrapper checks what its kernel cannot take and raises: logits
(T, E) contiguous fp32 or bf16 on one CUDA device, E <= 128,
1 <= k <= min(E, 16).  It allocates the outputs, launches on PyTorch's
current stream, raises on a launch error and counts the launch.  Rows
need no padding; T = 0 launches nothing.  The forward's grid and lane
groups come from ``gating_plan`` (pure Python, cached), and its wrapper
does per call only what the launch needs (``build.launch``: no device
context unless the tensor is on another device than the current one).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.topk_gating.launches")
LAUNCHES_BWD = get_registry().counter("kernel.topk_gating_bwd.launches")
MAX_EXPERTS, MAX_K = 128, 16
# the forward: FWD_THREADS-thread blocks, a group of 32 lanes a row where
# there are at most FWD_WIDE_ROWS_PER_SM rows an SM, else of 16, each lane
# holding FWD_SLOTS[lanes][i] logits, the fewer that cover E
# (csrc/topk_gating.cu: the instantiated pairs)
FWD_THREADS, FWD_WIDE_ROWS_PER_SM = 256, 8
FWD_SLOTS = {32: (2, 4), 16: (4, 8)}
H100_SMS = 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # logits w experts, config, stream
    "topk_gating_fwd": [_P, _P, _P, _P, _P],
    # logits experts dw dlogits, rows E k renorm dtype, stream
    "topk_gating_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _fn(name):
    if name not in _FN:
        fn = getattr(build.load("topk_gating"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _FN[name] = fn
    return _FN[name]


def _check(logits, k):
    if not logits.is_cuda:
        raise ValueError("logits must be a CUDA tensor")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError(f"logits must be contiguous (T, E), got "
                         f"{tuple(logits.shape)} strides {logits.stride()}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits must be float32 or bfloat16, got "
                         f"{logits.dtype}")
    E = logits.shape[1]
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"topk_gating kernel takes E <= {MAX_EXPERTS} and "
                         f"1 <= k <= min(E, {MAX_K}); got E={E}, k={k}")


class GatingPlan(NamedTuple):
    """The forward kernel's grid for (T, E): a group of ``lanes`` lanes a
    row, lane j holding experts j, j + lanes, ... in ``slots`` registers
    (slots past E hold -inf), ``rows_per_block`` rows in each of
    ``blocks`` blocks of FWD_THREADS threads; row r is group
    r % rows_per_block of block r // rows_per_block."""
    lanes: int
    slots: int
    rows_per_block: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def gating_plan(T, E, sms=H100_SMS):
    """The forward's lane groups and grid for T rows of E logits, from the
    shape and the SM count alone: 32 lanes a row while T is at most
    FWD_WIDE_ROWS_PER_SM rows an SM (the shortest chain a row), else 16
    (fewer shuffle steps a round, more rows a warp)."""
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"topk_gating kernel takes 1 <= E <= "
                         f"{MAX_EXPERTS}; got E={E}")
    lanes = 32 if T <= FWD_WIDE_ROWS_PER_SM * sms else 16
    slots = next(s for s in FWD_SLOTS[lanes] if lanes * s >= E)
    per = FWD_THREADS // lanes
    return GatingPlan(lanes, slots, per, -(-T // per))


class _FwdConfig(ctypes.Structure):
    """csrc/topk_gating.cu:FwdConfig, the forward's shape and grid."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "rows", "E", "k", "renorm", "dtype", "lanes", "slots", "blocks")]


@functools.lru_cache(maxsize=1024)
def _fwd_config(T, E, k, renorm, dtype, sms):
    """The address of the forward's launch descriptor for this shape,
    built once (a ctypes call pays for each argument it converts) and
    kept alive by the cache, with the descriptor itself."""
    plan = gating_plan(T, E, sms)
    cfg = _FwdConfig(T, E, k, int(bool(renorm)), dtype, plan.lanes,
                     plan.slots, plan.blocks)
    return ctypes.addressof(cfg), cfg


def topk_gating_fwd(logits, k: int, renorm=True):
    """logits (T, E) -> (weights (T, k) fp32, experts (T, k) int32)."""
    _check(logits, k)
    T, E = logits.shape
    dev = logits.device
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    experts = torch.empty((T, k), dtype=torch.int32, device=dev)
    if T == 0:
        return w, experts
    config = _fwd_config(T, E, k, renorm, _DTYPES[logits.dtype],
                         build.sm_count(dev))[0]
    err = build.launch(_fn("topk_gating_fwd"), dev.index, logits.data_ptr(),
                       w.data_ptr(), experts.data_ptr(), config)
    build.check(err, "topk_gating_fwd")
    LAUNCHES.inc()
    return w, experts


def topk_gating_bwd(logits, experts, dw, k: int, renorm=True):
    """dL/dlogits (T, E) in logits' dtype from the saved logits and
    experts (T, k) int32 and the weights' cotangent ``dw`` (T, k)."""
    _check(logits, k)
    T, E = logits.shape
    dev = logits.device
    experts = experts.to(dtype=torch.int32).contiguous()
    dw = dw.to(dtype=torch.float32).contiguous()
    for name, t in (("experts", experts), ("dw", dw)):
        if t.shape != (T, k) or t.device != dev:
            raise ValueError(f"{name} must be ({T}, {k}) on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    dlogits = torch.empty_like(logits)
    if T == 0:
        return dlogits
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("topk_gating_bwd")(
            logits.data_ptr(), experts.data_ptr(), dw.data_ptr(),
            dlogits.data_ptr(), T, E, k, int(bool(renorm)),
            _DTYPES[logits.dtype], stream)
    build.check(err, "topk_gating_bwd")
    LAUNCHES_BWD.inc()
    return dlogits
