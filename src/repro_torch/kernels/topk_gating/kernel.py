"""ctypes bindings of the CUDA top-k gating kernels, forward and backward
(``csrc/topk_gating.cu``; the source's header says which TPU kernels they
replace, what bounds them and how).

Each wrapper checks what its kernel cannot take and raises: logits
(T, E) contiguous fp32 or bf16 on one CUDA device, E <= 128,
1 <= k <= min(E, 16); the backward's experts (T, k) int32 and dw (T, k)
fp32, contiguous, on the logits' device (nothing is converted).  It
allocates the output, launches on PyTorch's current stream, raises on a
launch error and counts the launch.  Rows need no padding; T = 0
launches nothing.  Both kernels take their grid and lane groups from
``gating_plan`` (pure Python, cached), and their wrappers do per call
only what the launch needs: one ctypes call with a descriptor built once
a shape (``_fwd_config``, ``_bwd_config``) through ``build.launch`` (no
device context unless the tensor is on another device than the current
one).
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
# both kernels: FWD_THREADS-thread blocks, each lane holding
# FWD_SLOTS[lanes][i] logits, the fewer that cover E
# (csrc/topk_gating.cu: the instantiated pairs); the forward gives a row a
# group of 32 lanes where there are at most FWD_WIDE_ROWS_PER_SM rows an
# SM, else of 16 (its k argmax rounds each take log2(lanes) shuffle
# steps), the backward always 32 (no rounds: the fewer slots a lane, the
# shorter its chain; chip_smoke.py times it under the forward's layout
# beside its own in every gating case)
FWD_THREADS, FWD_WIDE_ROWS_PER_SM = 256, 8
FWD_SLOTS = {32: (2, 4), 16: (4, 8)}
BWD_LANES = 32
H100_SMS = 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # logits w experts, config, stream
    "topk_gating_fwd": [_P, _P, _P, _P, _P],
    # logits experts dw dlogits, config, stream
    "topk_gating_bwd": [_P, _P, _P, _P, _P, _P],
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
    """A gating kernel's grid for (T, E): a group of ``lanes`` lanes a
    row, lane j holding experts j, j + lanes, ... in ``slots`` registers
    (slots past E hold nothing), ``rows_per_block`` rows in each of
    ``blocks`` blocks of FWD_THREADS threads; row r is group
    r % rows_per_block of block r // rows_per_block."""
    lanes: int
    slots: int
    rows_per_block: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def gating_plan(T, E, sms=H100_SMS, backward=False):
    """The lane groups and grid for T rows of E logits, from the shape
    and the SM count alone.  The forward: 32 lanes a row while T is at
    most FWD_WIDE_ROWS_PER_SM rows an SM (the shortest chain a row), else
    16 (fewer shuffle steps a round, more rows a warp).  The backward
    (``backward``): BWD_LANES, so that pick j of k <= MAX_K lives in lane
    j."""
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"topk_gating kernel takes 1 <= E <= "
                         f"{MAX_EXPERTS}; got E={E}")
    if backward:
        lanes = BWD_LANES
    else:
        lanes = 32 if T <= FWD_WIDE_ROWS_PER_SM * sms else 16
    slots = next(s for s in FWD_SLOTS[lanes] if lanes * s >= E)
    per = FWD_THREADS // lanes
    return GatingPlan(lanes, slots, per, -(-T // per))


class _Config(ctypes.Structure):
    """csrc/topk_gating.cu:Config, a launch's shape and grid."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "rows", "E", "k", "renorm", "dtype", "lanes", "slots", "blocks")]


def _descriptor(plan, T, E, k, renorm, dtype):
    """(address, descriptor): the cache that keeps the address keeps the
    descriptor alive with it."""
    cfg = _Config(T, E, k, int(bool(renorm)), dtype, plan.lanes, plan.slots,
                  plan.blocks)
    return ctypes.addressof(cfg), cfg


@functools.lru_cache(maxsize=1024)
def _fwd_config(T, E, k, renorm, dtype, sms):
    """The forward's launch descriptor for this shape, built once (a
    ctypes call pays for each argument it converts)."""
    return _descriptor(gating_plan(T, E, sms), T, E, k, renorm, dtype)


@functools.lru_cache(maxsize=1024)
def _bwd_config(T, E, k, renorm, dtype):
    """The backward's launch descriptor for this shape, built once."""
    return _descriptor(gating_plan(T, E, backward=True), T, E, k, renorm,
                       dtype)


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
    experts (T, k) int32 and the weights' cotangent ``dw`` (T, k) fp32."""
    _check(logits, k)
    T, E = logits.shape
    dev = logits.device
    if (experts.dtype != torch.int32 or dw.dtype != torch.float32
            or experts.shape != (T, k) or dw.shape != (T, k)
            or not (experts.is_contiguous() and dw.is_contiguous())
            or experts.device != dev or dw.device != dev):
        raise ValueError(
            f"experts and dw must be contiguous ({T}, {k}) int32 and fp32 "
            f"on {dev}, got {tuple(experts.shape)} {experts.dtype} on "
            f"{experts.device} and {tuple(dw.shape)} {dw.dtype} on "
            f"{dw.device}")
    dlogits = torch.empty_like(logits)
    if T == 0:
        return dlogits
    config = _bwd_config(T, E, k, renorm, _DTYPES[logits.dtype])[0]
    err = build.launch(_fn("topk_gating_bwd"), dev.index, logits.data_ptr(),
                       experts.data_ptr(), dw.data_ptr(), dlogits.data_ptr(),
                       config)
    build.check(err, "topk_gating_bwd")
    LAUNCHES_BWD.inc()
    return dlogits
