"""ctypes binding of the CUDA paged chunk-attention kernel
(``csrc/paged_chunk_attention.cu``; the source's header says which TPU
kernel it replaces, what bounds it and how).

The wrapper checks what the kernel cannot take and raises, picks the
split of the key axis (``split_plan``, from shapes alone), allocates the
output and, when the keys are split, the splits' workspace, launches on
PyTorch's current stream, raises on a launch error and counts the
launch.  Queries are read in the model's (b, T, h, d) layout through
their strides; the GQA row packing (row t * group + g is head
kv * group + g of token t) happens inside the kernel, so no packed copy
of q is made and no row padding exists.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import check_attn_tensor
from repro_torch.telemetry import get_registry

LAUNCHES = get_registry().counter("kernel.paged_chunk_attention.launches")
KV_KINDS = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.int8: 2}
KEY_TILE = 64            # keys of the kernel's streamed K / V tiles
ROW_TILE = 64            # query rows of one warpgroup
# blocks the split aims for, per SM: one-warpgroup blocks (rows <= 64;
# two run on an SM, so two waves) and two-warpgroup blocks (one an SM,
# with a deeper ring: one wave)
SPLIT_BLOCKS_PER_SM = 4
SPLIT_BLOCKS_PER_SM_WIDE = 1
MIN_SPLIT_TILES = 2      # key tiles a split takes at least
MAX_PAGES = 512          # page-table entries a split may span (the kernel's)
_FN: dict = {}


def split_plan(cap, bs, b, kvh, rows, sms):
    """(n_split, split_keys): the key axis [0, cap) of every (row tile,
    kv head, sequence) item cut into n_split ranges of split_keys keys, a
    multiple of KEY_TILE (the last range may be shorter).  A row tile is
    one warpgroup's 64 rows, or two warpgroups' 128 when the rows exceed
    64 (the kernel's choice).

    From shapes alone, never from positions (no device-to-host read, so
    a launch can be captured in a CUDA graph): about SPLIT_BLOCKS_PER_SM
    (_WIDE) blocks on every SM, at least MIN_SPLIT_TILES tiles a split
    (each split writes its rows' fp32 partials, which the combine reads
    back), and no more pages a split than the kernel's page table
    holds."""
    tiles = -(-cap // KEY_TILE)
    wide = rows > ROW_TILE
    items = -(-rows // (ROW_TILE * (2 if wide else 1))) * kvh * b
    per_sm = SPLIT_BLOCKS_PER_SM_WIDE if wide else SPLIT_BLOCKS_PER_SM
    n = min(-(-per_sm * sms // items), -(-tiles // MIN_SPLIT_TILES))
    per = -(-tiles // n)
    per = min(per, max(1, (MAX_PAGES - 2) * bs // KEY_TILE))
    return -(-tiles // per), per * KEY_TILE


def _fn():
    if "fwd" not in _FN:
        fn = build.load("paged_chunk_attention").paged_chunk_attention
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                       I, P, ctypes.c_float, P]
        fn.restype = I
        _FN["fwd"] = fn
    return _FN["fwd"]


def paged_chunk_attention_fwd(q, k_pool, v_pool, block_tables, positions,
                              k_scale=None, v_scale=None):
    """q (b, T, h, d) bf16; k/v_pool (n_blocks, bs, kvh, d) contiguous in
    bf16, float8_e4m3fn or int8; block_tables (b, nbmax) and positions
    (b, T) int32; k/v_scale (n_blocks, bs) fp32 or None (unit scales).
    Returns (b, T, h, d) bf16; rows at position < 0 are exact zeros."""
    b, T, h, d = q.shape
    nb, bs, kvh = k_pool.shape[:3]
    dev = q.device
    check_attn_tensor("q", q, dev)
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if pool.device != dev or not pool.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if pool.dtype not in KV_KINDS:
            raise ValueError(f"{name}: unsupported dtype {pool.dtype}")
    if (v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype
            or k_pool.shape[3] != d or h % kvh):
        raise ValueError(f"paged_chunk_attention_fwd: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    scales = []
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc is not None and (sc.dtype != torch.float32 or sc.device != dev
                               or sc.shape != (nb, bs)
                               or not sc.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 (n_blocks, bs)"
                             f" on {dev}")
        scales.append(None if sc is None else sc.data_ptr())
    tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    if pos.shape != (b, T) or tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"positions {tuple(pos.shape)} / tables "
                         f"{tuple(tables.shape)} do not match q")
    o = torch.empty((b, T, h, d), dtype=q.dtype, device=dev)
    rows = T * (h // kvh)
    n_split, split_keys = split_plan(tables.shape[1] * bs, bs, b, kvh, rows,
                                     build.sm_count(dev))
    part = None
    if n_split > 1:     # each split's O (fp32) and (m, l) for the combine
        part = torch.empty(n_split * b * kvh * rows * (d + 2),
                           dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 6)(*q.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    scales[0], scales[1], tables.data_ptr(), pos.data_ptr(),
                    o.data_ptr(), None if part is None else part.data_ptr(),
                    b, T, h, kvh, d, bs, tables.shape[1],
                    KV_KINDS[k_pool.dtype], n_split, split_keys,
                    ctypes.cast(strides, ctypes.c_void_p), d ** -0.5,
                    stream)
    build.check(err, "paged_chunk_attention")
    LAUNCHES.inc()
    return o
