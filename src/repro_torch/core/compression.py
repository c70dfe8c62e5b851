"""Gradient compression for the weak link (HFReduce phase 2 payload;
port of ``repro/core/compression.py``).

The paper's HFReduce reduces on the CPU in FP32/FP16/BF16/FP8 (§IV-D1):
the wire format is a first-class knob.  Each collective here takes a
``ProcessGroup`` (the weak group of a ``core.grid.Grid``) where the JAX
function takes an axis name:

  * ``bf16_psum``: cast -> all-reduce -> cast (2x fewer bytes than fp32).
  * ``fp8_psum``: float8_e4m3 wire format (4x fewer); payloads travel as
    e4m3 bytes viewed as uint8, ranks dequantize and sum in fp32
    locally, so no collective adds in fp8.  torch saturates an e4m3 cast
    at +-448 where JAX gives NaN: pre-scale means into the sum
    (``hfreduce(prescale=...)``) either way.
  * ``int8_psum``: blockwise-absmax int8; quantize -> all_to_all -> local
    dequantize and sum -> quantize -> all_gather, so payloads stay int8
    on the wire.  Quantize and dequantize go through
    ``kernels/quant_comm`` (the CUDA kernels on a CUDA tensor, their
    plain versions on a CPU tensor or with ``impl="ref"``).
  * error feedback (``ef_compress``, ``int8_roundtrip``).

``quantize_blockwise`` / ``dequantize_blockwise`` give the same bits as
the jitted JAX functions of the same name.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core.grid import all_gather, all_reduce, all_to_all
from repro_torch.kernels.quant_comm import dequantize, quantize

BLOCK = 256                               # the kernels' block, as in JAX
_WIRE = (torch.float32, torch.bfloat16)   # dtypes the kernels read / write


def quantize_blockwise(x, impl="auto"):
    """x (n,) float -> (q int8 (n,), scales fp32 (n / 256,));
    n % 256 == 0."""
    return quantize(x, impl=impl)


def dequantize_blockwise(q, scales, out_dtype=torch.float32, impl="auto"):
    return dequantize(q, scales, out_dtype=out_dtype, impl=impl)


def bf16_psum(x, group):
    """Cross-pod all-reduce with a bf16 wire format."""
    return all_reduce(x.to(torch.bfloat16), group).to(x.dtype)


def _padded(x, mult, keep=()):
    """x flat, zero-padded to a multiple of ``mult``, in fp32 unless its
    dtype is in ``keep``."""
    flat = x.reshape(-1)
    if flat.dtype not in keep:
        flat = flat.float()
    pad = (-flat.shape[0]) % mult
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _restore(out, pad, x):
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


def fp8_psum(x, group):
    """Cross-pod all-reduce with a float8_e4m3 wire format: split x into
    P chunks, cast to e4m3, all_to_all the bytes, dequantize and sum in
    fp32, requantize, all_gather, dequantize.  Wire bytes per rank:
    2 * |x| / 4."""
    P = dist.get_world_size(group)
    if P == 1:
        return x
    f8 = torch.float8_e4m3fn
    flat, pad = _padded(x, P)
    q = flat.to(f8).view(torch.uint8).reshape(P, -1)
    deq = all_to_all(q, group).view(f8).float()
    red = deq.sum(dim=0).to(f8).view(torch.uint8)
    out = all_gather(red, group).view(f8).float()
    return _restore(out, pad, x)


def int8_psum(x, group, impl="auto"):
    """Cross-pod all-reduce with an int8 wire format: split x into P
    chunks; quantize; all_to_all so rank i holds every rank's chunk i;
    dequantize the P chunks (one launch) and sum; requantize;
    all_gather the reduced chunks; dequantize (one launch, straight to
    x's dtype when that is fp32 or bf16, else to fp32).  Wire bytes per rank:
    2 * |x| / 4 + scales."""
    P = dist.get_world_size(group)
    if P == 1:
        return x
    # a bf16 shard is quantized as it is (the kernel reads bf16; the
    # values are those of its fp32 cast)
    flat, pad = _padded(x, P * BLOCK, keep=_WIRE)
    q, s = quantize_blockwise(flat, impl)
    qr = all_to_all(q.reshape(P, -1), group)
    sr = all_to_all(s.reshape(P, -1), group)
    red = dequantize_blockwise(qr.reshape(-1), sr.reshape(-1),
                               impl=impl).reshape(P, -1).sum(dim=0)
    q2, s2 = quantize_blockwise(red, impl)
    out = dequantize_blockwise(all_gather(q2, group), all_gather(s2, group),
                               out_dtype=flat.dtype, impl=impl)
    return _restore(out, pad, x)


def make_weak_psum(kind: str, impl="auto"):
    """The weak-phase collective for a wire format ("" / "fp32": None,
    the plain all-reduce); ``impl`` picks the int8 quantizer."""
    if kind in ("", "fp32", None):
        return None
    if kind == "bf16":
        return bf16_psum
    if kind == "fp8":
        return fp8_psum
    if kind == "int8":
        return functools.partial(int8_psum, impl=impl)
    raise ValueError(kind)


# --------------------------- error feedback --------------------------------


def ef_compress(x, residual, compress_fn):
    """Error feedback: y = compress(x + residual); residual' = x+r - y."""
    target = x + residual
    y = compress_fn(target)
    return y, target - y


def int8_roundtrip(x, impl="auto"):
    """Quantize + dequantize (the lossy part of int8_psum) for EF
    residuals."""
    flat, pad = _padded(x, BLOCK)
    q, s = quantize_blockwise(flat, impl)
    return _restore(dequantize_blockwise(q, s, impl=impl), pad, x)
