"""Plain PyTorch versions of the quant_comm kernels (the CPU path and the
oracles the kernels are held against on the card).

They repeat the arithmetic of the jitted ``quantize_blockwise`` /
``dequantize_blockwise`` of the JAX package's ``core/compression.py``,
the functions its int8 weak phase runs: per block of 256 elements,
scale = absmax · fl(1/127) (XLA folds ``absmax / 127`` into that
multiply), q = clip(round_half_even(x / max(scale, 1e-12)), ±127) with a
true division, and dequantize q · scale in fp32."""
import torch

BLOCK = 256
# fl(1/127) in fp32: a 0-dim float32 tensor multiplies as an fp32 scalar
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quantize_ref(x):
    """x (n,) float, n % 256 == 0 -> (q int8 (n,), scales fp32
    (n / 256,))."""
    n = x.shape[0]
    if x.dim() != 1 or n % BLOCK:
        raise ValueError(f"quantize takes x (n,) with n % {BLOCK} == 0, got "
                         f"{tuple(x.shape)}")
    xb = x.reshape(n // BLOCK, BLOCK).float()
    scale = xb.abs().amax(dim=1, keepdim=True) * _INV127
    q = torch.clamp(torch.round(xb / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8).reshape(n), scale[:, 0]


def dequantize_ref(q, s, out_dtype=torch.float32):
    """q (n,) int8, s (n / 256,) fp32 -> q · s (n,) in ``out_dtype``
    (the fp32 product, rounded once)."""
    n = q.shape[0]
    xb = q.reshape(n // BLOCK, BLOCK).float()
    return (xb * s[:, None]).reshape(n).to(out_dtype)
