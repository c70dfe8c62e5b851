"""The port's int8 quantize / dequantize (``kernels/quant_comm``) against
the JAX package on the CPU, on numpy-drawn inputs: the port's plain
versions (what "auto" runs on a CPU tensor) must equal the jitted
``repro.core.compression.quantize_blockwise`` / ``dequantize_blockwise``
bitwise, and the TPU kernels in interpret mode bitwise off the k + 0.5
code boundaries.  On a boundary the TPU kernel's x · fl(1/scale) can
round one code away from the oracle's x / scale; the port follows the
oracle, and the test pins where and by how much the two differ.  The
CUDA kernels against these plain versions: ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

BLOCK = 256


def _boundary(rng, nb):
    """Blocks whose values sit on k + 0.5 code boundaries of their own
    scale (absmax A planted in column 0, x = (k + 0.5) · fl(A · fl(1/127))
    in fp32)."""
    A = np.exp(rng.uniform(-6, 3, nb)).astype(np.float32)
    s = (A * np.float32(1 / 127)).astype(np.float32)
    k = rng.integers(-127, 127, (nb, BLOCK))
    x = ((k + 0.5).astype(np.float32) * s[:, None]).astype(np.float32)
    x[:, 0] = A * np.where(rng.random(nb) < 0.5, 1, -1)
    return x.reshape(-1)


def _case(name):
    rng = np.random.default_rng(3)
    if name == "boundary":
        return _boundary(rng, 64)
    n = {"4 blocks": 4, "64 blocks": 64, "129 blocks": 129,
         "zero block": 8, "bf16": 16}[name] * BLOCK
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-4, 2, n))
         ).astype(np.float32)
    if name == "zero block":
        x[3 * BLOCK:4 * BLOCK] = 0.0
    if name == "bf16":
        return jnp.asarray(x, jnp.bfloat16)
    return x


CASES = ["4 blocks", "64 blocks", "129 blocks", "zero block", "bf16",
         "boundary"]


def _torch(x):
    from repro_torch.bridge import tensor_from_numpy
    return tensor_from_numpy(np.asarray(x), device="cpu")


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jitted_oracle_bitwise(name):
    from repro.core.compression import dequantize_blockwise, \
        quantize_blockwise
    from repro_torch.kernels.quant_comm import dequantize, quantize
    x = _case(name)
    jq, js = jax.jit(quantize_blockwise)(jnp.asarray(x))
    tq, ts = quantize(_torch(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jax.jit(dequantize_blockwise)(jq, js)
    np.testing.assert_array_equal(dequantize(tq, ts).numpy(),
                                  np.asarray(jd))
    rq, rs = quantize(_torch(x), impl="ref")
    assert torch.equal(rq, tq) and torch.equal(rs, ts)
    if name == "zero block":
        assert float(ts[3]) == 0.0 and not tq[3 * BLOCK:4 * BLOCK].any()


@pytest.mark.parametrize("name", CASES)
def test_plain_against_tpu_kernel_in_interpret_mode(name):
    """Scales and dequantized values bitwise; codes bitwise except on the
    boundary case, where they differ by one code exactly where x / s and
    x · fl(1/s) round to different integers."""
    from repro.kernels.quant_comm.kernel import dequantize_fwd, \
        quantize_fwd
    from repro_torch.kernels.quant_comm import dequantize, quantize
    x = _case(name)
    kq, ks = quantize_fwd(jnp.asarray(x), interpret=True)
    tq, ts = quantize(_torch(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ks))
    kq, tq_ = np.asarray(kq).astype(np.int32), tq.numpy().astype(np.int32)
    s = np.repeat(ts.numpy(), BLOCK)
    xf = np.asarray(jnp.asarray(x, jnp.float32))
    den = np.maximum(s, np.float32(1e-12))
    inv = (np.float32(1) / den).astype(np.float32)
    apart = np.round(xf / den) != np.round((xf * inv).astype(np.float32))
    if name == "boundary":
        assert apart.sum() > 100            # the case reaches the boundary
    else:
        assert not apart.any()
    np.testing.assert_array_equal(kq != tq_, apart)
    assert np.abs(kq - tq_).max() <= 1
    kd = dequantize_fwd(jnp.asarray(tq.numpy()), jnp.asarray(ts.numpy()),
                        interpret=True)
    np.testing.assert_array_equal(dequantize(tq, ts).numpy(),
                                  np.asarray(kd))


def test_dispatch_contract():
    """n % 256 == 0 is required; "auto" on a CPU tensor is the plain
    version; the kernel wrappers refuse a CPU tensor; bf16 output is the
    fp32 product rounded once."""
    from repro_torch.kernels.quant_comm import dequantize, quantize
    from repro_torch.kernels.quant_comm.kernel import quantize_fwd
    x = torch.linspace(-3, 3, 2 * BLOCK)
    with pytest.raises(ValueError):
        quantize(x[:300])
    with pytest.raises(ValueError):
        quantize(x, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        quantize_fwd(x)
    q, s = quantize(x)
    assert torch.equal(dequantize(q, s, out_dtype=torch.bfloat16),
                       dequantize(q, s).to(torch.bfloat16))


def test_wire_takes_only_the_kernels_block():
    """``core.compression`` quantizes in the kernels' 256-element blocks
    and nothing else: no block size can be asked for, and a length the
    block does not divide is refused."""
    from repro_torch.core import compression as tc
    x = torch.linspace(-3, 3, 2 * BLOCK)
    for fn in (tc.quantize_blockwise, tc.int8_roundtrip):
        with pytest.raises(TypeError):
            fn(x, block=128)
    with pytest.raises(ValueError):
        tc.quantize_blockwise(x[:384])
