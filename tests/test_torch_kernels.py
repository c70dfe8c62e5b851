"""The port's three kernels: their plain PyTorch versions against the JAX
package's plain paths on the CPU (fp32, <= 1e-5).

The JAX side runs its jnp references only (``rmsnorm_ref``,
``direct_attention``, ``paged_chunk_attention_ref``), never Pallas
interpret mode.  Inputs are drawn with numpy and handed to both.  The
kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

RNG = np.random.default_rng(7)
TOL = 1e-5


def _np(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _t(a):
    from repro_torch.bridge import tensor_from_numpy
    return tensor_from_numpy(np.asarray(jax.device_get(a)))


# ------------------------------- rmsnorm -----------------------------------


@pytest.mark.parametrize("shape", [(5, 96), (2, 3, 128)])
def test_rmsnorm_plain_matches_jax(shape):
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as jref
    from repro_torch.kernels.rmsnorm import rmsnorm
    x, w = _np(shape), _np(shape[-1:])
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jref)(x, w)),
                               atol=TOL, rtol=TOL)


# ---------------------------- flash attention -------------------------------


@pytest.mark.parametrize("sq,skv,q_offset,kv_len,h,kvh", [
    (8, 24, 5, 20, 4, 2),       # offset != skv - sq, padded keys, GQA
    (16, 16, 0, 16, 4, 4),      # fresh prefill, MHA
    (12, 40, 28, 40, 6, 2),     # end-aligned continuation, group 3
    (7, 19, 3, 11, 4, 1),       # group 4, odd lengths
])
def test_flash_plain_matches_direct_attention(sq, skv, q_offset, kv_len, h,
                                              kvh):
    from repro.models.attention import direct_attention
    from repro_torch.kernels.flash_attention import flash_attention
    b, d = 2, 32
    q, k, v = _np((b, sq, h, d)), _np((b, skv, kvh, d)), _np((b, skv, kvh, d))

    @jax.jit
    def ref_fn(q, k, v):
        mask = (jnp.arange(skv) < kv_len)[None, None, None, :]
        return direct_attention(q, jnp.repeat(k, h // kvh, axis=2),
                                jnp.repeat(v, h // kvh, axis=2), causal=True,
                                q_offset=q_offset, mask=mask)
    ref = ref_fn(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, q_offset=q_offset,
                          kv_len=kv_len).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    # the port's own direct_attention agrees as well
    from repro_torch.models.attention import direct_attention as tdirect
    tk, tv = (torch.from_numpy(a).repeat_interleave(h // kvh, dim=2)
              for a in (k, v))
    mask = (torch.arange(skv) < kv_len)[None, None, None, :]
    got2 = tdirect(torch.from_numpy(q), tk, tv, causal=True,
                   q_offset=q_offset, mask=mask)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_flash_plain_rows_without_keys_are_zero():
    from repro_torch.kernels.flash_attention import attention_ref
    q, k = torch.randn(1, 2, 4, 16), torch.randn(1, 2, 6, 16)
    o = attention_ref(q, k, k, causal=True, q_offset=-2)
    assert torch.all(o[:, :, :2] == 0) and torch.all(o[:, :, 2:] != 0)


# -------------------------- paged chunk attention ---------------------------

# The cases of tests/test_paged_chunk_attention.py::test_paged_chunk_parity
# with one pool dtype each (every JAX reference call compiles, ~1 s on
# one core): every T {1, 7, 16, 24}, block size {16, 64}, GQA group
# {1, 2, 4} and pool dtype still appears.
#        T, bs, h, kvh, d, nb, nbmax, kv_dtype
CASES = [
    (1, 16, 4, 4, 32, 10, 3, "bfloat16"),
    (1, 64, 8, 2, 32, 6, 2, "int8"),
    (7, 16, 4, 2, 64, 12, 4, "float8_e4m3"),
    (7, 64, 4, 1, 32, 6, 2, "bfloat16"),
    (16, 16, 8, 4, 32, 12, 4, "float8_e4m3"),
    (16, 64, 4, 4, 64, 6, 3, "int8"),
    (24, 16, 4, 2, 32, 8, 2, "bfloat16"),
]
KV_JNP = {"bfloat16": jnp.bfloat16, "float8_e4m3": jnp.float8_e4m3fn,
          "int8": jnp.int8}


def _pools(nb, bs, kvh, d, kv_dtype):
    from repro.models.attention import quantize_kv
    kf, vf = _np((nb, bs, kvh, d)), _np((nb, bs, kvh, d))
    if kv_dtype == "bfloat16":
        return (jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16),
                None, None)
    quant = jax.jit(quantize_kv, static_argnums=1)
    kq, ks = quant(jnp.asarray(kf), KV_JNP[kv_dtype])
    vq, vs = quant(jnp.asarray(vf), KV_JNP[kv_dtype])
    return kq, vq, ks, vs


def _paged_both(q, kp, vp, bt, pos, ks=None, vs=None):
    from repro.kernels.paged_chunk_attention import \
        paged_chunk_attention_ref as jref
    from repro_torch.kernels.paged_chunk_attention import \
        paged_chunk_attention
    ref = jax.jit(jref)(jnp.asarray(q), kp, vp, jnp.asarray(bt),
                        jnp.asarray(pos), ks, vs)
    got = paged_chunk_attention(
        torch.from_numpy(q), _t(kp), _t(vp), torch.from_numpy(bt),
        torch.from_numpy(pos), None if ks is None else _t(ks),
        None if vs is None else _t(vs))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("case", CASES)
def test_paged_plain_parity(case):
    T, bs, h, kvh, d, nb, nbmax, kv_dtype = case
    b = 2
    q = _np((b, T, h, d))
    kp, vp, ks, vs = _pools(nb, bs, kvh, d, kv_dtype)
    bt = RNG.integers(0, nb, (b, nbmax)).astype(np.int32)   # fragmented
    starts = RNG.integers(0, nbmax * bs - T + 1, b)
    pos = (starts[:, None] + np.arange(T)[None, :]).astype(np.int32)
    if T > 1:
        pos[0, -1] = -1
    got, ref = _paged_both(q, kp, vp, bt, pos, ks, vs)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_paged_plain_padding_rows_are_zero():
    b, T, h, kvh, d, nb, bs, nbmax = 2, 5, 4, 2, 32, 8, 16, 2
    q = _np((b, T, h, d))
    kp, vp, _, _ = _pools(nb, bs, kvh, d, "bfloat16")
    bt = RNG.integers(0, nb, (b, nbmax)).astype(np.int32)
    pos = np.full((b, T), -1, np.int32)
    pos[0, :3] = [0, 1, 2]
    got, ref = _paged_both(q, kp, vp, bt, pos)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[0, 3:], 0.0)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_paged_plain_boundary_positions():
    b, T, h, kvh, d, nb, bs, nbmax = 4, 2, 4, 2, 32, 9, 16, 3
    q = _np((b, T, h, d))
    kp, vp, _, _ = _pools(nb, bs, kvh, d, "bfloat16")
    bt = RNG.integers(0, nb, (b, nbmax)).astype(np.int32)
    pos = np.asarray([[0, 1], [bs - 2, bs - 1], [bs - 1, bs],
                      [nbmax * bs - 2, nbmax * bs - 1]], np.int32)
    got, ref = _paged_both(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_dtype", ["float8_e4m3", "int8"])
def test_quantize_kv_matches_jax_bitwise(kv_dtype):
    from repro.models.attention import quantize_kv as jq
    from repro_torch.models.attention import KV_DTYPES, bits, quantize_kv
    x = _np((3, 5, 2, 16)) * 100.0
    x[0, 0] = 0.0                                   # all-zero token
    jv, js = jax.jit(jq, static_argnums=1)(jnp.asarray(x), KV_JNP[kv_dtype])
    tv, ts = quantize_kv(torch.from_numpy(x), KV_DTYPES[kv_dtype])
    np.testing.assert_array_equal(bits(tv).numpy().view(np.uint8),
                                  np.asarray(jv).view(np.uint8))
    # codes bitwise; scales to one fp32 ulp — under jit XLA turns the
    # division by the constant qmax into a multiply by its reciprocal
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 ** -23,
                               atol=0)
