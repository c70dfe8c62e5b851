"""The port's kernels: their plain PyTorch versions — forward and
backward — against the JAX package's plain paths on the CPU (fp32,
<= 1e-5), and the rmsnorm and flash-attention ``autograd.Function``s
on CPU tensors against torch autograd of the plain forwards.

The JAX side runs its jnp references only (``rmsnorm_ref``,
``direct_attention``, ``paged_chunk_attention_ref``) and their JAX
autodiff, never Pallas interpret mode.  Inputs are drawn with numpy and
handed to both.  The kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

RNG = np.random.default_rng(7)
TOL = 1e-5


def _np(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _vjp(fn, args, cot):
    """JAX autodiff of ``fn`` at ``args`` for cotangent ``cot``, as one
    program compiled at XLA's optimisation level 0 (about half the
    compile time on the CPU; the same fp32 arithmetic)."""
    def grads(args, cot):
        return jax.vjp(fn, *args)[1](cot)
    opts = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
    comp = jax.jit(grads).lower(args, cot).compile(compiler_options=opts)
    return [np.asarray(a) for a in comp(args, cot)]


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


@pytest.mark.parametrize("shape", [(5, 96), (2, 3, 128)])
def test_rmsnorm_backward_plain_matches_autodiff(shape):
    """rmsnorm_bwd_dx_ref / rmsnorm_bwd_dw_ref from the saved rstd against
    JAX autodiff of rmsnorm_ref and torch autograd of the plain forward;
    the RMSNorm Function on CPU tensors gives the same gradients, dx in
    x's dtype and dw in w's."""
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as jref
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref,
                                             rmsnorm_fwd_ref, rmsnorm_ref)
    x, w, dy = _np(shape), _np(shape[-1:]), _np(shape)
    jdx, jdw = _vjp(jref, (x, w), dy)
    d = shape[-1]
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    _, rstd = rmsnorm_fwd_ref(tx.reshape(-1, d), tw)
    dx = rmsnorm_bwd_dx_ref(tx.reshape(-1, d), tw, tdy.reshape(-1, d), rstd)
    dw = rmsnorm_bwd_dw_ref(tx.reshape(-1, d), tdy.reshape(-1, d), rstd)
    np.testing.assert_allclose(dx.reshape(shape).numpy(), jdx, atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, atol=TOL, rtol=TOL)
    xg, wg = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    auto = torch.autograd.grad(rmsnorm_ref(xg, wg), (xg, wg), tdy)
    fn = torch.autograd.grad(rmsnorm(xg, wg), (xg, wg), tdy)
    for a, b in zip(auto, fn):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL, rtol=TOL)
    wb = tw.bfloat16().requires_grad_()
    gx, gw = torch.autograd.grad(rmsnorm(xg, wb), (xg, wb), tdy)
    assert gx.dtype == torch.float32 and gw.dtype == torch.bfloat16


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


@pytest.mark.parametrize("sq,skv,q_offset,kv_len,h,kvh", [
    (16, 16, 0, 16, 6, 2),      # fresh causal prefill, group 3
    (12, 40, 28, 40, 6, 2),     # ragged sq != skv, end-aligned, group 3
    (8, 24, 5, 20, 4, 2),       # offset != skv - sq, kv_len < skv
])
def test_flash_backward_plain_matches_autodiff(sq, skv, q_offset, kv_len,
                                               h, kvh):
    """attention_bwd_ref (p recomputed from the saved lse, ds = p (dp -
    delta) scale, the GQA group summed) against JAX autodiff of
    direct_attention and torch autograd of the plain forward; the
    FlashAttention Function on CPU tensors gives the same gradients."""
    from repro.models.attention import direct_attention
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref,
                                                     flash_attention)
    b, d = 2, 32
    q, k, v = _np((b, sq, h, d)), _np((b, skv, kvh, d)), _np((b, skv, kvh, d))
    do = _np((b, sq, h, d))

    def jfwd(q, k, v):
        mask = (jnp.arange(skv) < kv_len)[None, None, None, :]
        return direct_attention(q, jnp.repeat(k, h // kvh, axis=2),
                                jnp.repeat(v, h // kvh, axis=2), causal=True,
                                q_offset=q_offset, mask=mask)
    jgrads = _vjp(jfwd, (q, k, v), do)
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2)
                       for a in (q, k, v, do))
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    o, lse = attention_fwd_ref(tq, tk, tv, **kw)
    delta = (o * tdo).sum(-1)
    plain = attention_bwd_ref(tq, tk, tv, tdo, lse, delta, **kw)
    for got, want in zip(plain, jgrads):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                   atol=TOL, rtol=TOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, tdo)
    fn = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, tdo)
    for a, c in zip(auto, fn):
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention"])
def test_ops_keep_residuals_only_for_gradients(monkeypatch, name):
    """Where no input wants a gradient (serving), the op runs its forward
    alone, outside the autograd Function: the forward that also returns
    rstd / lse is not run, and the output matches the plain forward."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    mod, fwd, ref = {
        "rmsnorm": (rops, "rmsnorm_fwd_ref", rops.rmsnorm_ref),
        "flash_attention": (fops, "attention_fwd_ref",
                            fops.attention_ref)}[name]
    args = ((torch.from_numpy(_np((5, 32))), torch.from_numpy(_np((32,))))
            if name == "rmsnorm" else
            tuple(torch.from_numpy(_np((1, 2, 6, 16))) for _ in range(3)))
    fn = getattr(mod, name)
    with_residuals = getattr(mod, fwd)

    def refused(*a, **kw):
        raise AssertionError(f"{fwd} ran without a gradient to take")
    monkeypatch.setattr(mod, fwd, refused)
    y = fn(*args)
    assert y.grad_fn is None
    np.testing.assert_array_equal(y.numpy(), ref(*args).numpy())
    monkeypatch.setattr(mod, fwd, with_residuals)
    leaf = args[0].clone().requires_grad_()
    assert fn(leaf, *args[1:]).grad_fn is not None


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


def _pairs_backward(q, k, v, do, lse, delta, valid):
    """dq, dk, dv in float64 numpy, summed over the (query, key) pairs
    that ``valid`` (b, h, sq, skv) keeps, from the saved lse and delta."""
    group, scale = q.shape[1] // k.shape[1], q.shape[-1] ** -0.5
    kk, vv = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    s = q @ kk.swapaxes(-1, -2) * scale
    p = np.where(valid, np.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ vv.swapaxes(-1, -2) - delta[..., None]) * scale
    dk = ds.swapaxes(-1, -2) @ q
    dv = p.swapaxes(-1, -2) @ do
    b, h, skv, d = dk.shape
    return (ds @ kk, dk.reshape(b, h // group, group, skv, d).sum(2),
            dv.reshape(b, h // group, group, skv, d).sum(2))


def test_chip_smoke_flash_faults_drop_exactly_their_work():
    """chip_smoke.py's planted faults of the flash backward kernels drop
    the work they name and nothing else: "one key tile skipped" is dQ
    without the pairs of the middle key tile below kv_len, "one ring
    stage skipped" is dK / dV without the pairs of query head 0's middle
    64-row tile (against a float64 sum over the remaining pairs)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels.flash_attention import attention_fwd_ref
    b, sq, skv, h, kvh, d, kv_len = 1, 150, 150, 4, 2, 16, 140
    q, do = _np((b, h, sq, d)), _np((b, h, sq, d))
    k, v = _np((b, kvh, skv, d)), _np((b, kvh, skv, d))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=True, q_offset=0, kv_len=kv_len)
    o, lse = attention_fwd_ref(tq, tk, tv, **kw)
    delta = (o * tdo).sum(-1)
    qpos, kpos = np.arange(sq)[:, None], np.arange(skv)[None, :]
    valid = np.broadcast_to((kpos <= qpos) & (kpos < kv_len), (b, h, sq, skv))
    f64 = [a.astype(np.float64) for a in (q, k, v, do)]
    saved = [t.double().numpy() for t in (lse, delta)]
    rq = torch.from_numpy(_pairs_backward(*f64, *saved, valid)[0]).float()
    no_tile = valid & ~((kpos >= 64) & (kpos < 128))
    got = chip_smoke.key_tile_skipped(tq, tk, tv, tdo, lse, delta, rq, kw)
    np.testing.assert_allclose(got[0].numpy(),
                               _pairs_backward(*f64, *saved, no_tile)[0],
                               atol=TOL, rtol=TOL)
    no_stage = valid.copy()
    no_stage[:, 0, 64:128] = False
    got = chip_smoke.stage_skipped(tq, tk, tv, tdo, lse, delta, kw)
    for g, want in zip(got, _pairs_backward(*f64, *saved, no_stage)[1:]):
        np.testing.assert_allclose(g.numpy(), want, atol=TOL, rtol=TOL)
