"""The port's Mamba-2 pieces (the hybrid family's sequence mixer) against
the JAX package's on the CPU, in fp32 with the same numpy-drawn inputs
and weights (tests/_torch_pair.py):

(a) the Mamba-2 helpers (``models.ssm_common``): conv, its streaming
    forms and the SSD scan's chunked, recurrent and quadratic forms;
(b) the SSD scan's plain forward (with each chunk's incoming state) and
    its plain reverse-recurrence backward, and the ``SSDScan`` Function
    that runs them on CPU tensors, against the JAX Pallas kernels in
    interpret mode and jax.grad of the JAX oracle;
(c) ``models.mamba2``: the training block, prefill (whole, carried
    state, ragged tail) and one-token decode, on weights with
    A_log = log(0.05) (``_torch_pair.slow_decay``).

The model, serving and training of zamba2 are in
tests/test_torch_hybrid_model.py.  The CUDA kernels are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_pair import (compiled, max_rel_close,  # noqa: E402
                         numpy_params, slow_decay)

ARCH = "zamba2-1.2b"


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------ ssm_common ----------------------------------


def test_ssm_common_matches_jax():
    """Conv (fresh, with a carried window, streaming), segsum, the chunked
    scan with and without h0, the recurrent step and the quadratic form,
    fp32: within 1e-6 of max |JAX| (the convs bitwise)."""
    from repro.models import ssm_common as J
    from repro_torch.models import ssm_common as T
    rng = np.random.default_rng(0)
    b, l, c, w = 2, 12, 6, 4
    x, wt, bias = _rand(rng, (b, l, c)), _rand(rng, (c, w)), _rand(rng, (c,))
    st = _rand(rng, (b, w - 1, c))
    a = -np.abs(_rand(rng, (b, 3, 8), 0.3))
    h, p, n, L = 3, 8, 4, 32
    xs, as_ = _rand(rng, (b, L, h, p)), -np.abs(_rand(rng, (b, L, h), 0.1))
    B, C = _rand(rng, (b, L, n), 0.5), _rand(rng, (b, L, n), 0.5)
    h0 = _rand(rng, (b, h, p, n))
    args = (x, wt, bias, st, a, xs, as_, B, C, h0)

    def jall(x, wt, bias, st, a, xs, as_, B, C, h0):
        return (J.causal_conv1d(x, wt, bias),
                J.causal_conv1d(x, wt, bias, st),
                J.conv_chunk_state(None, x, w), J.conv_chunk_state(st, x, w),
                J.conv_state_update(st, x[:, :1], wt, bias), J.segsum(a),
                J.ssd_chunked(xs, as_, B, C, 8),
                J.ssd_chunked(xs, as_, B, C, 8, h0=h0),
                J.ssd_reference(xs, as_, B, C),
                J.ssd_recurrent_step(h0, xs[:, 0], as_[:, 0], B[:, 0],
                                     C[:, 0]))
    want = jax.device_get(compiled(jall, *args)(*args))
    x, wt, bias, st, a, xs, as_, B, C, h0 = _t(*args)
    got = (T.causal_conv1d(x, wt, bias), T.causal_conv1d(x, wt, bias, st),
           T.conv_chunk_state(None, x, w), T.conv_chunk_state(st, x, w),
           T.conv_state_update(st, x[:, :1], wt, bias), T.segsum(a),
           T.ssd_chunked(xs, as_, B, C, 8),
           T.ssd_chunked(xs, as_, B, C, 8, h0=h0),
           T.ssd_reference(xs, as_, B, C),
           T.ssd_recurrent_step(h0, xs[:, 0], as_[:, 0], B[:, 0], C[:, 0]))
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    max_rel_close(got[4][0].numpy(), want[4][0], "conv_state_update", 1e-6)
    np.testing.assert_array_equal(got[4][1].numpy(), want[4][1])
    seg = got[5].numpy()
    np.testing.assert_array_equal(np.isinf(seg), np.isinf(want[5]))
    fin = np.isfinite(want[5])
    max_rel_close(seg[fin], want[5][fin], "segsum", 1e-6)
    for i, name in ((6, "ssd_chunked"), (7, "ssd_chunked h0"),
                    (9, "recurrent step")):
        for g, wv in zip(got[i], want[i]):
            max_rel_close(g.numpy(), wv, name, 1e-6)
    max_rel_close(got[8].numpy(), want[8], "ssd_reference", 1e-6)


# ------------------------------- ssd_scan ------------------------------------


SSD_CASES = [
    # b, l, h, p, n, kernel chunk, ref chunk (tests/test_fused_vjp.py)
    (2, 64, 2, 8, 4, 16, 16),       # multi-chunk, aligned
    (1, 56, 2, 8, 4, 16, 8),        # l not a chunk multiple (padded)
    (2, 128, 4, 32, 16, 64, 64),    # wider state
    (1, 30, 1, 4, 4, 8, 6),         # odd everything
]


def _ssd_inputs(case, seed=0):
    b, l, h, p, n = case[:5]
    rng = np.random.default_rng(seed)
    return (_rand(rng, (b, l, h, p), 0.5),
            -np.abs(_rand(rng, (b, l, h), 0.3)),
            _rand(rng, (b, l, n), 0.5), _rand(rng, (b, l, n), 0.5),
            _rand(rng, (b, l, h, p)), _rand(rng, (b, h, p, n)))


def _pad(t, l_p):
    pad = [(0, 0)] * t.ndim
    pad[1] = (0, l_p - t.shape[1])
    return np.pad(t, pad)


_JAX_SSD = {}


def _jax_ssd(case):
    """The JAX side of one SSD case, compiled once for the forward and
    the backward tests: ssd_scan(impl="interpret") and the chunked
    oracle (y, h_final), the quadratic form, the Pallas forward's saved
    residuals on the padded inputs, the Pallas backward (interpret) on
    them, and jax.grad of the oracle."""
    if case in _JAX_SSD:
        return _JAX_SSD[case]
    from repro.kernels.ssd_scan import ssd_quadratic_ref as jquad
    from repro.kernels.ssd_scan import ssd_ref as jref
    from repro.kernels.ssd_scan import ssd_scan as jscan
    from repro.kernels.ssd_scan.kernel import ssd_scan_bwd as jbwd
    from repro.kernels.ssd_scan.kernel import ssd_scan_fwd as jfwd
    b, l, h, p, n, chunk, refc = case
    x, a, B, C, ct, cth = _ssd_inputs(case)
    c = min(chunk, l)
    xp = [_pad(t, -(-l // c) * c) for t in (x, a, B, C, ct)]

    def fwd(x, a, B, C, *xp):
        hprev = jfwd(*xp[:4], chunk=c, interpret=True,
                     save_residuals=True)[2]
        return (jscan(x, a, B, C, chunk=chunk, impl="interpret"),
                jref(x, a, B, C, chunk=refc), jquad(x, a, B, C), hprev,
                jbwd(*xp[:4], hprev, xp[4], cth, chunk=c, interpret=True))

    def jloss(x, a, B, C):
        y, hf = jref(x, a, B, C, chunk=refc)
        return jnp.sum(y * ct) + jnp.sum(hf * cth)
    args = (x, a, B, C, *xp)
    out = jax.device_get(compiled(fwd, *args)(*args))
    grads = jax.device_get(compiled(jax.grad(jloss, argnums=(0, 1, 2, 3)),
                                    x, a, B, C)(x, a, B, C))
    _JAX_SSD[case] = dict(zip(("scan", "ref", "quad", "hprev", "bwd"), out),
                          grad=grads, inputs=(x, a, B, C, ct, cth), xp=xp,
                          c=c)
    return _JAX_SSD[case]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_forward_matches_jax(case):
    """The port's ssd_scan (the SSDScan Function's plain forward on CPU
    tensors, padded to a chunk multiple) against the JAX Pallas forward
    in interpret mode and the JAX chunked oracle: y and h_final within
    atol 1e-5; y within 1e-3 of the quadratic form.  The plain forward's
    per-chunk states equal the JAX kernel's saved residuals."""
    from repro_torch.kernels.ssd_scan import ssd_fwd_ref, ssd_scan
    J = _jax_ssd(case)
    x, a, B, C = J["inputs"][:4]
    ty, th = ssd_scan(*_t(x, a, B, C), chunk=case[5])
    for want_y, want_h in (J["scan"], J["ref"]):
        np.testing.assert_allclose(ty.numpy(), want_y, atol=1e-5, rtol=0)
        np.testing.assert_allclose(th.numpy(), want_h, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ty.numpy(), J["quad"], atol=1e-3, rtol=0)
    tres = ssd_fwd_ref(*_t(*J["xp"][:4]), J["c"])[2]
    np.testing.assert_allclose(tres.numpy(), J["hprev"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_backward_matches_jax(case):
    """The plain reverse-recurrence backward against the JAX Pallas
    backward (interpret mode) on the same h_prev, dy and dh_final, and
    the gradient of sum(y * ct) + sum(h_final * cth) through the port's
    SSDScan Function (plain backward) against jax.grad of the JAX
    chunked oracle: atol and rtol 1e-4, as the JAX test holds them."""
    from repro_torch.kernels.ssd_scan import ssd_bwd_ref, ssd_scan
    J = _jax_ssd(case)
    x, a, B, C, ct, cth = J["inputs"]
    xp = J["xp"]
    got = ssd_bwd_ref(*_t(*xp[:4], J["hprev"], xp[4], cth), J["c"])
    for name, g, w in zip(("dx", "da", "dB", "dC"), got, J["bwd"]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    leaves = [t.requires_grad_() for t in _t(x, a, B, C)]
    y, hf = ssd_scan(*leaves, chunk=case[5])
    tg = torch.autograd.grad(
        (y * torch.from_numpy(ct)).sum() + (hf * torch.from_numpy(cth)).sum(),
        leaves)
    for name, g, w in zip(("dx", "da", "dB", "dC"), tg, J["grad"]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_ssd_scan_dispatch_and_shapes():
    """impl "ref" is the plain chunked scan with autograd (needs whole
    chunks, as the JAX "ref" does); unknown impls raise; the CUDA
    wrappers refuse CPU tensors."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_bwd,
                                                     ssd_scan_fwd)
    x, a, B, C, ct, cth = _t(*_ssd_inputs(SSD_CASES[0]))
    y, hf = ssd_scan(x, a, B, C, chunk=16, impl="ref")
    ry, rh = ssd_ref(x, a, B, C, 16)
    assert torch.equal(y, ry) and torch.equal(hf, rh)
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(x[:, :56], a[:, :56], B[:, :56], C[:, :56], chunk=16,
                 impl="ref")
    with pytest.raises(ValueError, match="impl"):
        ssd_scan(x, a, B, C, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fwd(x, a, B, C, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(x, a, B, C, None, ct, cth, chunk=16)


# -------------------------------- mamba2 -------------------------------------


@pytest.fixture(scope="module")
def mamba_pair():
    """(jcfg, tcfg, JAX Mamba-2 params, port params, u (2, 80, d))."""
    from repro.configs.registry import smoke_config as jsmoke
    from repro.models import mamba2 as jm2
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.registry import smoke_config as tsmoke
    jcfg = dc.replace(jsmoke(ARCH), compute_dtype="float32")
    tcfg = dc.replace(tsmoke(ARCH), compute_dtype="float32")
    jp = slow_decay(numpy_params(jm2.mamba2_defs(jcfg), seed=3))
    rng = np.random.default_rng(4)
    jp["conv_b"] = _rand(rng, jp["conv_b"].shape, 0.1)
    jp["dt_bias"] = _rand(rng, jp["dt_bias"].shape, 0.5)
    u = _rand(rng, (2, 80, jcfg.d_model))
    return jcfg, tcfg, jp, params_from_numpy(jp, device="cpu"), u


def test_apply_mamba2_matches_jax(mamba_pair):
    """The training block at l = 64 (two chunks of 32): output and the
    gradient of sum(out * ct) for every leaf and the input, within 1e-5
    of max |JAX|."""
    from repro.models import mamba2 as jm2
    from repro_torch.models import mamba2 as tm2
    jcfg, tcfg, jp, tp, u = mamba_pair
    u = u[:, :64]
    ct = _rand(np.random.default_rng(5), u.shape)

    def jloss(params, u):
        out = jm2.apply_mamba2(jcfg, params, u)
        return jnp.sum(out * ct), out
    (_, jout), jg = compiled(jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True), jp, u)(jp, u)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    ut = torch.from_numpy(u).requires_grad_()
    out = tm2.apply_mamba2(tcfg, leaves, ut)
    max_rel_close(out.detach().numpy(), jout, "out")
    names = sorted(leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [leaves[k] for k in names] + [ut])
    for name, g in zip(names + ["u"], grads):
        max_rel_close(g.numpy(), jg[1] if name == "u" else jg[0][name],
                       name)


def test_mamba2_prefill_and_decode_match_jax(mamba_pair):
    """Prefill of 64 tokens (whole chunks), then 16 more from its carried
    state, then 9 from that (l < chunk: one short chunk), then a ragged
    prefill of 80 (64 through the scan, a 16-token tail from the carried
    state), then two one-token decode steps: outputs and states within
    1e-5 of max |JAX|; the chunked stream equals the monolithic one."""
    from repro.models import mamba2 as jm2
    from repro_torch.models import mamba2 as tm2
    jcfg, tcfg, jp, tp, u = mamba_pair

    def jall(p, u):
        o1, s1 = jm2.mamba2_prefill(jcfg, p, u[:, :64])
        o2, s2 = jm2.mamba2_prefill(jcfg, p, u[:, 64:], state=s1)
        o3, s3 = jm2.mamba2_prefill(jcfg, p, u[:, :9], state=s2)
        o4, s4 = jm2.mamba2_prefill(jcfg, p, u)
        dec, st = [], s4
        for t in range(2):
            o, st = jm2.mamba2_decode(jcfg, p, u[:, t:t + 1] * 0.5, st)
            dec.append((o, st))
        return (o1, s1), (o2, s2), (o3, s3), (o4, s4), dec
    J = jax.device_get(compiled(jall, jp, u)(jp, u))

    def close(got, want, name):
        to, ts = got
        jo, js = want
        max_rel_close(to.numpy(), jo, f"{name} out")
        for k in ("ssm", "conv"):
            max_rel_close(ts[k].numpy(), js[k], f"{name} {k}")

    ut = torch.from_numpy(u)
    r1 = tm2.mamba2_prefill(tcfg, tp, ut[:, :64])
    close(r1, J[0], "prefill 0:64")
    r2 = tm2.mamba2_prefill(tcfg, tp, ut[:, 64:], state=r1[1])
    close(r2, J[1], "prefill 64:80 from a state")
    close(tm2.mamba2_prefill(tcfg, tp, ut[:, :9], state=r2[1]), J[2],
          "prefill l=9 from a state")
    r4 = tm2.mamba2_prefill(tcfg, tp, ut)
    close(r4, J[3], "ragged prefill")
    max_rel_close(torch.cat([r1[0], r2[0]], 1).numpy(), J[3][0],
                   "chunked vs whole")
    st = r4[1]
    for t in range(2):
        out = tm2.mamba2_decode(tcfg, tp, ut[:, t:t + 1] * 0.5, st)
        close(out, J[4][t], f"decode {t}")
        st = out[1]


def test_build_model_returns_zamba():
    """build_model gives a ZambaLM: 38 Mamba layers, 6 invocations of
    the shared block (its paged KV layers), about 1.1 B parameters."""
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.models import ZambaLM, build_model
    from repro_torch.models.params import count_params
    assert isinstance(build_model(smoke_config(ARCH)), ZambaLM)
    m = build_model(get_arch(ARCH))
    assert m.paged_kv_layers == 6
    assert m.paged_state_extras(2)["mamba"][0]["ssm"].shape == (2, 64, 64,
                                                                64)
    assert 1.10e9 < count_params(m.param_defs()) < 1.11e9
