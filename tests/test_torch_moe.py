"""The port's MoE family against the JAX package's on the CPU, in fp32 with
the same numpy-drawn inputs and weights (tests/_torch_pair.py):

(a) top-k gating, forward and backward: the port's plain versions and
    its ``TopKGating`` Function (plain forward and backward on CPU
    tensors) against the JAX Pallas kernels in interpret mode and the
    JAX oracle, tie rows included;
(b) ``models.moe.apply_moe`` (dropless and capacity-limited, softmax and
    sigmoid routers, G > 1 groups): output, aux loss and gradients;
(c) ``DecoderLM.loss`` and every parameter gradient;
(d) serving: the paged engine's greedy streams against the JAX
    dense-cache reference (and the JAX engine for quantized pools),
    chunked prefill against whole-prompt prefill, and dense-cache
    ``forward`` logits;
(e) a 5-step training trajectory against the JAX gspmd step.

On CPU tensors the router runs the plain top-k (``_topk_renorm``), as
the JAX package does off the TPU; the CUDA kernels are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_pair import (build_pair, compiled, numpy_params,  # noqa: E402
                         prompts, train_both)

TOL = 1e-5
MOE_ARCHS = ["qwen2-moe-a2.7b", "deepseekmoe-16b", "qwen3-moe-235b-a22b"]


def _gating_logits(T, E, seed=0):
    """fp32 logits with tie rows: row 0 all equal, row 1 all zero, row 2
    with its two largest values equal (experts 5 and 3: 3 comes first)."""
    x = np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32) * 2
    x[0] = 0.7
    x[1] = 0.0
    x[2, [5, 3]] = 9.0
    return x


def _max_rel_close(got, want, name=""):
    """|got - want| within TOL of max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (name, err, scale)


# ------------------------------- gating -------------------------------------


GATING_CASES = [(512, 64, 8, True), (512, 60, 4, True), (50, 16, 4, True),
                (100, 32, 2, False)]


@pytest.mark.parametrize("T,E,k,renorm", GATING_CASES)
def test_gating_forward_matches_jax(T, E, k, renorm):
    """Experts identical, weights within 1e-6, against the JAX Pallas
    kernel (interpret mode) and the JAX oracle; tie rows pick the lower
    index first (all-equal rows: experts 0..k-1)."""
    from repro.kernels.topk_gating import topk_gating as jgate
    from repro.kernels.topk_gating import topk_gating_ref as jref
    from repro_torch.kernels.topk_gating import (topk_gating,
                                                 topk_gating_fwd_ref,
                                                 topk_gating_ref)
    x = _gating_logits(T, E)
    jw, je = jgate(jnp.asarray(x), k=k, renorm=renorm, impl="interpret")
    rw, re = jref(jnp.asarray(x), k, renorm)
    np.testing.assert_array_equal(np.asarray(je), np.asarray(re))
    tx = torch.from_numpy(x)
    for fn in (lambda: topk_gating_ref(tx, k, renorm),
               lambda: topk_gating_fwd_ref(tx, k, renorm),
               lambda: topk_gating(tx, k=k, renorm=renorm)):
        w, e = fn()
        assert w.dtype == torch.float32 and e.dtype == torch.int32
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6,
                                   rtol=0)
    e = topk_gating(tx, k=k, renorm=renorm)[1].numpy()
    np.testing.assert_array_equal(e[:2], np.broadcast_to(np.arange(k),
                                                         (2, k)))
    np.testing.assert_array_equal(e[2, :2], [3, 5])


@pytest.mark.parametrize("T,E,k,renorm", GATING_CASES)
def test_gating_backward_matches_jax(T, E, k, renorm):
    """The gradient of sum(w * ct) through the port's TopKGating Function
    (plain backward) against jax.grad through the JAX interpret
    custom_vjp, and against torch autograd of the plain forward; the
    Function's experts output is not differentiable."""
    from repro.kernels.topk_gating import topk_gating as jgate
    from repro_torch.kernels.topk_gating import (topk_gating,
                                                 topk_gating_bwd_ref,
                                                 topk_gating_ref)
    x = _gating_logits(T, E, seed=1)
    ct = np.random.default_rng(2).standard_normal((T, k)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jgate(x, k=k, renorm=renorm, impl="interpret")[0]
                       * ct)
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    w, e = topk_gating(xt, k=k, renorm=renorm)
    assert w.requires_grad and not e.requires_grad
    got = torch.autograd.grad(w, xt, torch.from_numpy(ct))[0].numpy()
    auto = torch.autograd.grad(topk_gating_ref(xt, k, renorm)[0], xt,
                               torch.from_numpy(ct))[0].numpy()
    plain = topk_gating_bwd_ref(torch.from_numpy(x), e, torch.from_numpy(ct),
                                k, renorm).numpy()
    np.testing.assert_array_equal(got, plain)
    for want in (jg, auto):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_gating_dispatch_and_shapes():
    """impl "ref" is the oracle with autograd; unknown impls raise; T = 0
    and k = E go through; the CUDA wrappers refuse CPU tensors."""
    from repro_torch.kernels.topk_gating import topk_gating
    from repro_torch.kernels.topk_gating.kernel import (topk_gating_bwd,
                                                        topk_gating_fwd)
    x = torch.from_numpy(_gating_logits(9, 8))
    w, e = topk_gating(x, k=8, impl="ref")
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)
    w0, e0 = topk_gating(x[:0], k=2)
    assert w0.shape == (0, 2) and e0.shape == (0, 2)
    with pytest.raises(ValueError, match="impl"):
        topk_gating(x, k=2, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        topk_gating_fwd(x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        topk_gating_bwd(x, e, w, 8)


# ------------------------------- apply_moe ----------------------------------


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_jax(arch, router):
    """Groups of 16 over 2 x 32 tokens (G = 4), dropless and
    capacity-limited (cap 5 of 16: tokens really are dropped): y and aux
    within 1e-5 relative, the gradient of sum(y * ct) + aux for every
    moe_* leaf and for x within 1e-5 of its max |g|."""
    from repro.configs.registry import smoke_config as jsmoke
    from repro.models import moe as jmoe
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.registry import smoke_config as tsmoke
    from repro_torch.models import moe as tmoe
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    jcfg = dc.replace(jcfg, compute_dtype="float32",
                      moe=dc.replace(jcfg.moe, router=router))
    tcfg = dc.replace(tcfg, compute_dtype="float32",
                      moe=dc.replace(tcfg.moe, router=router))
    jp = numpy_params(jmoe.moe_defs(jcfg), seed=3)
    # a router wide enough that routing is decisive
    jp["router"] = jp["router"] * 50
    tp = params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    ys = {}
    for dropless in (True, False):
        def jloss(params, x):
            y, aux = jmoe.apply_moe(jcfg, params, x, group_size=16,
                                    dropless=dropless)
            return jnp.sum(y * ct) + aux, (y, aux)
        (_, (jy, jaux)), jg = compiled(
            jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
            jp, x)(jp, x)
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        xt = torch.from_numpy(x).requires_grad_()
        ty, taux = tmoe.apply_moe(tcfg, leaves, xt, group_size=16,
                                  dropless=dropless)
        _max_rel_close(ty.detach().numpy(), jy, "y")
        np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=TOL)
        loss = (ty * torch.from_numpy(ct)).sum() + taux
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [xt])
        for name, g in zip(names + ["x"], grads):
            want = jg[1] if name == "x" else jg[0][name]
            _max_rel_close(g.numpy(), want, name)
        ys[dropless] = ty.detach()
    assert not torch.allclose(ys[True], ys[False])   # capacity dropped some


def test_apply_moe_needs_whole_groups():
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import apply_moe
    cfg = smoke_config("qwen2-moe-a2.7b")
    params = build_model(cfg).init(0, device="cpu")
    lp = {k[4:]: v[0] for k, v in params["layers"].items()
          if k.startswith("moe_")}
    with pytest.raises(ValueError, match="multiple of the group"):
        apply_moe(cfg, lp, torch.zeros(1, 24, cfg.d_model), group_size=16)
    y, aux = apply_moe(cfg, lp, torch.zeros(1, 32, cfg.d_model),
                       group_size=16, dropless=True, _aux=False)
    assert y.shape == (1, 32, cfg.d_model) and aux is None


# --------------------------- loss and gradients -----------------------------


@pytest.mark.parametrize("arch,group", [("qwen2-moe-a2.7b", 512),
                                        ("qwen3-moe-235b-a22b", 8)])
def test_loss_and_grads_match_jax(arch, group):
    """DecoderLM.loss (ce + aux, {"ce", "aux_loss"}) within 1e-5 and
    every gradient leaf within 1e-5 of its max |g|, with the whole batch
    in one group (qwen2-moe) and in groups of 8 with drops (qwen3-moe,
    GQA)."""
    from repro.models import build_model as jbuild
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.models import build_model as tbuild
    from repro_torch.train_lib import loss_and_grads
    from repro_torch.models.params import tree_leaves
    jcfg, _, jp, tcfg, _, tp = build_pair(arch)
    jm, tm = jbuild(jcfg, moe_group=group), tbuild(tcfg, moe_group=group)
    # the JAX tree (moe_router, moe_e_*, moe_s_*) crosses the bridge leaf
    # for leaf, in sorted-key order, with the port's own schema
    jleaves = jax.tree_util.tree_leaves(jp)
    assert [tuple(d.shape) for d in tree_leaves(tm.param_defs())] == \
        [x.shape for x in jleaves]
    for a, b in zip(tree_leaves(tp), jleaves):
        np.testing.assert_array_equal(a.numpy(), b)
    batch = batch_for_model(tcfg, "train", 0, 2, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = compiled(jax.value_and_grad(jm.loss, has_aux=True),
                              jp, jb)(jp, jb)
    tl, tmet, tg = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tmet) == set(jmet) == {"ce", "aux_loss"}
    assert float(tmet["aux_loss"]) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=0)
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=TOL)
    for k in sorted(jg["layers"]):
        _max_rel_close(tg["layers"][k].numpy(), jg["layers"][k], k)
    for k in sorted(set(jg) - {"layers"}):
        _max_rel_close(tg[k].numpy(), jg[k], k)


def test_training_trajectory_matches_jax():
    """Five AdamW steps on qwen2-moe smoke (capacity-limited dispatch):
    the loss trajectory within rtol 1e-5 of the JAX gspmd step's."""
    jl, tl, _, tstate = train_both("qwen2-moe-a2.7b", 1, 5, 4, 32)
    assert int(tstate["step"]) == 5
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)


# -------------------------------- serving -----------------------------------


@pytest.fixture(scope="module")
def moe_pair():
    return build_pair("qwen2-moe-a2.7b")


def test_paged_engine_matches_jax_dense_reference(moe_pair):
    """Mirrors tests/test_serving.py::test_paged_matches_dense_moe: the
    port's paged engine reproduces, token for token, the greedy streams
    of the JAX dense-cache BatchServer; prefill in chunks of 16 gives the
    same tokens as whole-prompt prefill (the dropless invariance)."""
    from repro.serve_lib import BatchServer
    from repro_torch.serving import ServingEngine
    _, jm, jp, tcfg, tm, tp = moe_pair
    ps = prompts(tcfg.vocab_size, 2, 18)
    srv = BatchServer(jm, jp, None)
    ref = [np.asarray(srv.serve({"tokens": jnp.asarray(row[None])},
                                gen=4)[0][0]) for row in ps]
    for chunk in (0, 16):
        eng = ServingEngine(tm, tp, device="cpu", n_blocks=16,
                            block_size=16, max_slots=2, prefill_chunk=chunk)
        rids = [eng.submit(row, 4) for row in ps]
        outs = eng.run()
        for want, rid in zip(ref, rids):
            np.testing.assert_array_equal(outs[rid], want)


@pytest.mark.parametrize("kv_dtype", ["float8_e4m3", "int8"])
def test_quantized_pools_match_jax_engine(moe_pair, kv_dtype):
    """e4m3 and int8 pools: the port's engine and the JAX engine give the
    same greedy streams over staggered arrivals."""
    from repro.serving import ServingEngine as JEngine
    from repro_torch.serving import ServingEngine as TEngine
    _, jm, jp, tcfg, tm, tp = moe_pair
    ps = prompts(tcfg.vocab_size, 3, 18, seed=3)
    kw = dict(n_blocks=24, block_size=16, max_slots=2, kv_dtype=kv_dtype)
    outs = []
    for eng in (JEngine(jm, jp, **kw), TEngine(tm, tp, device="cpu", **kw)):
        rids = [eng.submit(p, 4, arrival=i) for i, p in enumerate(ps)]
        res = eng.run()
        outs.append([np.asarray(res[r]) for r in rids])
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)


def test_dense_cache_forward_matches_jax(moe_pair):
    """Fresh prefill with a padding token, then T = 1 decode ticks, on
    the dense cache: logits within 1e-5 of JAX's, greedy tokens equal."""
    _, jm, jp, tcfg, tm, tp = moe_pair
    toks = prompts(tcfg.vocab_size, 2, 16)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    pos[1, -1] = -1
    js = jm.init_seq_state(jp, 20, batch_size=2, dtype="float32")
    ts = tm.init_seq_state(tp, 20, batch_size=2, dtype="float32")
    lens = (pos >= 0).sum(1)
    steps = {}
    for i in range(4):
        fresh = i == 0
        if not fresh:
            pos = (lens + i - 1)[:, None].astype(np.int32)
        args = (jp, js, jnp.asarray(toks), jnp.asarray(pos))
        if fresh not in steps:
            steps[fresh] = compiled(
                lambda p, st, t, q, f=fresh: jm.forward(p, st, t, q,
                                                        fresh=f), *args)
        js, jl = steps[fresh](*args)
        ts, tl = tm.forward(tp, ts, torch.from_numpy(np.asarray(toks)),
                            torch.from_numpy(pos), fresh=fresh)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl.numpy().argmax(-1), toks[:, 0])


def test_moe_clis_on_cpu(capsys):
    """The serving and training entry points take an MoE arch."""
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                      "cpu", "--decode-impl", "paged", "--batch", "2",
                      "--prompt-len", "12", "--gen", "3"])
    assert out.shape == (2, 3)
    losses = train.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "paged:" in capsys.readouterr().out
