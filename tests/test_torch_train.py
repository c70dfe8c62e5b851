"""The port's training path against the JAX package's on the CPU, in
fp32 with the same numpy-drawn weights (tests/_torch_pair.py) and the
same synthetic batches:

(a) ``DecoderLM.loss`` and every parameter gradient against
    ``jax.value_and_grad(model.loss)`` for four dense archs;
(b) the 10-step loss trajectory of examples/quickstart.py's setting
    against the JAX ``parallel.plan.make_train_step``;
(c) one step with ``microbatch=2`` against the JAX gspmd step.

The JAX side runs its plain jnp paths (never Pallas interpret mode).
Where the test owns the ``jit``, XLA's CPU backend compiles at
optimisation level 0 (``_torch_pair.compiled``), in about half the time; the
programs compute the same fp32 arithmetic.  On CPU tensors the port's
rmsnorm and flash-attention ``autograd.Function``s run their plain
forward and backward functions, so these tests also hold the Functions'
wiring against JAX autodiff."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_pair import build_pair, compiled, train_both  # noqa: E402

TOL = 1e-5


def _batch(cfg, step, b, s):
    from repro_torch.data.synthetic import batch_for_model
    return batch_for_model(cfg, "train", step, b, s)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "codeqwen1.5-7b",
                                  "nemotron-4-15b", "gpt2-medium"])
def test_loss_and_grads_match_jax(arch):
    """phi4 (rmsnorm, SwiGLU, tied), codeqwen (qkv bias, untied),
    nemotron (layernorm, squared ReLU), gpt2-medium (layernorm, tanh
    gelu, tied: the model the DDP path trains), with a loss mask: loss
    within 1e-5, every gradient leaf within 1e-5 of its max |g|."""
    from repro_torch.train_lib import loss_and_grads
    jcfg, jm, jp, tcfg, tm, tp = build_pair(arch)
    batch = _batch(tcfg, 0, 2, 16)
    batch["mask"] = (np.arange(16) < [[16], [11]]).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = compiled(jax.value_and_grad(jm.loss, has_aux=True),
                              jp, jb)(jp, jb)
    tl, tmet, tg = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tmet) == set(jmet) == {"ce", "aux_loss"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=0)
    _assert_leaves_close(tg, jg)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def test_quickstart_trajectory_matches_jax():
    jl, tl, jstate, tstate = train_both("phi4-mini-3.8b", 1, 10, 4, 64)
    assert set(tstate) == set(jstate) == {"params", "master", "m", "v",
                                          "step"}
    assert int(tstate["step"]) == int(jstate["step"]) == 10
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)


def _assert_leaves_close(got, want):
    """Every leaf within TOL of its own max |value|."""
    got, want = _leaves(_np(got)), _leaves(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(got[name] - w).max())
        assert err <= TOL * scale, (name, err, scale)


def test_microbatch_step_matches_jax():
    """microbatch=2: fp32 gradient accumulation over two halves and the
    mean loss, then one AdamW step.  After one step the first moment is
    (1 - b1) times the accumulated, clipped gradient, so m and v hold
    the accumulation leaf by leaf (the masters are not compared here:
    Adam's first step divides g by |g| + eps, which near-zero gradients
    make ill-conditioned; test_quickstart_trajectory_matches_jax holds
    the update over ten steps)."""
    jl, tl, jstate, tstate = train_both("phi4-mini-3.8b", 2, 1, 4, 32)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)
    _assert_leaves_close(tstate["m"], jstate["m"])
    _assert_leaves_close(tstate["v"], jstate["v"])


def test_adamw_pieces_match_jax():
    """global_norm, clip_by_global_norm and the schedules against the JAX
    functions on the same numbers; a bf16-moments step keeps its
    dtypes."""
    from repro.optim import clip_by_global_norm as jclip
    from repro.optim import global_norm as jnorm
    from repro.optim import warmup_cosine as jcos
    from repro_torch.optim import (AdamW, clip_by_global_norm, constant,
                                   global_norm, warmup_cosine)
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32) * 5}}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    np.testing.assert_allclose(float(global_norm(ttree)),
                               float(jnorm(tree)), rtol=TOL)
    for max_norm in (0.5, 100.0):
        (jc, jn), (tc, tn) = jclip(tree, max_norm), \
            clip_by_global_norm(ttree, max_norm)
        np.testing.assert_allclose(tc["b"]["c"].numpy(),
                                   np.asarray(jc["b"]["c"]), rtol=TOL)
        np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    jlr, tlr = jcos(3e-3, 2, 20), warmup_cosine(3e-3, 2, 20)
    for step in (0, 1, 2, 7, 20, 25):
        np.testing.assert_allclose(float(tlr(torch.tensor(step))),
                                   float(jlr(jnp.int32(step))), rtol=TOL)
    assert constant(0.1)(torch.tensor(3)) == 0.1
    opt = AdamW(lr=1e-2, param_dtype="bfloat16", moments_dtype="bfloat16")
    state = opt.init(ttree)
    grads = {"a": torch.ones(3, 4), "b": {"c": torch.ones(7)}}
    state = opt.apply(state, grads)
    assert state["params"]["a"].dtype == torch.bfloat16
    assert state["m"]["a"].dtype == torch.bfloat16
    assert state["master"]["a"].dtype == torch.float32
    assert int(state["step"]) == 1
    assert not torch.equal(state["master"]["a"], ttree["a"])


def test_train_cli_on_cpu(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "16"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out.count(" loss ") == 3          # one per step, then the final
    # the pipelined path is not ported; ddp runs over a grid of ranks
    # (tests/test_torch_ddp.py drives it, the CLI included)
    from repro_torch.parallel import ParallelPlan, make_train_step
    with pytest.raises(NotImplementedError, match="A13"):
        make_train_step(ParallelPlan(mode="pp"), None, None, device="cpu")
    with pytest.raises(ValueError, match="grid"):
        make_train_step(ParallelPlan(mode="ddp", overlap=False), None, None,
                        device="cpu")
    with pytest.raises(SystemExit):
        train.main(["--arch", "phi4-mini-3.8b", "--parallel", "pp"])


def _smoke_step(remat):
    """One CPU train step of a 2-layer phi4-mini smoke model under
    ``ParallelPlan(remat=remat)``; returns (loss, state)."""
    from repro_torch.optim import AdamW
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    _, _, _, tcfg, tm, tp = build_pair("phi4-mini-3.8b")
    plan = ParallelPlan(remat=remat)
    opt = AdamW(lr=1e-3, param_dtype="float32")
    state = init_state(plan, opt, tp)
    step = make_train_step(plan, tm, opt, device="cpu")
    state, metrics = step(state, _batch(tcfg, 0, 2, 16))
    return float(metrics["loss"]), state


@pytest.mark.parametrize("remat,layer_calls", [("full", 4), ("none", 2)])
def test_plan_remat_reaches_the_layers(monkeypatch, remat, layer_calls):
    """``ParallelPlan.remat`` acts: under "full" each of the 2 layers
    runs again in the backward, under "none" once; the step is the same
    either way."""
    from repro_torch.models import model_api
    from repro_torch.models.params import tree_leaves
    calls = []
    layer = model_api.dense_layer

    def counted(*args, **kw):
        calls.append(1)
        return layer(*args, **kw)
    monkeypatch.setattr(model_api, "dense_layer", counted)
    loss, state = _smoke_step(remat)
    assert len(calls) == layer_calls
    monkeypatch.setattr(model_api, "dense_layer", layer)
    other_loss, other = _smoke_step("none" if remat == "full" else "full")
    assert loss == other_loss
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(other["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kw,err", [
    (dict(tp=2), NotImplementedError), (dict(ep=2), NotImplementedError),
    (dict(zero1=True), NotImplementedError),
    (dict(opt_shard_model=True), NotImplementedError),
    (dict(seq_shard=True), NotImplementedError),
    (dict(remat="dots"), ValueError)])
def test_plan_refuses_what_one_device_cannot_do(kw, err):
    """A plan knob the one-device step cannot honour raises instead of
    being ignored."""
    from repro_torch.parallel import ParallelPlan, make_train_step
    with pytest.raises(err):
        make_train_step(ParallelPlan(**kw), None, None, device="cpu")
