"""The port's hybrid family (Zamba2: Mamba-2 layers and one shared
attention block) against the JAX package's on the CPU, in fp32 with the
same numpy-drawn weights (tests/_torch_pair.py): ``ZambaLM.loss`` and
every gradient, the dense-cache ``forward``, the paged engine's greedy
streams (eviction replay, a prefix hit that restores the mamba state,
chunked prefill) against the JAX dense reference, ragged prompt lengths,
a 5-step training trajectory and the CLIs.

The weights draw A_log = log(0.05) (``_torch_pair.slow_decay``) instead
of the init rule's A_log = 1, under which no state survives a chunk, so
that a dropped or stale carried state shows.  The Mamba-2 pieces and the
SSD scan's plain versions are in tests/test_torch_hybrid.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_pair import (build_pair, compiled, max_rel_close,  # noqa: E402
                         prompts, slow_decay, train_both)

ARCH = "zamba2-1.2b"
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(jcfg, jmodel, jparams, tcfg, tmodel, tparams): zamba2 smoke, 4
    layers (d 128, SSM heads of 64, state 16, chunk 32, the shared block
    every 2 layers), fp32, slow decay."""
    from repro_torch.bridge import params_from_numpy
    jcfg, jm, jp, tcfg, tm, _ = build_pair(ARCH, n_layers=4)
    jp = slow_decay(jp)
    return jcfg, jm, jp, tcfg, tm, params_from_numpy(jp, device="cpu")


def test_loss_and_grads_match_jax(pair):
    """ZambaLM.loss within 1e-5 and every gradient leaf within 1e-5 of
    its max |g| (remat on, as in training); the JAX tree crosses the
    bridge leaf for leaf."""
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train_lib import loss_and_grads
    jcfg, jm, jp, tcfg, tm, tp = pair
    jleaves = jax.tree_util.tree_leaves(jp)
    assert [tuple(d.shape) for d in tree_leaves(tm.param_defs())] == \
        [x.shape for x in jleaves]
    batch = batch_for_model(tcfg, "train", 0, 2, 64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = compiled(jax.value_and_grad(jm.loss, has_aux=True),
                           jp, jb)(jp, jb)
    tl, tmet, tg = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tmet) == {"ce"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=0)
    for group in ("mamba", "shared", "pre_norm"):
        for k in sorted(jg[group]):
            max_rel_close(tg[group][k].numpy(), jg[group][k],
                           f"{group}/{k}")
    for k in ("embed", "final_norm_scale"):
        max_rel_close(tg[k].numpy(), jg[k], k)


class _JaxDense:
    """The JAX chunk API on a dense cache (what the JAX BatchServer's
    dense path runs), one compiled program per chunk shape, shared by
    the tests of the module."""
    progs: dict = {}

    def __init__(self, jm, jp, b, cap):
        self.jm, self.jp = jm, jp
        self.state = jm.init_seq_state(jp, cap, batch_size=b,
                                       dtype="float32")

    def __call__(self, toks, pos, fresh):
        args = (self.jp, self.state, jnp.asarray(toks), jnp.asarray(pos))
        key = (toks.shape, fresh)
        if key not in self.progs:
            jm = self.jm
            self.progs[key] = compiled(
                lambda p, st, t, q: jm.forward(p, st, t, q, fresh=fresh),
                *args)
        self.state, logits = self.progs[key](*args)
        return np.asarray(logits)


PROMPT, GEN = 18, 5


def _positions(off, b, T):
    return np.broadcast_to(np.arange(off, off + T), (b, T)).astype(np.int32)


@pytest.fixture(scope="module")
def dense_reference(pair):
    """The JAX dense-cache greedy streams (tests/test_seq_state.py's
    reference) for 3 prompts of 18 tokens, 5 new tokens each: the prompt
    as one fresh chunk, then one-token decode ticks."""
    _, jm, jp, tcfg, _, _ = pair
    ps = prompts(tcfg.vocab_size, 3, PROMPT)
    run = _JaxDense(jm, jp, 3, PROMPT + GEN)
    toks = [run(ps, _positions(0, 3, PROMPT), True).argmax(-1)]
    for t in range(GEN - 1):
        toks.append(run(toks[-1][:, None].astype(np.int32),
                        _positions(PROMPT + t, 3, 1), False).argmax(-1))
    return ps, np.stack(toks, 1)


def test_dense_cache_forward_matches_jax(pair, dense_reference):
    """On the dense cache: a fresh prefill of 12 tokens, a 6-token chunk
    (the SSD scan from a carried state, the shared block through the
    cache), then 4 decode ticks: logits within 1e-5 of JAX's, greedy
    tokens equal — and equal to the whole-prompt reference's."""
    _, jm, jp, tcfg, tm, tp = pair
    ps, ref = dense_reference
    run = _JaxDense(jm, jp, 3, PROMPT + GEN)
    ts = tm.init_seq_state(tp, PROMPT + GEN, batch_size=3, dtype="float32")
    plan = [(ps[:, :12], 0, True), (ps[:, 12:], 12, False)]
    plan += [(None, PROMPT + t, False) for t in range(GEN - 1)]
    nxt = None
    for i, (tk, off, fresh) in enumerate(plan):
        tk = nxt[:, None] if tk is None else tk
        pos = _positions(off, 3, tk.shape[1])
        jl = run(tk, pos, fresh)
        ts, tl = tm.forward(tp, ts, torch.from_numpy(np.array(tk)),
                            torch.from_numpy(pos), fresh=fresh)
        np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=TOL)
        nxt = jl.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), nxt)
        if i >= 1:
            np.testing.assert_array_equal(nxt, ref[:, i - 1])


@pytest.mark.parametrize("chunk", [0, 8])
def test_paged_engine_matches_jax_dense_reference(pair, dense_reference,
                                                  chunk):
    """Mirrors tests/test_seq_state.py::test_hybrid_paged_matches_dense:
    paged attention blocks + per-slot mamba states reproduce, token for
    token, the JAX dense path, 3 requests over 2 slots; prefill in
    exact-length chunks of 8 (the mamba state carried from chunk to
    chunk) gives the same tokens."""
    from repro_torch.serving import ServingEngine
    _, _, _, _, tm, tp = pair
    ps, ref = dense_reference
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=32, block_size=16,
                        max_slots=2, prefill_chunk=chunk)
    rids = [eng.submit(row, GEN, arrival=i) for i, row in enumerate(ps)]
    outs = eng.run()
    assert eng.step_count > 0
    for want, rid in zip(ref, rids):
        np.testing.assert_array_equal(outs[rid], want)


def test_paged_eviction_and_prefix(pair, dense_reference):
    """Mirrors tests/test_seq_state.py::test_hybrid_paged_eviction_and_
    prefix: eviction/requeue replays identically (the mamba state is
    rebuilt by re-prefill), and a resubmitted prompt is restored by
    reference with its mamba state, giving the same tokens."""
    from repro_torch.serving import ServingEngine
    _, _, _, _, tm, tp = pair
    ps, ref = dense_reference
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=32, block_size=16,
                        max_slots=2)
    rids = [eng.submit(row, GEN) for row in ps[:2]]
    eng.step()
    running = [r for r in eng._slots if r is not None]
    eng.evict(running[-1].rid)
    outs = eng.run()
    assert eng.evictions == 1
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], ref[i])
    r2 = eng.submit(ps[0], GEN)
    outs2 = eng.run()
    assert eng.cache.hits >= 1
    np.testing.assert_array_equal(outs2[r2], ref[0])


def _port_stream(tm, tp, toks, plan, gen=GEN):
    """Greedy stream through the port's dense-cache chunk API: the prompt
    in chunks of the widths in ``plan``, then one-token ticks."""
    b, s = toks.shape
    st = tm.init_seq_state(tp, s + gen, batch_size=b, dtype="float32")
    off, out = 0, []
    for w in plan:
        st, logits = tm.forward(tp, st, torch.from_numpy(toks[:, off:off + w]),
                                torch.from_numpy(_positions(off, b, w)),
                                fresh=off == 0)
        off += w
    for t in range(gen):
        out.append(logits.argmax(-1).to(torch.int32))
        st, logits = tm.forward(tp, st, out[-1][:, None],
                                torch.from_numpy(_positions(s + t, b, 1)))
    return torch.stack(out, 1).numpy()


def test_ragged_prompt_lengths(pair):
    """Mirrors tests/test_seq_state.py::test_recurrent_ragged_prompt_
    lengths: 40-token prompts (chunk 32: a ragged SSD tail) serve the
    same greedy tokens monolithic, in chunks of 16, 16, 8, and through
    the paged engine."""
    from repro_torch.serving import ServingEngine
    _, _, _, tcfg, tm, tp = pair
    assert tcfg.ssm.chunk_size == 32
    toks = prompts(tcfg.vocab_size, 2, 40, seed=2)
    mono = _port_stream(tm, tp, toks, [40])
    np.testing.assert_array_equal(_port_stream(tm, tp, toks, [16, 16, 8]),
                                  mono)
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=48, block_size=16,
                        max_slots=2, share_prefixes=False)
    rids = [eng.submit(row, GEN) for row in toks]
    outs = eng.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], mono[i])


def test_training_trajectory_matches_jax():
    """Five AdamW steps on zamba2 smoke (2 layers, one shared-block
    invocation): the loss trajectory within rtol 1e-5 of the JAX gspmd
    step's (``train_lib.make_train_step``, the function the JAX plan
    step jits, compiled at the fast XLA level)."""
    jl, tl, _, tstate = train_both(ARCH, 1, 5, 2, 32, plan_step=False)
    assert int(tstate["step"]) == 5
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)


def test_hybrid_clis_on_cpu(capsys):
    """The serving (dense and paged) and training entry points take the
    hybrid arch."""
    from repro_torch.launch import serve, train
    for impl in ("dense", "paged"):
        out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--decode-impl", impl, "--batch", "2",
                          "--prompt-len", "12", "--gen", "3"])
        assert out.shape == (2, 3)
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "paged:" in capsys.readouterr().out
