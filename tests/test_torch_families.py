"""The xLSTM, Whisper and VLM families of the port against the JAX
package on the CPU, in fp32 with the same numpy-drawn weights
(tests/_torch_pair.py; two layers, xLSTM's blocks "ms"):

- the mLSTM cell (chunked against its recurrent oracle and against
  JAX's, and a block prefill with a ragged tail carried from a previous
  chunk) and the sLSTM scan;
- loss and every parameter gradient against ``jax.value_and_grad``;
- greedy tokens: every chunk plan of the prompt gives the monolithic
  plan's tokens, which are JAX's; xLSTM prompts with a ragged chunk
  tail;
- the serving and training entry points on the CPU (``launch.serve``,
  ``BatchServer`` with a context-cache restore, ``launch.train`` with
  microbatches and a checkpoint resume);
- the full configs' parameter shapes, built on the meta device, equal
  JAX's ``param_defs``.

The JAX side runs its plain jnp paths; jitted JAX programs compile at
XLA's optimisation level 0 (``_torch_pair.FAST_XLA``)."""
import dataclasses as dc
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_pair import build_pair, compiled  # noqa: E402

FAMILIES = ["xlstm-125m", "whisper-base", "internvl2-76b"]
TOL = 1e-5
GEN = 5
PROMPT = 18            # not a chunk or block multiple


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: its xLSTM loops are tens
    of thousands of tiny ops, and a team of threads an op stalls on
    every op when the host's cores are shared with other test workers
    (the training CLI test ran ~90x slower so on an 8-core host with six
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(arch):
    return {"block_pattern": "ms"} if arch == "xlstm-125m" else {}


_PAIRS = {}


def _pair(arch):
    """(jcfg, jmodel, jparams, tcfg, tmodel, tparams), built once a
    module."""
    if arch not in _PAIRS:
        _PAIRS[arch] = build_pair(arch, n_layers=2, **_over(arch))
    return _PAIRS[arch]


def _close(got, want, tol=TOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, scale)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix[:-1]: np.asarray(tree)}


# ------------------------------ the cells ----------------------------------


def _cell_inputs(b=2, l=48, h=2, dh=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = mk(b, l, h, dh), mk(b, l, h, dh), mk(b, l, h, dh)
    ig = mk(b, l, h) * 2.0
    lf = np.array(jax.nn.log_sigmoid(mk(b, l, h) + 2.0))
    return q, k, v, ig, lf


def test_mlstm_chunked_matches_recurrent_and_jax():
    """The chunked mLSTM equals its token-by-token oracle (the JAX
    property test's tolerance), and JAX's chunked form within 1e-5,
    output and carried state, at l 48 in chunks of 16."""
    from repro.models.xlstm import mlstm_chunked as jchunked
    from repro_torch.models.xlstm import mlstm_chunked, mlstm_recurrent_ref
    arrs = _cell_inputs()
    t = [torch.from_numpy(a) for a in arrs]
    out, state = mlstm_chunked(*t, chunk=16)
    ref = mlstm_recurrent_ref(*t)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-3,
                               rtol=1e-4)
    jout, jstate = jax.jit(jchunked, static_argnums=5)(
        *(jnp.asarray(a) for a in arrs), 16)
    _close(out, jout, name="out")
    for name, a, b in zip("Cnm", state, jstate):
        _close(a, b, name=name)


def test_mlstm_block_prefill_ragged_tail_matches_jax():
    """An mLSTM block prefill of 24 tokens, then 40 more carried on from
    its state (chunk 16: a divisible head of 32 and a ragged tail of 8),
    against JAX's on the same weights: outputs and the states (C, n, m
    and the conv window)."""
    from repro.models import xlstm as jx
    from repro_torch.models import xlstm as tx
    jcfg, _, jp, tcfg, _, tp = _pair("xlstm-125m")
    jcfg = dc.replace(jcfg, ssm=dc.replace(jcfg.ssm, chunk_size=16))
    tcfg = dc.replace(tcfg, ssm=dc.replace(tcfg.ssm, chunk_size=16))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32)

    def jrun(p, x):
        y1, st = jx.mlstm_block_prefill(jcfg, p, x[:, :24])
        y2, st = jx.mlstm_block_prefill(jcfg, p, x[:, 24:], state=st)
        return jnp.concatenate([y1, y2], 1), st
    jp0 = jp["block_0"]
    jy, jst = compiled(jrun, jp0, jnp.asarray(x))(jp0, jnp.asarray(x))
    xt = torch.from_numpy(x)
    y1, st = tx.mlstm_block_prefill(tcfg, tp["block_0"], xt[:, :24])
    y2, st = tx.mlstm_block_prefill(tcfg, tp["block_0"], xt[:, 24:],
                                    state=st)
    _close(torch.cat([y1, y2], 1), jy, name="y")
    for k in ("C", "n", "m", "conv"):
        _close(st[k], jst[k], name=k)


def test_slstm_scan_matches_jax():
    """The sLSTM scan (recurrent term R included) against JAX's, from a
    fresh state and continued from a carried one."""
    from repro.models.xlstm import slstm_scan as jscan
    from repro_torch.models.xlstm import slstm_scan
    rng = np.random.default_rng(1)
    b, l, h, dh = 2, 20, 2, 8
    gates = [rng.standard_normal((b, l, h, dh)).astype(np.float32)
             for _ in range(4)]
    R = (rng.standard_normal((4, h, dh, dh)) * 0.3).astype(np.float32)

    def jrun(z, i, f, o, R):
        y1, st = jscan(z[:, :7], i[:, :7], f[:, :7], o[:, :7], R)
        y2, st = jscan(z[:, 7:], i[:, 7:], f[:, 7:], o[:, 7:], R, state=st)
        return jnp.concatenate([y1, y2], 1), st
    ja = [jnp.asarray(a) for a in (*gates, R)]
    jy, jst = jax.jit(jrun)(*ja)
    tg = [torch.from_numpy(a) for a in gates]
    y1, st = slstm_scan(*(g[:, :7] for g in tg), torch.from_numpy(R))
    y2, st = slstm_scan(*(g[:, 7:] for g in tg), torch.from_numpy(R),
                        state=st)
    _close(torch.cat([y1, y2], 1), jy, name="h")
    for name, a, c in zip("cnmh", st, jst):
        _close(a, c, name=name)


# ---------------------------- loss and grads --------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """Loss within 1e-5 relative and every gradient leaf within 1e-5 of
    its max |g|, with a loss mask; the port runs with remat (each block
    or layer recomputed in the backward), as JAX's loss does."""
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.train_lib import loss_and_grads
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch)
    batch = batch_for_model(tcfg, "train", 0, 2, 64)
    s = batch["tokens"].shape[1]
    batch["mask"] = (np.arange(s) < [[s], [s - 5]]).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = compiled(jax.value_and_grad(jm.loss, has_aux=True),
                              jp, jb)(jp, jb)
    tl, tmet, tg = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tmet) == set(jmet)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=0)
    got, want = _leaves(tg), _leaves(jg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        _close(got[name], w, name=name)


# ----------------------------- greedy tokens --------------------------------


def _prefill_batch(cfg, n=2, length=PROMPT, seed=0):
    from repro_torch.data.synthetic import batch_for_model
    return batch_for_model(cfg, "prefill", seed, n, length)


def _generate(model, params, batch, plan, gen=GEN):
    """Prefill through the chunk plan, then ``gen`` greedy tokens, all
    through ``forward``."""
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tokens, positions, embeds = model.prompt_inputs(params, batch)
    b, s = positions.shape
    state = model.init_seq_state(params, s + gen, batch=batch,
                                 batch_size=b, dtype="float32")
    off = 0
    for i, c in enumerate(plan):
        tk = None if tokens is None else tokens[:, off:off + c]
        em = None if embeds is None else embeds[:, off:off + c]
        state, logits = model.forward(params, state, tk,
                                      positions[:, off:off + c],
                                      embeds=em, fresh=i == 0)
        off += c
    assert off == s
    toks = logits.argmax(-1).to(torch.int32)
    out = [toks.numpy()]
    for i in range(gen - 1):
        pos = torch.full((b, 1), s + i, dtype=torch.int32)
        state, logits = model.forward(params, state, toks[:, None], pos)
        toks = logits.argmax(-1).to(torch.int32)
        out.append(toks.numpy())
    return np.stack(out, 1)


def _generate_jax(model, params, batch, gen=GEN):
    """JAX's monolithic prefill + greedy decode (forward compiled at
    XLA's level 0, once for the prompt and once for a tick)."""
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    tokens, positions, embeds = model.prompt_inputs(params, batch)
    b, s = positions.shape
    state = model.init_seq_state(params, s + gen, batch=batch,
                                 batch_size=b, dtype="float32")

    def fwd(fresh):
        return lambda p, st, tk, pos, em: model.forward(
            p, st, tk, pos, embeds=em, fresh=fresh)
    pre = compiled(fwd(True), params, state, tokens, positions, embeds)
    state, logits = pre(params, state, tokens, positions, embeds)
    toks = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [np.asarray(toks)]
    pos = jnp.full((b, 1), s, jnp.int32)
    tick = compiled(fwd(False), params, state, toks[:, None], pos, None)
    for i in range(gen - 1):
        pos = jnp.full((b, 1), s + i, jnp.int32)
        state, logits = tick(params, state, toks[:, None], pos, None)
        toks = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(toks))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_chunk_plans_give_jax_greedy_tokens(arch):
    """Greedy tokens are invariant to how the prompt is chunked (the
    whole prompt, one token a chunk, 16 then the rest; the VLM's
    patches count as prompt rows) and equal JAX's."""
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch)
    batch = _prefill_batch(tcfg)
    s = tm.prompt_length({k: torch.from_numpy(v)
                          for k, v in batch.items()})
    mono = _generate(tm, tp, batch, [s])
    for plan in ([1] * s, [16, s - 16]):
        np.testing.assert_array_equal(
            mono, _generate(tm, tp, batch, plan),
            err_msg=f"{arch}: plan {plan[0]}x{len(plan)}")
    np.testing.assert_array_equal(mono, _generate_jax(jm, jp, batch))


def test_xlstm_ragged_prompt_lengths():
    """Prompts longer than the mLSTM chunk and not a multiple of it (40
    against chunk 32) serve monolithic and chunked alike."""
    _, _, _, tcfg, tm, tp = _pair("xlstm-125m")
    assert tcfg.ssm.chunk_size == 32
    batch = _prefill_batch(tcfg, length=40)
    np.testing.assert_array_equal(_generate(tm, tp, batch, [40]),
                                  _generate(tm, tp, batch, [16, 16, 8]))


# ------------------------------ entry points --------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_and_batch_server(arch):
    """``launch.serve --smoke --device cpu`` generates; ``BatchServer``
    gives the dense launcher's tokens on the same model and batch, and a
    context-cache hit (restored onto the server's meta-device template:
    Whisper's encoder does not run there) gives them again; the paged
    engine refuses the family, as JAX's does."""
    from repro_torch.launch import serve
    from repro_torch.serve_lib import BatchServer, KVContextCache
    from repro_torch.serving import ServingEngine
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "6"])
    assert gen.shape == (2, 6) and (gen >= 0).all()
    _, _, _, tcfg, tm, tp = _pair(arch)
    batch = _prefill_batch(tcfg, length=16, seed=3)
    ref = serve._serve_dense(tm, tp, batch,
                             types.SimpleNamespace(gen=6, metrics=False),
                             torch.device("cpu"))
    store = {}
    ctx = KVContextCache(types.SimpleNamespace(get=store.get,
                                               put=store.__setitem__))
    server = BatchServer(tm, tp, ctx, device="cpu")
    out1, _ = server.serve(batch, gen=6)
    out2, info = server.serve(batch, gen=6)
    assert ctx.misses == 1 and ctx.hits == 1 and info["hit_rate"] == 0.5
    np.testing.assert_array_equal(out1, ref)
    np.testing.assert_array_equal(out2, ref)
    with pytest.raises(ValueError, match="family"):
        ServingEngine(tm, tp, device="cpu", n_blocks=8)


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_context_cache_tells_frames_and_patches_apart(arch):
    """Two batches with the same tokens and other frames (Whisper) or
    patches (VLM; drawn at unit scale, 50x the synthetic batch's, so
    that the greedy tokens tell them apart at the smoke width): the
    second is a context-cache miss and gives its own prefill's tokens,
    which differ from the first batch's."""
    from repro_torch.launch import serve
    from repro_torch.serve_lib import BatchServer, KVContextCache
    _, _, _, tcfg, tm, tp = _pair(arch)
    first = _prefill_batch(tcfg, length=16, seed=3)
    side = "frames" if "frames" in first else "patches"
    second = dict(first, **{side: 50 * _prefill_batch(tcfg, length=16,
                                                      seed=4)[side]})
    args = types.SimpleNamespace(gen=6, metrics=False)
    want = serve._serve_dense(tm, tp, second, args, torch.device("cpu"))
    store = {}
    ctx = KVContextCache(types.SimpleNamespace(get=store.get,
                                               put=store.__setitem__))
    server = BatchServer(tm, tp, ctx, device="cpu")
    out1, _ = server.serve(first, gen=6)
    out2, _ = server.serve(second, gen=6)
    assert ctx.misses == 2 and ctx.hits == 0 and len(store) == 2
    np.testing.assert_array_equal(out2, want)
    assert not np.array_equal(out1, out2)


def test_train_cli_lowers_xlstm_loss():
    """``launch.train --smoke --device cpu`` on xlstm-125m lowers the
    loss (the JAX integration test's setting)."""
    from repro_torch.launch.train import main
    losses = main(["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
                   "--steps", "15", "--batch", "4", "--seq", "64", "--lr",
                   "3e-3", "--log-every", "100"])
    assert len(losses) == 15
    assert losses[-1] < losses[0] - 0.05, (losses[0], losses[-1])


def test_train_cli_microbatches_and_resumes_whisper(tmp_path):
    """Whisper's nested parameter tree (encoder, enc_final, decoder)
    through the training launcher with 2 microbatches a step (frames
    sliced with the tokens), a 3FS checkpoint each step and a resume:
    the resumed step's loss equals the straight run's bitwise."""
    from repro_torch.launch.train import main
    args = ["--arch", "whisper-base", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--microbatch", "2",
            "--log-every", "100"]
    straight = main(args + ["--steps", "3"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-fs3", "--ckpt-every", "1"]
    main(args + ck + ["--steps", "2"])
    resumed = main(args + ck + ["--steps", "3", "--resume"])
    assert len(straight) == 3 and resumed == straight[2:]


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_config_param_shapes_match_jax(arch):
    """The full config's parameter tree, built on the meta device, has
    JAX's keys and shapes."""
    from repro.configs.registry import get_arch as jget
    from repro.models import build_model as jbuild
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_map
    tm = build_model(get_arch(arch))
    meta = tree_map(lambda d: torch.empty(d.shape, device="meta"),
                    tm.param_defs())
    got = {k: tuple(v.shape) for k, v in _leaves_meta(meta).items()}
    want = {k: tuple(v.shape)
            for k, v in _leaves_meta(jbuild(jget(arch)).param_defs()).items()}
    assert got == want


def _leaves_meta(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves_meta(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
