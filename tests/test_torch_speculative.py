"""The port's speculative decoding against the JAX package on the CPU
(mirrors tests/test_speculative.py): the drafters and the acceptance
rule, greedy speculative streams equal to the JAX engine's plain
streams token for token (dense at draft_k 1, 2 and 4, MoE, fp8 pools,
the hybrid's mamba rollback at three acceptance mixes, eviction replay,
a self-drafting draft model), the paged pool's rollback invariants, and
sampled speculative streams that replay bit for bit inside the port.

Weights are numpy-drawn and bridged (tests/_torch_pair.py); each JAX
plain stream is computed once per module."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_pair import build_pair  # noqa: E402

GEN = 8
SIZES = (18, 11, 25)


def _prompts(vocab, sizes, seed=23):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s).astype(np.int32) for s in sizes]


def _jax_plain(pair, prompts, **kw):
    from repro.serving import ServingEngine
    _, jm, jp, _, _, _ = pair
    eng = ServingEngine(jm, jp, n_blocks=128, block_size=8,
                        max_slots=len(prompts), **kw)
    rids = [eng.submit(p, GEN) for p in prompts]
    outs = eng.run()
    return [outs[r] for r in rids]


def _run(pair, prompts, steps_before=None, evict=None, **kw):
    from repro_torch.serving import ServingEngine
    _, _, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=128, block_size=8,
                        max_slots=len(prompts), **kw)
    rids = [eng.submit(p, GEN) for p in prompts]
    for _ in range(steps_before or 0):
        eng.step()
    if evict is not None:
        eng.evict(rids[evict])
    outs = eng.run()
    return [outs[r] for r in rids], eng


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def dense():
    pair = build_pair("codeqwen1.5-7b")
    prompts = _prompts(pair[3].vocab_size, SIZES)
    return pair, prompts, _jax_plain(pair, prompts)


@pytest.fixture(scope="module")
def hybrid():
    pair = build_pair("zamba2-1.2b")
    prompts = _prompts(pair[3].vocab_size, SIZES[:2])
    return pair, prompts, _jax_plain(pair, prompts)


# ------------------------------ drafters -----------------------------------


def test_ngram_longest_suffix_most_recent():
    from repro_torch.serving import NGramDrafter
    d = NGramDrafter(max_n=3, min_n=1)
    h = [7, 8, 9, 1, 2, 7, 8, 9, 3, 4, 5, 7, 8, 9]
    assert d.propose(0, h, 3) == [3, 4, 5]
    assert d.propose(0, [1, 2, 3, 9, 4, 9], 2) == [4, 9]
    assert d.propose(0, h, 1) == [3]
    assert d.propose(0, [1, 2, 3, 4, 5], 4) == []
    # the same proposals as the JAX drafter on a random history
    from repro.serving.speculative import NGramDrafter as JDrafter
    rng = np.random.default_rng(5)
    for _ in range(20):
        hist = rng.integers(0, 7, 48).tolist()
        assert d.propose(1, hist, 4) == JDrafter().propose(1, hist, 4)


def test_longest_accept_rule():
    from repro_torch.serving.speculative import longest_accept
    gn = np.array([5, 6, 7, 8])
    assert longest_accept(True, [5, 6, 9], gn, None, None, None) == [5, 6, 7]
    assert longest_accept(True, [1, 2, 3], gn, None, None, None) == [5]
    assert longest_accept(True, [5, 6, 7], gn, None, None, None) == \
        [5, 6, 7, 8]
    acc = np.array([True, True, False, False])
    rej = np.array([50, 51, 52, 53])
    plain = np.array([60, 61, 62, 63])
    assert longest_accept(False, [5, 6, 9], gn, acc, rej, plain) == \
        [5, 6, 52]
    assert longest_accept(False, [5, 6], gn,
                          np.array([True, True]), rej, plain) == [5, 6, 62]
    assert longest_accept(False, [], gn, acc, rej, plain) == [60]


def test_make_drafter_guards(dense):
    from repro_torch.serving import NGramDrafter, make_drafter
    (_, _, _, cfg, model, params), _, _ = dense
    assert make_drafter("off") is None
    assert isinstance(make_drafter("ngram"), NGramDrafter)
    with pytest.raises(ValueError, match="spec_mode"):
        make_drafter("bogus")
    with pytest.raises(ValueError, match="draft_model"):
        make_drafter("draft-model")
    with pytest.raises(ValueError, match="vocab"):
        make_drafter("draft-model", draft_model=model, draft_params=params,
                     target_vocab=cfg.vocab_size + 1)


def test_draft_model_rejects_recurrent_family(hybrid):
    from repro_torch.serving import DraftModelDrafter
    (_, _, _, _, model, params), _, _ = hybrid
    with pytest.raises(ValueError, match="dense-attention"):
        DraftModelDrafter(model, params)


# -------------------- greedy spec == plain decode --------------------------


@pytest.mark.parametrize("draft_k", [1, 2, 4])
def test_greedy_spec_matches_plain_dense(dense, draft_k):
    """The port's speculative stream equals the JAX engine's plain
    stream token for token."""
    from repro_torch.serving import check_schema
    pair, prompts, want = dense
    spec, eng = _run(pair, prompts, spec_mode="ngram", draft_k=draft_k)
    _same(spec, want)
    st = eng.stats
    check_schema(st)
    assert st["tokens_per_step"] >= 1.0
    assert 0.0 <= st["spec_accept_rate"] <= 1.0


def test_greedy_spec_matches_plain_moe():
    pair = build_pair("deepseekmoe-16b")
    prompts = _prompts(pair[3].vocab_size, SIZES[:2])
    want = _jax_plain(pair, prompts)
    spec, eng = _run(pair, prompts, spec_mode="ngram", draft_k=4)
    _same(spec, want)
    # smoke models greedy-decode into loops that prompt lookup predicts:
    # speculation accepts here, it does not degenerate to plain ticks
    assert eng.stats["tokens_per_step"] > 1.0


def test_greedy_spec_quantized_kv(dense):
    """fp8 pools: rolled-back entries re-quantize bit-identically, so
    the speculative stream equals JAX's plain fp8 stream."""
    pair, prompts, _ = dense
    want = _jax_plain(pair, prompts[:2], kv_dtype="float8_e4m3")
    spec, eng = _run(pair, prompts[:2], kv_dtype="float8_e4m3",
                     spec_mode="ngram", draft_k=4)
    assert eng.cache.quantized
    _same(spec, want)


def test_eviction_replay_with_spec(dense):
    """Re-speculation after an eviction reproduces the accepted stream
    (the drafter is a function of the replayed history)."""
    pair, prompts, want = dense
    spec, eng = _run(pair, prompts, spec_mode="ngram", draft_k=4,
                     steps_before=3, evict=0)
    assert eng.evictions >= 1
    _same(spec, want)


def test_self_draft_full_acceptance(dense):
    """The target as its own draft model: every draft is accepted and
    the stream is still JAX's plain stream."""
    pair, prompts, want = dense
    _, _, _, _, tm, tp = pair
    spec, eng = _run(pair, prompts[:2], spec_mode="draft-model", draft_k=4,
                     draft_model=tm, draft_params=tp)
    _same(spec, want[:2])
    assert eng.stats["spec_accept_rate"] == 1.0
    assert eng.stats["tokens_per_step"] > 1.0


def test_sampled_spec_replay_deterministic(dense):
    """Sampled speculative streams repeat bit for bit across runs and
    across an eviction replay (draws keyed by (seed, rid, position))."""
    pair, prompts, _ = dense
    kw = dict(spec_mode="ngram", draft_k=4, temperature=0.9, top_k=8,
              seed=7)
    a, _ = _run(pair, prompts[:2], **kw)
    b, _ = _run(pair, prompts[:2], **kw)
    c, eng = _run(pair, prompts[:2], steps_before=3, evict=0, **kw)
    assert eng.evictions >= 1
    _same(a, b)
    _same(a, c)
    d, _ = _run(pair, prompts[:2], **dict(kw, seed=8))
    assert any(not np.array_equal(x, y) for x, y in zip(a, d))


# ----------------------- hybrid snapshot/rollback --------------------------


class _Oracle:
    """Proposes ``good`` true continuation tokens (from a recorded
    stream) then ``junk`` wrong ones: partial acceptance, and the
    hybrid's correction pass, on every tick."""

    def __init__(self, truth, vocab, good, junk):
        self.truth, self.vocab = truth, vocab
        self.good, self.junk = good, junk

    def propose(self, rid, history, k):
        h = list(history)
        for p, toks in self.truth.items():
            if tuple(h[:len(p)]) == p:
                done = len(h) - len(p)
                prop = list(toks[done:done + min(self.good, k)])
                while len(prop) < min(self.good + self.junk, k):
                    prop.append(int(h[-1] + 1) % self.vocab)
                return prop
        return []

    def release(self, rid):
        pass


@pytest.mark.parametrize("good,junk", [(4, 0), (2, 2), (0, 3)])
def test_hybrid_mamba_rollback(hybrid, good, junk):
    """Rejected rows advanced the mamba recurrence; the correction pass
    re-advances it from the pre-verify snapshot through the accepted
    rows only: the stream equals JAX's plain stream."""
    from repro_torch.serving import ServingEngine
    (_, _, _, cfg, tm, tp), prompts, want = hybrid
    truth = {tuple(p): list(w) for p, w in zip(prompts, want)}
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=128, block_size=8,
                        max_slots=len(prompts))
    eng.drafter = _Oracle(truth, cfg.vocab_size, good, junk)
    rids = [eng.submit(p, GEN) for p in prompts]
    outs = eng.run()
    _same([outs[r] for r in rids], want)
    acc = eng.stats["spec_accept_rate"]
    if good and junk:
        assert 0.0 < acc < 1.0
    elif good:
        assert acc == 1.0
    else:
        assert acc == 0.0


# ---------------------- paged-pool rollback invariants ---------------------


def _mini_cache(**over):
    from repro_torch.serving import PagedKVCache
    kw = dict(layers=1, n_blocks=8, block_size=4, kv_heads=1, head_dim=2,
              dtype="float32", device="cpu")
    kw.update(over)
    return PagedKVCache(**kw)


def test_rollback_frees_past_boundary():
    cache = _mini_cache()
    blocks = cache.alloc(3)
    free0 = cache.num_free
    kept = cache.rollback(list(blocks), 5)      # blocks_for(5) == 2
    assert kept == blocks[:2]
    assert cache.num_free == free0 + 1
    assert cache.rollback(kept, 8) == kept      # covering table: no-op
    assert cache.num_free == free0 + 1
    cache.free(kept)
    assert cache.num_free == cache.n_blocks - 1     # scratch stays


def test_rollback_preserves_shared_refs():
    """A rollback past a shared boundary drops only this sequence's
    references; blocks a prefix entry holds survive."""
    cache = _mini_cache()
    blocks = cache.alloc(3)
    cache.incref(blocks)                 # a prefix entry's reference
    free0 = cache.num_free
    kept = cache.rollback(list(blocks), 4)      # keep 1, drop refs on 2
    assert kept == blocks[:1]
    assert cache.num_free == free0
    assert all(cache.refcount[b] == 1 for b in blocks[1:])
    assert cache.refcount[blocks[0]] == 2


def test_snapshot_rollback_cycle_conserves_pool(dense):
    """After a speculative run drains, every block is back on the free
    list."""
    pair, prompts, _ = dense
    _, eng = _run(pair, prompts, spec_mode="ngram", draft_k=4,
                  share_prefixes=False)
    assert eng.cache.num_free == eng.cache.n_blocks - 1
    assert all(r == 0 for r in eng.cache.refcount[1:])


def test_prefix_entries_survive_spec(dense):
    """Rollback never claws back blocks the prefix index holds: a second
    request restores the prompt by reference and emits the same
    stream."""
    from repro_torch.serving import ServingEngine
    pair, prompts, want = dense
    _, _, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=128, block_size=8,
                        max_slots=2, spec_mode="ngram", draft_k=4)
    r0 = eng.submit(prompts[0], GEN)
    out0 = eng.run()[r0]
    r1 = eng.submit(prompts[0], GEN)
    out1 = eng.run()[r1]
    np.testing.assert_array_equal(out0, want[0])
    np.testing.assert_array_equal(out1, want[0])
    assert eng.cache.hits == 1


def test_requantize_bit_identity():
    """``quantize_kv`` is a pure function: writing the same values twice
    (a rollback's overwrite) gives identical codes and scales, and they
    equal JAX's codes."""
    import jax.numpy as jnp

    from repro.models.attention import KV_DTYPES as JKV
    from repro.models.attention import quantize_kv as jquant
    from repro_torch.models.attention import KV_DTYPES, quantize_kv
    x = np.random.default_rng(3).standard_normal((4, 16, 2, 8)).astype(
        np.float32)
    for name in ("float8_e4m3", "int8"):
        q1, s1 = quantize_kv(torch.from_numpy(x), KV_DTYPES[name])
        q2, s2 = quantize_kv(torch.from_numpy(x), KV_DTYPES[name])
        assert torch.equal(q1.view(torch.uint8), q2.view(torch.uint8))
        assert torch.equal(s1, s2)
        jq, _ = jquant(jnp.asarray(x), JKV[name])
        np.testing.assert_array_equal(
            q1.view(torch.uint8).numpy(),
            np.asarray(jq).view(np.uint8))
