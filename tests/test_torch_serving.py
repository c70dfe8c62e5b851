"""The port's paged ``ServingEngine`` against the JAX package's on the CPU:
greedy streams are identical across staggered arrivals with an
eviction, chunked prefill, block sizes 4 and 16, fragmented tables and
a prefix restore (mirrors tests/test_serving.py and tests/
test_seq_state.py::test_engine_chunked_prefill_matches_dense).  Also
the allocator's invariants and replayable sampling inside the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_pair import build_pair, prompts  # noqa: E402

GEN = 6
PROMPT = 18          # not a block multiple


@pytest.fixture(scope="module")
def pair():
    return build_pair("codeqwen1.5-7b")


def _engines(pair, **kw):
    from repro.serving import ServingEngine as JEngine
    from repro_torch.serving import ServingEngine as TEngine
    _, jm, jp, _, tm, tp = pair
    return JEngine(jm, jp, **kw), TEngine(tm, tp, device="cpu", **kw)


def _both(engines, fn):
    """Run the same request script on both engines; return their
    outputs."""
    return [fn(e) for e in engines]


# Two engine configurations cover block sizes {16, 4} and prefill chunks
# {8, 0} between them (each new configuration costs the JAX side seconds
# of first-time compiles on one core).


def test_staggered_arrivals_with_eviction(pair):
    """Requests join a running batch at staggered steps while prompts
    prefill in chunks of 8 interleaved with decode ticks; one request is
    evicted mid-flight and replays."""
    ps = prompts(pair[3].vocab_size, 4, PROMPT)

    def drive(eng):
        rids = [eng.submit(p, GEN, arrival=i) for i, p in enumerate(ps)]
        eng.step()
        eng.step()
        running = [r for r in eng._slots if r is not None]
        eng.evict(running[-1].rid)
        outs = eng.run()
        assert eng.evictions >= 1
        assert eng.cache.num_free == eng.cache.n_blocks - 1
        return [outs[r] for r in rids]

    jout, tout = _both(_engines(pair, n_blocks=40, block_size=16,
                                max_slots=2, share_prefixes=False,
                                prefill_chunk=8), drive)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t, j)


def test_fragmented_tables_and_prefix_restore(pair):
    ps = prompts(pair[3].vocab_size, 3, PROMPT, seed=7)

    def drive(eng):
        # a sampled request registers no prefix, so its blocks return to
        # the free list out of order (its tokens differ by design between
        # the packages and are not compared)
        eng.submit(ps[0], GEN, temperature=1.0)
        eng.run()
        r1, r2 = eng.submit(ps[1], GEN), eng.submit(ps[2], GEN)
        eng.step()
        tables = [list(r.blocks) for r in eng._slots if r is not None]
        outs = eng.run()
        out = [outs[r1], outs[r2]]
        r3 = eng.submit(ps[1], GEN)          # restores by block reference
        out.append(eng.run()[r3])
        return out, tables, eng.cache.hits

    (jout, jtab, jhits), (tout, ttab, thits) = _both(
        _engines(pair, n_blocks=40, block_size=4, max_slots=2), drive)
    assert ttab == jtab and any(np.any(np.diff(t) != 1) for t in ttab)
    assert thits == jhits == 1
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tout[2], tout[0])


def test_paged_cache_allocator():
    from repro_torch.serving import PagedKVCache
    cache = PagedKVCache(layers=1, n_blocks=8, block_size=4, kv_heads=1,
                         head_dim=8, device="cpu")
    a = cache.alloc(3)
    b = cache.alloc(4)
    assert sorted(a + b) == list(range(1, 8))     # block 0 reserved
    assert cache.alloc(1) is None                 # exhausted
    cache.incref(a)
    cache.free(a)
    assert cache.num_free == 0                    # still referenced
    cache.free(a)
    assert cache.num_free == 3
    with pytest.raises(RuntimeError, match="double free"):
        cache.free([a[0]])
    cache.free(b)
    assert cache.num_free == 7


def test_quantized_prompt_write_and_cow_copy():
    """Quantized pools keep their per-token scales with the codes through
    the prompt write and the copy-on-write block copy."""
    from repro_torch.models.attention import quantize_kv
    from repro_torch.serving import PagedKVCache
    cache = PagedKVCache(layers=2, n_blocks=6, block_size=4, kv_heads=2,
                         head_dim=8, kv_dtype="float8_e4m3", device="cpu")
    k, v = torch.randn(2, 6, 2, 8), torch.randn(2, 6, 2, 8)
    ids = cache.alloc(2)
    cache.write_prompt(k, v, ids)
    kq, ks = quantize_kv(k, torch.float8_e4m3fn)
    got = cache.k[:, ids].reshape(2, 8, 2, 8)[:, :6]
    assert torch.equal(got.view(torch.uint8), kq.view(torch.uint8))
    assert torch.equal(cache.k_scale[:, ids].reshape(2, 8)[:, :6], ks)
    dst = cache.copy_block(ids[1])
    assert torch.equal(cache.k[:, dst].view(torch.uint8),
                       cache.k[:, ids[1]].view(torch.uint8))
    assert torch.equal(cache.v_scale[:, dst], cache.v_scale[:, ids[1]])


def test_sampled_streams_replay_after_eviction(pair):
    from repro_torch.serving import ServingEngine
    _, _, _, _, tm, tp = pair
    ps = prompts(pair[3].vocab_size, 2, PROMPT)

    def trace(seed=0, evict_at=None):
        eng = ServingEngine(tm, tp, device="cpu", n_blocks=24, block_size=16,
                            max_slots=2, temperature=0.8, top_k=20,
                            seed=seed)
        rids = [eng.submit(p, 8) for p in ps]
        if evict_at is not None:
            for _ in range(evict_at):
                eng.step()
            eng.evict(rids[0])
        outs = eng.run()
        return [outs[r] for r in rids], eng

    a, _ = trace()
    b, _ = trace()
    c, eng_c = trace(evict_at=3)
    assert eng_c.evictions == 1
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    d, _ = trace(seed=8)
    assert any(not np.array_equal(x, y) for x, y in zip(a, d))


def test_engine_stats_schema(pair):
    from repro_torch.serving import ServingEngine, check_schema
    _, _, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=16, max_slots=2)
    eng.submit(prompts(pair[3].vocab_size, 1, 9)[0], 3)
    eng.run()
    s = eng.stats
    check_schema(s)
    assert s["requests_completed"] == 1
    assert eng.request_metrics()["ttft"]["count"] == 1


def test_ttft_clock_starts_at_arrival_step(pair):
    """A request submitted ahead of its arrival step starts its TTFT and
    queue-wait clock when that step begins, not at submit()."""
    from repro_torch.serving import ServingEngine
    _, _, _, _, tm, tp = pair
    eng = ServingEngine(tm, tp, device="cpu", n_blocks=16, max_slots=2)
    ps = prompts(pair[3].vocab_size, 2, 9)
    eng.submit(ps[0], 4)
    eng.submit(ps[1], 2, arrival=2)
    late = eng._queue[1]
    assert late.t_submit is None
    eng.step()
    eng.step()
    assert late.t_submit is None and eng.step_count == 2
    eng.step()
    assert late.t_submit is not None
    assert late.t_first >= late.t_submit
    eng.run()
    assert eng.request_metrics()["ttft"]["count"] == 2
