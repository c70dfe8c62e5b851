"""The port's disaggregated serving against the JAX package on the CPU
(mirrors tests/test_cluster.py, tests/test_fs3.py's prefix-store tests,
tests/test_serve_cache.py and tests/test_kv_quant.py's engine tests):
cluster streams equal the JAX monolithic engine's token for token
(staggered, with an eviction, with speculation on the decode leg), the
cross-replica 3FS prefix-store hit in bf16 and fp8, prefix artifacts
byte-identical to the JAX store's in both directions, the handoff's
t_submit, one stats schema across ``BatchServer``, the engine and the
cluster, ``serve_lib``'s context cache, and quantized engines'
determinism and e4m3 prefix-restore bit identity.

Weights are numpy-drawn and bridged (tests/_torch_pair.py); each JAX
stream is computed once per module."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")

from _torch_pair import build_pair  # noqa: E402

GEN = 8
SIZES = (13, 21, 9, 17)          # 21: a copy-on-write tail at block 16
ENGINE = dict(n_blocks=64, block_size=16, max_slots=4)


def _jax_mono(pair, prompts, **kw):
    from repro.serving import ServingEngine
    eng = ServingEngine(pair[1], pair[2], **{**ENGINE, **kw})
    rids = [eng.submit(p, GEN) for p in prompts]
    outs = eng.run()
    return [outs[r] for r in rids]


@pytest.fixture(scope="module")
def setup():
    pair = build_pair("codeqwen1.5-7b")
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, pair[3].vocab_size, s).astype(np.int32)
               for s in SIZES]
    return pair, prompts, _jax_mono(pair, prompts)


@pytest.fixture(scope="module")
def fp8_ref(setup):
    pair, prompts, _ = setup
    return _jax_mono(pair, prompts[:2], kv_dtype="float8_e4m3")


def _cluster(pair, **kw):
    from repro_torch.serving import ServingCluster
    kw.setdefault("engine_kwargs", dict(ENGINE))
    return ServingCluster(pair[4], pair[5], device="cpu", **kw)


def _engine(pair, **kw):
    from repro_torch.serving import ServingEngine
    return ServingEngine(pair[4], pair[5], device="cpu", **{**ENGINE, **kw})


def _store(tmp_path, tag, **kw):
    from repro_torch.fs3 import FS3KV, FS3Client, FS3Cluster
    from repro_torch.serving import FS3PrefixStore
    kw = {**dict(n_nodes=3, targets_per_node=2, replication=2), **kw}
    return FS3PrefixStore(FS3KV(FS3Client(FS3Cluster(str(tmp_path), **kw))),
                          tag=tag)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------- cluster end-to-end ----------------------------


def test_cluster_matches_monolithic_staggered(setup):
    """2P+2D serving is a refactor of the compute: greedy streams equal
    the JAX monolithic engine's for requests arriving staggered."""
    from repro_torch.serving import check_schema
    pair, prompts, want = setup
    clu = _cluster(pair, prefill_replicas=2, decode_replicas=2)
    crids = [clu.submit(p, GEN, arrival=2 * i) for i, p in enumerate(prompts)]
    outs = clu.run()
    _same([outs[c] for c in crids], want)
    s = clu.stats()
    check_schema(s)
    assert s["requests_completed"] == len(prompts)
    log = clu.request_metrics()["requests"]
    assert all(e["decode_replica"] >= 0 for e in log)
    assert {e["prefill_replica"] for e in log} == {0, 1}
    assert all(e["ttft_s"] is not None and e["ttft_s"] >= 0 for e in log)


def test_cluster_eviction_recovers_tokens(setup):
    """An eviction on a decode replica replays deterministically."""
    pair, prompts, want = setup
    clu = _cluster(pair, prefill_replicas=2, decode_replicas=2)
    crids = [clu.submit(p, GEN) for p in prompts[:2]]
    for _ in range(200):
        clu.step()
        if any(c.crid == crids[0] for c in clu._dc_inflight.values()):
            break
    else:
        pytest.fail("request never reached a decode replica")
    clu.evict(crids[0])
    outs = clu.run()
    _same([outs[c] for c in crids], want[:2])
    assert clu.stats()["evictions"] >= 1


def test_cluster_spec_decode_leg(setup):
    """Speculation on the decode replicas: the streams stay the JAX
    plain engine's, and the cluster stats carry the decode leg's tokens
    per step and acceptance."""
    from repro_torch.serving import check_schema
    pair, prompts, want = setup
    clu = _cluster(pair, prefill_replicas=1, decode_replicas=2,
                   decode_engine_kwargs=dict(spec_mode="ngram", draft_k=4))
    crids = [clu.submit(p, GEN) for p in prompts[:3]]
    outs = clu.run()
    _same([outs[c] for c in crids], want[:3])
    st = clu.stats()
    check_schema(st)
    assert st["tokens_per_step"] > 1.0
    assert "spec_accept_rate" in st
    for name, sub in st["replicas"].items():
        assert ("spec_accept_rate" in sub) == name.startswith("decode")


@pytest.mark.parametrize("kv_dtype", [None, "float8_e4m3"])
def test_cross_replica_prefix_store_hit(setup, fp8_ref, tmp_path, kv_dtype):
    """A prefix prefilled on one replica and written back to the 3FS
    store on a flush warms the other replica's cold prefill: the stream
    equals JAX's cold run and one store hit is counted (fp8: the
    artifact carries the scale rows)."""
    pair, prompts, want = setup
    cold = (want if kv_dtype is None else fp8_ref)[1]
    store = _store(tmp_path, "q" if kv_dtype else "test")
    clu = _cluster(pair, prefill_replicas=2, decode_replicas=1,
                   prefix_store=store,
                   engine_kwargs=dict(ENGINE, kv_dtype=kv_dtype))
    first = clu.submit(prompts[1], GEN)
    np.testing.assert_array_equal(clu.run()[first], cold)
    assert clu.flush_prefixes() >= 1
    assert store.publishes >= 1
    hits0 = [e._c_store_hits.value for e in clu.prefill_engines]
    second = clu.submit(prompts[1], GEN)      # round robin: the other one
    np.testing.assert_array_equal(clu.run()[second], cold)
    hits1 = [e._c_store_hits.value for e in clu.prefill_engines]
    assert sum(hits1) == sum(hits0) + 1, (hits0, hits1)
    assert clu.stats()["store_hits"] == sum(hits1)


def test_submit_prefilled_zero_t_submit(setup):
    """A t_submit of 0.0 in a handoff artifact survives the import; a
    missing one defaults to now; the decode leg emits the JAX stream."""
    pair, prompts, want = setup
    pf = _engine(pair, max_slots=1, prefill_role=True)
    rid = pf.submit(prompts[0], 1, keep_blocks=True)
    while rid not in pf._done:
        pf.step()
    art = pf.export_request(rid)
    assert pf.cache.num_free == pf.cache.n_blocks - 1 - len(
        pf.cache._prefix[next(iter(pf.cache._prefix))][0])
    art["t_submit"] = 0.0
    dec = _engine(pair, max_slots=1)
    drid = dec.submit_prefilled(art, GEN)
    assert dec._queue[-1].t_submit == 0.0
    art2 = dict(art, t_submit=None)
    drid2 = dec.submit_prefilled(art2, GEN)
    assert dec._queue[-1].t_submit is not None
    assert dec._queue[-1].t_submit > 0.0
    outs = dec.run()
    np.testing.assert_array_equal(outs[drid], want[0])
    np.testing.assert_array_equal(outs[drid2], want[0])


# ------------------------------ stats schema -------------------------------


def test_unified_schema_across_backends(setup):
    """``ServingEngine.stats``, ``BatchServer.stats`` (dense, engine-less)
    and ``ServingCluster.stats()`` satisfy one schema, the cluster's
    nested replicas included; the plain engine reports one token a step
    and no acceptance rate."""
    from repro_torch.serve_lib import BatchServer
    from repro_torch.serving import check_schema
    pair, prompts, _ = setup
    eng = _engine(pair, n_blocks=16, max_slots=2)
    check_schema(eng.stats)
    assert eng.stats["tokens_per_step"] == 1.0
    assert "spec_accept_rate" not in eng.stats
    srv = BatchServer(pair[4], pair[5], None, device="cpu")
    check_schema(srv.stats)
    srv.serve({"tokens": prompts[0][None]}, gen=4)
    check_schema(srv.stats)
    assert srv.stats["tokens_per_step"] == 1.0
    clu = _cluster(pair, prefill_replicas=1, decode_replicas=1)
    s = clu.stats()
    check_schema(s)
    assert set(s["replicas"]) == {"prefill0", "decode0"}


# ------------------------------ prefix store --------------------------------


def _caches(kv_dtype):
    from repro.serving.paged_cache import PagedKVCache as JCache
    from repro_torch.serving import PagedKVCache as TCache
    kw = dict(layers=2, n_blocks=8, block_size=4, kv_heads=2, head_dim=8,
              dtype="float32", kv_dtype=kv_dtype)
    return JCache(**kw), TCache(device="cpu", **kw)


def _artifact(jcache, ids, seed):
    """Deterministic block contents written through the JAX import path,
    exported as the JAX store publishes them."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    shape = (jcache.k.shape[0], len(ids)) + jcache.k.shape[2:]
    data = {"k": rng.standard_normal(shape, np.float32),
            "v": rng.standard_normal(shape, np.float32)}
    if jcache.quantized:
        sshape = shape[:2] + (jcache.block_size,)
        data = {"k": np.asarray(jnp.asarray(data["k"], jcache.k.dtype)),
                "v": np.asarray(jnp.asarray(data["v"], jcache.v.dtype)),
                "k_scale": rng.random(sshape, np.float32) + 0.5,
                "v_scale": rng.random(sshape, np.float32) + 0.5}
    jcache.import_blocks(ids, data)
    return {"length": 11, "first_token": 7,
            "blocks": jcache.export_blocks(ids), "extras": {}}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("kv_dtype", [None, "float8_e4m3"])
def test_prefix_store_publish_fetch_bit_identical(tmp_path, kv_dtype):
    """A prefix the JAX store publishes on a 3FS root fetches into the
    port and imports bit for bit (fp8 codes and scale rows included);
    the port republishes it on its own root byte for byte as JAX wrote
    it, and the JAX store fetches and imports that."""
    from repro.fs3 import FS3KV as JKV, FS3Client as JClient
    from repro.fs3 import FS3Cluster as JCluster
    from repro.serving import FS3PrefixStore as JStore
    from repro.serving.prefix_store import _enc as jenc
    from repro_torch.serving.prefix_store import _enc
    jcache, tcache = _caches(kv_dtype)
    art = _artifact(jcache, jcache.alloc(3), seed=5)
    root = str(tmp_path / "jax")
    cl = dict(n_nodes=3, targets_per_node=2, replication=2)
    jstore = JStore(JKV(JClient(JCluster(root, **cl))), tag="t0")
    jstore.publish("deadbeef", art)
    raw = jstore.kv.get("prefix_t0/deadbeef")
    assert raw == msgpack.packb(jenc(art))

    tstore = _store(root, "t0", **cl)         # the same root, the port's
    got = tstore.fetch("deadbeef")
    assert got["length"] == 11 and got["first_token"] == 7
    assert tstore.fetch("cafebabe") is None and tstore.misses == 1
    ids = tcache.alloc(3)
    tcache.import_blocks(ids, got["blocks"])
    back = tcache.export_blocks(ids)
    assert list(back) == list(art["blocks"])
    for name, ref in art["blocks"].items():
        assert back[name].shape == ref.shape
        np.testing.assert_array_equal(_bits(back[name]), _bits(ref))

    # the port publishes the same contents: the JAX bytes, and JAX reads
    # them back into its own pool bitwise
    tart = {"length": 11, "first_token": 7, "blocks": back, "extras": {}}
    from repro_torch.fs3.codec import packb
    assert packb(_enc(tart)) == raw
    proot = str(tmp_path / "port")
    _store(proot, "t0", **cl).publish("deadbeef", tart)
    jback = JStore(JKV(JClient(JCluster(proot, **cl))),
                   tag="t0").fetch("deadbeef")
    jc2, _ = _caches(kv_dtype)
    ids2 = jc2.alloc(3)
    jc2.import_blocks(ids2, jback["blocks"])
    for name, ref in jc2.export_blocks(ids2).items():
        np.testing.assert_array_equal(_bits(ref), _bits(art["blocks"][name]))


def test_prefix_store_tag_namespaces(tmp_path):
    """Different tags are disjoint key spaces."""
    _, tcache = _caches(None)
    ids = tcache.alloc(1)
    store_a = _store(tmp_path, "gen0")
    store_b = type(store_a)(store_a.kv, tag="gen1")
    store_a.publish("k", {"length": 4, "first_token": 1,
                          "blocks": tcache.export_blocks(ids),
                          "extras": {}})
    assert store_b.fetch("k") is None
    assert store_a.fetch("k") is not None


# ------------------------------- serve_lib ----------------------------------


@pytest.fixture(scope="module")
def ctx_kv(tmp_path_factory):
    from repro_torch.fs3 import FS3KV, FS3Client, FS3Cluster
    root = tmp_path_factory.mktemp("fs3kv")
    return FS3KV(FS3Client(FS3Cluster(str(root), n_nodes=2,
                                      targets_per_node=1, replication=2),
                           chunk_size=1 << 16))


def _batch(cfg, seed):
    from repro_torch.data.synthetic import batch_for_model
    return {"tokens": batch_for_model(cfg, "prefill", seed, 2, 16)["tokens"]}


def test_cache_miss_then_hit_equals_jax_decode(setup, ctx_kv):
    """A context-cache miss then hit give the same tokens, and they are
    the JAX ``BatchServer``'s dense lockstep tokens."""
    import jax.numpy as jnp

    from repro.serve_lib import BatchServer as JServer
    from repro_torch.serve_lib import BatchServer, KVContextCache
    pair, _, _ = setup
    batch = _batch(pair[3], 3)
    ctx = KVContextCache(ctx_kv)
    server = BatchServer(pair[4], pair[5], ctx, device="cpu")
    out1, _ = server.serve(batch, gen=5)
    assert ctx.misses == 1 and ctx.hits == 0
    out2, info = server.serve(batch, gen=5)
    assert ctx.hits == 1 and info["hit_rate"] > 0
    np.testing.assert_array_equal(out1, out2)
    ref, _ = JServer(pair[1], pair[2], None).serve(
        {"tokens": jnp.asarray(batch["tokens"])}, gen=5)
    np.testing.assert_array_equal(out1, np.asarray(ref))
    other = BatchServer(pair[4], pair[5], ctx, device="cpu")
    other.serve(_batch(pair[3], 11), gen=4)
    assert ctx.misses == 2


def test_pack_tree_bytes_equal_jax():
    """A context-cache entry packs to the JAX package's bytes (leaves in
    sorted-key order, numpy's dtype names) and unpacks onto a template
    of another dtype as JAX's does."""
    from repro.serve_lib import _pack_tree as jpack
    from repro_torch.serve_lib import _pack_tree, _unpack_tree
    rng = np.random.default_rng(2)
    tree = {"v": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "k": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "mamba": [{"ssm": rng.standard_normal((1, 2)).astype(
                np.float32), "conv": np.arange(6, dtype=np.int32)}]}
    ttree = {"v": torch.from_numpy(tree["v"]),
             "k": torch.from_numpy(tree["k"]),
             "mamba": [{k: torch.from_numpy(v)
                        for k, v in tree["mamba"][0].items()}]}
    raw = _pack_tree(ttree)
    assert raw == jpack(tree)
    tmpl = {"k": torch.empty(2, 3, 4, dtype=torch.bfloat16, device="meta"),
            "v": torch.empty(2, 3, 4), "mamba": [
                {"ssm": torch.empty(1, 2), "conv": torch.empty(6)}]}
    back = _unpack_tree(raw, tmpl)
    assert back["k"].dtype == torch.bfloat16 and back["k"].device.type == \
        "cpu"
    assert torch.equal(back["v"], ttree["v"])
    assert torch.equal(back["mamba"][0]["conv"],
                       ttree["mamba"][0]["conv"].float())


def test_batch_server_paged_matches_dense(setup):
    """The paged path of ``BatchServer`` emits the dense path's
    tokens."""
    from repro_torch.serve_lib import BatchServer
    pair, _, _ = setup
    batch = _batch(pair[3], 4)
    dense, _ = BatchServer(pair[4], pair[5], None, device="cpu").serve(
        batch, gen=5)
    srv = BatchServer(pair[4], pair[5], None, device="cpu",
                      decode_impl="paged", gen_slots=2,
                      engine_kwargs=dict(n_blocks=16, block_size=16))
    paged, st = srv.serve(batch, gen=5)
    np.testing.assert_array_equal(dense, paged)
    assert st["requests_completed"] == 2


# ------------------------- quantized engines (A0) ---------------------------


@pytest.mark.parametrize("kv_dtype", ["float8_e4m3", "int8"])
def test_quantized_engine_deterministic(setup, kv_dtype):
    """Greedy decode with quantized pools is a function of (params,
    prompt): two engines give identical tokens (mirrors
    tests/test_kv_quant.py:77)."""
    from repro_torch.models.attention import KV_DTYPES
    pair, prompts, _ = setup

    def run():
        eng = _engine(pair, max_slots=2, kv_dtype=kv_dtype)
        rids = [eng.submit(p, GEN) for p in prompts[:2]]
        outs = eng.run()
        return eng, [outs[r] for r in rids]
    eng, a = run()
    assert eng.cache.quantized
    assert eng.cache.k.dtype == KV_DTYPES[kv_dtype]
    assert eng.cache.k_scale.shape == eng.cache.k.shape[:3]
    _, b = run()
    _same(a, b)


def test_prefix_restore_bit_identical_e4m3(setup, fp8_ref):
    """A prefix restore carries the per-token scales with the shared and
    copy-on-write blocks: restored and cold continuations equal JAX's
    cold fp8 stream (mirrors tests/test_kv_quant.py:91)."""
    pair, prompts, _ = setup
    eng = _engine(pair, max_slots=2, kv_dtype="float8_e4m3")
    r1 = eng.submit(prompts[1], GEN)                  # 21 tokens: COW tail
    first = eng.run()[r1]
    r2 = eng.submit(prompts[1], GEN)
    second = eng.run()[r2]
    assert eng.cache.hits == 1
    np.testing.assert_array_equal(first, fp8_ref[1])
    np.testing.assert_array_equal(second, fp8_ref[1])


def test_hybrid_extras_travel_in_handoff_and_store(tmp_path):
    """The hybrid's mamba states ride in the handoff artifact and in the
    published prefix: a zamba2 cluster's streams, and a store-warmed
    second request's, equal the port's monolithic engine's (itself held
    against JAX in tests/test_torch_hybrid_model.py)."""
    from repro_torch.serving import ServingCluster, ServingEngine
    pair = build_pair("zamba2-1.2b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, pair[3].vocab_size, s).astype(np.int32)
               for s in (13, 21)]
    mono = ServingEngine(pair[4], pair[5], device="cpu", **ENGINE)
    rids = [mono.submit(p, GEN) for p in prompts]
    outs = mono.run()
    want = [outs[r] for r in rids]
    store = _store(tmp_path, "hy")
    clu = ServingCluster(pair[4], pair[5], device="cpu", prefill_replicas=2,
                         decode_replicas=1, prefix_store=store,
                         engine_kwargs=dict(ENGINE))
    crids = [clu.submit(p, GEN) for p in prompts]
    got = clu.run()
    _same([got[c] for c in crids], want)
    assert clu.flush_prefixes() >= 2
    again = clu.submit(prompts[1], GEN)
    np.testing.assert_array_equal(clu.run()[again], want[1])
    assert clu.stats()["store_hits"] == 1
