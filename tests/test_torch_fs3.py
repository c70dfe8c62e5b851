"""The port's 3FS (``repro_torch.fs3``): the JAX package's
``tests/test_fs3.py`` repeated on the port's copy (chunking, CRAQ
replication, failover, metadata persistence, KV, queue), the port's
msgpack codec byte for byte against the ``msgpack`` package, and 3FS
roots written by either package read in the other."""
import os

import pytest

pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.fs3 import (FS3KV, FS3Client, FS3Cluster,  # noqa: E402
                             FS3Queue, codec)


@pytest.fixture()
def cluster(tmp_path):
    return FS3Cluster(str(tmp_path), n_nodes=3, targets_per_node=2,
                      replication=2)


@pytest.fixture()
def client(cluster):
    return FS3Client(cluster, chunk_size=1024)


def test_roundtrip_multichunk(client):
    data = os.urandom(10_000)
    client.write_file("/a/b/file.bin", data)
    assert client.read_file("/a/b/file.bin") == data


def test_overwrite(client):
    client.write_file("/f", b"one")
    client.write_file("/f", b"two" * 1000)
    assert client.read_file("/f") == b"two" * 1000


def test_failover_read_and_degraded_write(cluster, client):
    data = os.urandom(8_000)
    client.write_file("/x", data)
    cluster.kill_node(0)
    assert client.read_file("/x") == data, "replica read after node kill"
    d2 = os.urandom(3000)
    client.write_file("/y", d2)
    assert client.read_file("/y") == d2, "degraded-chain write"
    cluster.revive_node(0)
    assert client.read_file("/x") == data


def test_all_replicas_dead_raises(cluster, client):
    client.write_file("/z", b"payload")
    for n in range(3):
        cluster.kill_node(n)
    with pytest.raises(RuntimeError):
        client.read_file("/z")


def test_meta_persistence(tmp_path):
    c1 = FS3Cluster(str(tmp_path), n_nodes=2, targets_per_node=1,
                    replication=1)
    cl1 = FS3Client(c1, chunk_size=512)
    cl1.write_file("/persist/me", b"hello" * 200)
    # a fresh cluster over the same root must recover metadata
    c2 = FS3Cluster(str(tmp_path), n_nodes=2, targets_per_node=1,
                    replication=1)
    cl2 = FS3Client(c2, chunk_size=512)
    assert cl2.exists("/persist/me")
    _, meta = c2.meta.lookup("/persist/me")
    assert meta["size"] == 1000
    assert cl2.read_file("/persist/me") == b"hello" * 200


def test_listdir(client):
    client.write_file("/d/a", b"1")
    client.write_file("/d/b", b"2")
    assert client.listdir("/d") == ["a", "b"]


def test_kv_and_queue(client):
    kv = FS3KV(client)
    kv.put_obj("cfg", {"lr": 0.1, "steps": [1, 2]})
    assert kv.get_obj("cfg") == {"lr": 0.1, "steps": [1, 2]}
    assert kv.get("missing") is None
    q = FS3Queue(client, "jobs")
    q.push(b"j1")
    q.push(b"j2")
    assert len(q) == 2
    assert q.pop() == b"j1"
    assert q.pop() == b"j2"
    assert q.pop() is None


def test_kv_bytes_roundtrip(client):
    kv = FS3KV(client)
    blob = os.urandom(4096)
    kv.put("blob", blob)
    assert kv.get("blob") == blob
    kv.put("blob", b"short")                       # overwrite shrinks
    assert kv.get("blob") == b"short"
    kv.put("nested/path/key", b"deep")             # nested namespaces
    assert kv.get("nested/path/key") == b"deep"
    kv.delete_tree("nested")
    assert kv.get("nested/path/key") is None and kv.keys() == ["blob"]


def test_craq_write_then_read_from_tail(cluster):
    chain = cluster.chains[0]
    chain.write("/c/k", b"v1")
    tail_idx = len(chain.targets) - 1
    assert chain.read("/c/k", replica_hint=tail_idx) == b"v1"
    assert chain.read("/c/k", replica_hint=0) == b"v1"


def test_craq_dirty_read_resolves_at_tail(cluster):
    """A replica holding a dirty version must serve the tail's committed
    version, not its stale clean one (apportioned queries)."""
    chain = cluster.chains[0]
    chain.write("/c/k", b"old")
    alive = [t for t in chain.targets if t.alive]
    with chain._lock:
        chain._version += 1
        ver = chain._version
    for t in alive:
        t.apply_write("/c/k", b"new", ver)
    for t in reversed(alive[1:]):                  # ack stalls before head
        t.mark_clean("/c/k", ver)
    assert chain.read("/c/k", replica_hint=0) == b"new"


def test_stripe_spreads_chunks(cluster, client):
    """Chunks of one file land on multiple chains (load spreading)."""
    data = os.urandom(1024 * 8)
    client.write_file("/spread", data)
    _, im = cluster.meta.lookup("/spread")
    chains = {(im["chain_offset"] + (i % im["stripe"]))
              % len(cluster.chains) for i in range(im["nchunks"])}
    assert len(chains) >= min(im["stripe"], im["nchunks"], 2)


# ------------------------------- the codec --------------------------------

# every width boundary of each msgpack family the codec writes
_EDGES = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
          2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
          -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.1, -0.0,
          float("inf"), 1e300, "", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
          "é" * 40000, b"", b"x" * 255, b"x" * 256, b"x" * 65536, [],
          [1] * 15, [1] * 16, [0] * 65536, {}, {i: i for i in range(15)},
          {i: None for i in range(16)}, (1, "two"), bytearray(b"ab")]


def _meta_table(n):
    """The namespace as ``fs3/meta.py`` persists it, ``n`` files deep."""
    inodes = {1: {"type": "dir", "size": 0}}
    for i in range(2, n + 2):
        inodes[i] = {"type": "file", "size": 1 << (i % 40), "stripe": 4,
                     "chunk_size": 4 << 20, "chains": [],
                     "nchunks": i % 70000, "chain_offset": i % 6}
    return {"inodes": inodes,
            "dirents": [[1, f"step_{i}/chunk_{i}.bin", i]
                        for i in range(2, n + 2)],
            "next": n + 2}


@pytest.mark.parametrize("value", _EDGES + [_meta_table(40),
                                            {"head": 3, "tail": 70000}],
                         ids=lambda v: type(v).__name__)
def test_codec_bytes_equal_msgpack(value):
    raw = msgpack.packb(value)
    assert codec.packb(value) == raw
    assert codec.unpackb(raw) == msgpack.unpackb(raw, strict_map_key=False)


_leaf = (st.none() | st.booleans()
         | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
         | st.floats(allow_nan=False) | st.text(max_size=40)
         | st.binary(max_size=300))
_values = st.recursive(
    _leaf, lambda kids: st.lists(kids, max_size=20) | st.dictionaries(
        st.text(max_size=10) | st.integers(-10 ** 6, 10 ** 6), kids,
        max_size=20), max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_codec_roundtrip_matches_msgpack(value):
    raw = codec.packb(value)
    assert raw == msgpack.packb(value)
    assert codec.unpackb(raw) == msgpack.unpackb(raw, strict_map_key=False)


def test_codec_refuses_what_it_cannot_read():
    with pytest.raises(TypeError):
        codec.packb({1, 2})
    with pytest.raises(OverflowError):
        codec.packb(2 ** 64)
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb(1) + b"\x00")     # bytes after the item
    with pytest.raises(ValueError):
        codec.unpackb(b"\xd4\x01\x02")                # an extension type
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb("abc")[:-1])      # cut short


# ------------------------ roots shared with JAX ---------------------------


def _write_root(pkg, root, data):
    c = pkg.FS3Cluster(root, n_nodes=3, targets_per_node=2, replication=2)
    cl = pkg.FS3Client(c, chunk_size=1024)
    cl.write_file("/ckpt/a.bin", data)
    cl.write_file("/ckpt/a.bin", data[::-1])          # a newer version
    kv = pkg.FS3KV(cl)
    kv.put_obj("cfg", {"lr": 0.1, "steps": [1, 2], "name": "run"})
    kv.put("blob", data[:3000])
    q = pkg.FS3Queue(cl, "jobs")
    q.push(b"j1")
    q.push(b"j2")
    q.pop()


def _read_root(pkg, root):
    c = pkg.FS3Cluster(root, n_nodes=3, targets_per_node=2, replication=2)
    cl = pkg.FS3Client(c, chunk_size=1024)
    kv = pkg.FS3KV(cl)
    q = pkg.FS3Queue(cl, "jobs")
    return (cl.read_file("/ckpt/a.bin"), kv.get_obj("cfg"), kv.get("blob"),
            len(q), q.pop(), cl.listdir("/ckpt"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_root_written_by_either_package_reads_in_the_other(tmp_path, writer):
    """The namespace file is byte-identical whichever package wrote it,
    and every file, KV object and queue cursor reads in the other."""
    import repro.fs3 as jfs3
    import repro_torch.fs3 as tfs3
    data = os.urandom(5000)
    pkgs = {"jax": jfs3, "port": tfs3}
    reader = "port" if writer == "jax" else "jax"
    _write_root(pkgs[writer], str(tmp_path / "a"), data)
    # the same operations through the other package: the same namespace
    _write_root(pkgs[reader], str(tmp_path / "b"), data)
    meta = [(tmp_path / r / "meta" / "meta.msgpack").read_bytes()
            for r in ("a", "b")]
    assert meta[0] == meta[1]
    got = _read_root(pkgs[reader], str(tmp_path / "a"))
    assert got == (data[::-1], {"lr": 0.1, "steps": [1, 2], "name": "run"},
                   data[:3000], 1, b"j2", ["a.bin"])
