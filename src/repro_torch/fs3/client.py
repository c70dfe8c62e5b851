"""3FS cluster + client: chain table striping, batch IO, failover.

Layout (paper §VI-B3): the cluster manager owns a *chain table* (ordered
set of CRAQ chains over storage targets); the meta service assigns each
file an offset into the chain table and a stripe size k; chunk i of the
file lives on chain table[(offset + i) % k]-ish — here: chains[(offset +
(i % stripe)) % n_chains], and every target serves multiple chains so load
spreads over all devices.

A copy of ``repro/fs3/client.py``.
"""
from __future__ import annotations

import os
import threading

from repro_torch.fs3.craq import CRAQChain, CRAQTarget
from repro_torch.fs3.meta import MetaService
from repro_torch.fs3.storage import BatchIO, StorageTarget

DEFAULT_CHUNK = 4 * 1024 * 1024


class FS3Cluster:
    """Cluster manager: builds targets/chains, tracks liveness."""

    def __init__(self, root: str, n_nodes: int = 3, targets_per_node: int = 2,
                 replication: int = 2, io_workers: int = 8,
                 max_senders: int = 8):
        self.root = root
        self.meta = MetaService(os.path.join(root, "meta"))
        self.targets: dict[str, CRAQTarget] = {}
        tlist = []
        for n in range(n_nodes):
            for t in range(targets_per_node):
                tid = f"node{n}/t{t}"
                backing = StorageTarget(os.path.join(root, f"n{n}_t{t}"))
                tgt = CRAQTarget(tid, backing)
                self.targets[tid] = tgt
                tlist.append(tgt)
        # chain table: round-robin chains of length `replication`, offset so
        # replicas land on different *nodes*
        self.chains: list[CRAQChain] = []
        total = len(tlist)
        for i in range(total):
            members = [tlist[(i + j * targets_per_node) % total]
                       for j in range(replication)]
            # dedupe (small clusters)
            seen, uniq = set(), []
            for m in members:
                if m.id not in seen:
                    uniq.append(m)
                    seen.add(m.id)
            self.chains.append(CRAQChain(i, uniq))
        # restart recovery: resume version counters past anything the
        # targets recovered from disk, so fresh writes never collide with
        # (and lose to) a committed pre-restart version of the same key
        for chain in self.chains:
            chain._version = max(chain._version,
                                 max(t.max_version() for t in chain.targets))
        self.io = BatchIO(io_workers, max_senders)
        self._lock = threading.Lock()

    # -- failure injection / recovery (platform uses these) --

    def kill_node(self, node: int):
        for tid, t in self.targets.items():
            if tid.startswith(f"node{node}/"):
                t.alive = False

    def revive_node(self, node: int):
        for chain in self.chains:
            for t in chain.targets:
                if t.id.startswith(f"node{node}/") and not t.alive:
                    chain.revive(t.id)

    def alive_fraction(self) -> float:
        alive = sum(t.alive for t in self.targets.values())
        return alive / max(len(self.targets), 1)


class FS3Client:
    """File client: write/read whole files through chains, batch API."""

    def __init__(self, cluster: FS3Cluster, stripe: int = 4,
                 chunk_size: int = DEFAULT_CHUNK):
        self.c = cluster
        self.stripe = stripe
        self.chunk_size = chunk_size
        self._rr = 0

    def _chain_for(self, inode_meta: dict, chunk_idx: int) -> CRAQChain:
        off = inode_meta["chain_offset"]
        k = inode_meta["stripe"]
        chains = self.c.chains
        return chains[(off + (chunk_idx % k)) % len(chains)]

    def write_file(self, path: str, data: bytes) -> int:
        meta = self.c.meta
        if meta.exists(path):
            meta.unlink(path)
        ino = meta.create(path, self.stripe, self.chunk_size)
        with self.c._lock:
            off = self._rr
            self._rr = (self._rr + 1) % len(self.c.chains)
        nchunks = max(1, -(-len(data) // self.chunk_size))
        meta.update(ino, size=len(data), chain_offset=off, nchunks=nchunks)
        _, im = meta.lookup(path)

        items = []
        for i in range(nchunks):
            chunk = data[i * self.chunk_size:(i + 1) * self.chunk_size]
            items.append((f"ino{ino}_c{i}", chunk, i))

        def write_one(args):
            key, chunk, idx = args
            return self._chain_for(im, idx).write(key, chunk)

        self.c.io.write_many([(a, None) for a in items],
                             lambda a, _: write_one(a))
        return ino

    def read_file(self, path: str) -> bytes:
        meta = self.c.meta
        ino, im = meta.lookup(path)
        nchunks = im["nchunks"]

        def read_one(i):
            key = f"ino{ino}_c{i}"
            data = self._chain_for(im, i).read(key, replica_hint=i)
            if data is None:
                raise IOError(f"missing chunk {key}")
            return data

        chunks = self.c.io.read_many(list(range(nchunks)), read_one)
        return b"".join(chunks)[: im["size"]]

    # batch variants used by the checkpoint manager

    def batch_write(self, items: list[tuple[str, bytes]]):
        for path, data in items:
            self.write_file(path, data)

    def batch_read(self, paths: list[str]) -> list[bytes]:
        return [self.read_file(p) for p in paths]

    def listdir(self, path="/"):
        return self.c.meta.listdir(path)

    def exists(self, path) -> bool:
        return self.c.meta.exists(path)

    def stat(self, path) -> dict:
        """Inode metadata (``type``, ``size``, ...) for a path."""
        return self.c.meta.lookup(path)[1]

    def unlink(self, path):
        """Drop the metadata entry for a path (file or empty dir).

        Chunk garbage on the storage targets is reclaimed lazily by the
        real system's scrubber; the simulation only models the metadata
        side, which is what ``keep=`` checkpoint GC needs.
        """
        self.c.meta.unlink(path)
