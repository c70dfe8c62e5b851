"""CRAQ — Chain Replication with Apportioned Queries (paper §VI-B3).

3FS replicates each chunk over a chain of storage targets.  Writes
propagate head -> tail (versions are *dirty* until the tail acks, then the
clean-ack propagates back); reads go to ANY replica ("write-all-read-any"
unleashes every SSD's throughput): a replica serves its clean version
directly, and resolves a dirty version by asking the tail for the committed
version number.  Failure handling: a dead target is spliced out of the
chain and writes/reads continue on the survivors.

A copy of ``repro/fs3/craq.py``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional


@dataclasses.dataclass
class _Version:
    version: int
    data: bytes
    clean: bool


class CRAQTarget:
    """One replica in a chain: versioned chunk store on a backing device."""

    def __init__(self, target_id: str, backing):
        self.id = target_id
        self.backing = backing           # StorageTarget (fs3.storage)
        self.alive = True
        self._lock = threading.RLock()   # committed() may be re-entered by
        self._meta: dict[str, list[_Version]] = {}  # read()/revive() on self
        self._recover()

    def _recover(self):
        """Rebuild the version table from the backing device: chunks on
        disk are exactly the committed writes that survived a restart
        (dirty versions never outlive the tail ack here), so a persisted
        3FS root serves checkpoints across process restarts."""
        for name in getattr(self.backing, "keys", list)():
            key, _, ver = name.rpartition(".v")
            if key and ver.isdigit():
                self._meta.setdefault(key, []).append(
                    _Version(int(ver), b"", True))

    def max_version(self) -> int:
        with self._lock:
            return max((v.version for vs in self._meta.values()
                        for v in vs), default=0)

    # -- chain protocol --

    def apply_write(self, key: str, data: bytes, version: int):
        with self._lock:
            self.backing.put(f"{key}.v{version}", data)
            self._meta.setdefault(key, []).append(
                _Version(version, b"", False))

    def mark_clean(self, key: str, version: int):
        with self._lock:
            versions = self._meta.get(key, [])
            keep = []
            for v in versions:
                if v.version == version:
                    v.clean = True
                    keep.append(v)
                elif v.version > version:
                    keep.append(v)
                else:
                    self.backing.delete(f"{key}.v{v.version}")
            self._meta[key] = keep

    def read(self, key: str, committed_version: Callable[[str], int]):
        """Apportioned query: clean -> serve; dirty -> ask tail for the
        committed version, serve that."""
        with self._lock:
            versions = self._meta.get(key)
            if not versions:
                return None
            clean = [v for v in versions if v.clean]
            all_clean = bool(clean) and len(clean) == len(versions)
            local_ver = max((v.version for v in clean), default=-1)
        if all_clean:
            ver = local_ver
        else:
            ver = committed_version(key)   # resolve dirty read at the tail
            if ver < 0:
                return None
        return self.backing.get(f"{key}.v{ver}")

    def committed(self, key: str) -> int:
        with self._lock:
            versions = [v for v in self._meta.get(key, []) if v.clean]
            dirty = [v for v in self._meta.get(key, []) if not v.clean]
            # tail commits the highest version it has seen (it applies last)
            allv = versions + dirty
            return max((v.version for v in allv), default=-1)


class CRAQChain:
    """An ordered chain of targets replicating one set of chunks."""

    def __init__(self, chain_id: int, targets: list[CRAQTarget]):
        self.id = chain_id
        self.targets = targets
        self._version = 0
        self._lock = threading.Lock()

    def _alive(self) -> list[CRAQTarget]:
        alive = [t for t in self.targets if t.alive]
        if not alive:
            raise RuntimeError(f"chain {self.id}: all replicas dead")
        return alive

    def write(self, key: str, data: bytes) -> int:
        """Head->tail propagation, then clean-ack tail->head."""
        with self._lock:
            self._version += 1
            ver = self._version
        chain = self._alive()
        for t in chain:                      # head -> tail
            t.apply_write(key, data, ver)
        for t in reversed(chain):            # tail ack -> head
            t.mark_clean(key, ver)
        return ver

    def read(self, key: str, replica_hint: int = 0) -> Optional[bytes]:
        """Read-any: pick a replica (hint spreads load), resolve via tail."""
        chain = self._alive()
        tail = chain[-1]
        t = chain[replica_hint % len(chain)]
        return t.read(key, tail.committed)

    def kill(self, target_id: str):
        for t in self.targets:
            if t.id == target_id:
                t.alive = False

    def revive(self, target_id: str):
        """Re-add a repaired target: resync clean state from the tail."""
        chain = self._alive()
        tail = chain[-1]
        for t in self.targets:
            if t.id == target_id and not t.alive:
                # resync: copy tail's committed chunks
                with tail._lock:
                    keys = {k: tail.committed(k) for k in tail._meta}
                for k, ver in keys.items():
                    data = tail.backing.get(f"{k}.v{ver}")
                    if data is not None:
                        t.apply_write(k, data, ver)
                        t.mark_clean(k, ver)
                t.alive = True
