"""Storage targets & services: local-FS-backed chunk devices (paper §VI-B2).

A production 3FS node has 16 NVMe SSDs serving multiple storage targets
each; here a target is a directory, a storage node is a set of targets,
and the batch read/write API is a thread pool (the checkpoint manager's
"batch write API ... over 10 GiB/s" analogue).

A copy of ``repro/fs3/storage.py``.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor


class StorageTarget:
    """One chunk device (dir). Keys are flat chunk names."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_"))

    def put(self, key: str, data: bytes):
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(key))

    def get(self, key: str):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self) -> list[str]:
        """Stored chunk names (recovery scan after a target restart)."""
        return [n for n in os.listdir(self.root) if not n.endswith(".tmp")]


class RequestToSend:
    """Client-side incast control (paper §VI-B3): a storage service asks the
    client for permission before transferring; the client bounds concurrent
    senders.  Modeled as a semaphore around read completions."""

    def __init__(self, max_concurrent_senders: int = 8):
        self.sem = threading.BoundedSemaphore(max_concurrent_senders)

    def __enter__(self):
        self.sem.acquire()
        return self

    def __exit__(self, *exc):
        self.sem.release()
        return False


class BatchIO:
    """Batch read/write executor shared by clients (3FS batch API)."""

    def __init__(self, workers: int = 8, max_senders: int = 8):
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.rts = RequestToSend(max_senders)

    def write_many(self, items, write_fn):
        """items: [(key, bytes)]; write_fn(key, data) -> version."""
        futs = [self.pool.submit(write_fn, k, d) for k, d in items]
        return [f.result() for f in futs]

    def read_many(self, keys, read_fn):
        def guarded(k):
            with self.rts:
                return read_fn(k)
        futs = [self.pool.submit(guarded, k) for k in keys]
        return [f.result() for f in futs]
