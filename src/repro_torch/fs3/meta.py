"""3FS metadata: inode + directory-entry tables in a KV store (paper §VI-B3).

"File system meta data are stored in tables of a distributed key-value
storage system": inode table keyed by inode id (size, chunk locations,
stripe), dirent table keyed by (parent_inode, name).  Persisted as
msgpack so a meta service restart recovers all state.

Port of ``repro/fs3/meta.py``; the msgpack bytes come from the port's
own codec (``fs3/codec.py``), byte for byte those of the ``msgpack``
package, which the port does not import.
"""
from __future__ import annotations

import os
import threading

from repro_torch.fs3 import codec


class MetaService:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self._inodes: dict[int, dict] = {}
        self._dirents: dict[tuple, int] = {}
        self._next_inode = 2   # 1 == root dir
        self._inodes[1] = {"type": "dir", "size": 0}
        self._load()

    # -- persistence --

    def _db(self):
        return os.path.join(self.root, "meta.msgpack")

    def _load(self):
        try:
            with open(self._db(), "rb") as f:
                raw = codec.unpackb(f.read())
            self._inodes = {int(k): v for k, v in raw["inodes"].items()}
            self._dirents = {(int(p), n): int(i)
                             for (p, n), i in
                             [((e[0], e[1]), e[2]) for e in raw["dirents"]]}
            self._next_inode = raw["next"]
        except FileNotFoundError:
            pass

    def _persist(self):
        raw = codec.packb({
            "inodes": self._inodes,
            "dirents": [[p, n, i] for (p, n), i in self._dirents.items()],
            "next": self._next_inode,
        })
        tmp = self._db() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, self._db())

    # -- path ops --

    def _resolve(self, path: str, create_dirs=False) -> tuple[int, str]:
        parts = [p for p in path.strip("/").split("/") if p]
        parent = 1
        for name in parts[:-1]:
            key = (parent, name)
            if key not in self._dirents:
                if not create_dirs:
                    raise FileNotFoundError(path)
                ino = self._next_inode
                self._next_inode += 1
                self._inodes[ino] = {"type": "dir", "size": 0}
                self._dirents[key] = ino
            parent = self._dirents[key]
        return parent, (parts[-1] if parts else "")

    def create(self, path: str, stripe: int, chunk_size: int) -> int:
        with self._lock:
            parent, name = self._resolve(path, create_dirs=True)
            ino = self._next_inode
            self._next_inode += 1
            self._inodes[ino] = {
                "type": "file", "size": 0, "stripe": stripe,
                "chunk_size": chunk_size, "chains": [], "nchunks": 0,
            }
            self._dirents[(parent, name)] = ino
            self._persist()
            return ino

    def lookup(self, path: str):
        with self._lock:
            parent, name = self._resolve(path)
            ino = self._dirents.get((parent, name))
            if ino is None:
                raise FileNotFoundError(path)
            return ino, dict(self._inodes[ino])

    def update(self, ino: int, **fields):
        with self._lock:
            self._inodes[ino].update(fields)
            self._persist()

    def listdir(self, path: str = "/"):
        with self._lock:
            if path.strip("/"):
                parent, name = self._resolve(path)
                parent = self._dirents[(parent, name)]
            else:
                parent = 1
            return sorted(n for (p, n), _ in self._dirents.items()
                          if p == parent)

    def exists(self, path: str) -> bool:
        try:
            self.lookup(path)
            return True
        except FileNotFoundError:
            return False

    def unlink(self, path: str):
        with self._lock:
            parent, name = self._resolve(path)
            ino = self._dirents.pop((parent, name), None)
            if ino is not None:
                self._inodes.pop(ino, None)
            self._persist()
