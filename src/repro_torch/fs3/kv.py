"""3FS-KV (paper §VI-B4): key-value, message-queue and object models on top
of the 3FS client — the substrate for KV-context-caching-on-disk.

Port of ``repro/fs3/kv.py``: objects are packed by the port's msgpack
codec (``fs3/codec.py``), byte for byte as the ``msgpack`` package
packs them."""
from __future__ import annotations

import json
import threading

from repro_torch.fs3 import codec


class FS3KV:
    """Read-write-separated KV on 3FS: values are files, index is a file."""

    def __init__(self, client, namespace: str = "kv"):
        self.client = client
        self.ns = namespace
        self._lock = threading.Lock()

    def _vpath(self, key: str) -> str:
        return f"/{self.ns}/v/{key}"

    def put(self, key: str, value: bytes):
        with self._lock:
            self.client.write_file(self._vpath(key), value)

    def get(self, key: str, default=None):
        try:
            return self.client.read_file(self._vpath(key))
        except (FileNotFoundError, IOError):
            return default

    def put_obj(self, key: str, obj):
        self.put(key, codec.packb(obj))

    def get_obj(self, key: str, default=None):
        raw = self.get(key)
        return default if raw is None else codec.unpackb(raw)

    def exists(self, key: str) -> bool:
        return self.client.exists(self._vpath(key))

    def delete(self, key: str):
        with self._lock:
            self.client.unlink(self._vpath(key))

    def delete_tree(self, key_prefix: str):
        """Remove a key and everything nested under it (keys may contain
        ``/``, which the metadata service stores as directories)."""
        root = self._vpath(key_prefix.strip("/"))
        with self._lock:
            if not self.client.exists(root):
                return

            def rm(path):
                if self.client.stat(path)["type"] == "dir":
                    for name in self.client.listdir(path):
                        rm(f"{path}/{name}")
                self.client.unlink(path)

            rm(root)

    def keys(self):
        try:
            return self.client.listdir(f"/{self.ns}/v")
        except FileNotFoundError:
            return []


class FS3Queue:
    """Append-only message queue with persistent cursor."""

    def __init__(self, client, name: str = "q"):
        self.kv = FS3KV(client, namespace=f"queue_{name}")
        with self.kv._lock:
            pass
        self._mlock = threading.Lock()

    def _meta(self):
        return self.kv.get_obj("__meta__", {"head": 0, "tail": 0})

    def push(self, payload: bytes):
        with self._mlock:
            m = self._meta()
            self.kv.put(f"m{m['tail']}", payload)
            m["tail"] += 1
            self.kv.put_obj("__meta__", m)

    def pop(self):
        with self._mlock:
            m = self._meta()
            if m["head"] >= m["tail"]:
                return None
            payload = self.kv.get(f"m{m['head']}")
            m["head"] += 1
            self.kv.put_obj("__meta__", m)
            return payload

    def __len__(self):
        m = self._meta()
        return m["tail"] - m["head"]
