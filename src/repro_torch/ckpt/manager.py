"""Checkpoint manager (port of ``repro/ckpt/manager.py``; paper §VII-A,
DESIGN.md §13).

Structure, as in the JAX package:
  * state is copied to host on the caller's thread, then a background
    thread packs and writes it — training never blocks on storage;
  * tensors are packed into fixed-size *chunks*; every tensor records its
    (chunk, offset, size, shape, dtype) in the index;
  * saves are atomic (index written last, then the ``latest`` pointer);
  * periodic policy: ``maybe_save(step)`` every ``period_s`` (default
    300 s — the paper's 5 minutes) on an injectable clock;
  * backend: local directory (default) or 3FS via :func:`fs3_backend`;
    ``keep=`` GC holds on both.

The byte layout is the JAX package's: ``step_N/chunk_K.bin`` holds the
raw bytes of the tensors in sorted-key order (``params/blocks/...``
names), ``index.json`` names each dtype as numpy spells it
(``bfloat16``, ``float8_e4m3fn``, ``int32``; ``DTYPE_NAMES``, the
port's own table, no ``ml_dtypes``), a 0-d leaf has shape ``[]``.  For
the same state the files are byte-identical to the JAX package's, so a
checkpoint written by either package restores bitwise in the other.
The stored dtype is authoritative on read; restore then casts to the
template's dtype.

The port updates the training state in place (``optim.AdamW``), so the
snapshot is a copy, complete before ``save`` returns: CUDA tensors go to
pinned host memory (``host_copy``) and the copy is synchronised; host
tensors are cloned.  A step taken
right after ``save(..., blocking=False)`` cannot change what is written.
``seconds`` holds the last save's time on the caller's thread
(``"d2h"``), its background write (``"write"``) and the last restore
(``"restore"``).
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch import telemetry
from repro_torch.telemetry import span

# torch dtype -> its name as numpy spells it (the index's "dtype")
DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float8_e4m3fn: "float8_e4m3fn", torch.float8_e5m2: "float8_e5m2",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_BY_NAME = {name: dt for dt, name in DTYPE_NAMES.items()}
_ALIGN = 64          # bytes between tensors in a pinned snapshot buffer
READ_WORKERS = 8     # chunk reads in flight in read_named


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no checkpoint name for {dtype}") from None


def stored_dtype(name: str) -> torch.dtype:
    """The torch dtype of a stored dtype name (the counterpart of the
    JAX package's ``np_dtype``)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown stored dtype {name!r}; known: "
                         f"{sorted(_BY_NAME)}") from None


# ----------------------------- trees -----------------------------


def named_leaves(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order: dict keys
    sorted, lists and tuples by index; paths joined by ``/`` as the JAX
    package's ``_path_str`` joins them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def unflatten_like(template, leaves):
    """``leaves`` (in ``named_leaves`` order) in ``template``'s nesting."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(template)


# --------------------------- host copies ---------------------------


def host_copy(named) -> list:
    """``(name, host tensor)`` copies of ``(name, tensor)`` pairs, every
    copy complete on return.  CUDA tensors land in one pinned buffer,
    copied on their device's current stream, then synchronised (the
    first snapshot of a size pays the pinning; PyTorch's caching host
    allocator keeps the buffer for the next one once the write has
    dropped it); host tensors are cloned."""
    offsets, total = [], 0
    for _, t in named:
        offsets.append(total)
        if t.is_cuda:
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True) \
        if total else None
    out, streams = [], set()
    for (name, t), off in zip(named, offsets):
        t = t.detach()
        if t.is_cuda:
            h = buf[off:off + t.numel() * t.element_size()]
            h = h.view(t.dtype).view(t.shape)
            h.copy_(t, non_blocking=True)
            streams.add(torch.cuda.current_stream(t.device))
        else:
            h = t.clone()
        out.append((name, h))
    for s in streams:
        s.synchronize()
    return out


# ----------------------------- backends -----------------------------


class _LocalBackend:
    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def write(self, name: str, data: bytes):
        path = os.path.join(self.root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # unique tmp per writer: concurrent saves of the same step (async +
        # final blocking) must not race on one tmp file
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def read(self, name: str) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name))

    def list_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.root):
            if d.startswith("step_"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return steps

    def delete_tree(self, prefix: str):
        import shutil
        p = os.path.join(self.root, prefix)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)


class _FS3Backend:
    """Checkpoint backend on the in-process 3FS cluster.

    Values go through :class:`repro_torch.fs3.kv.FS3KV`, so every chunk
    lands striped over CRAQ-replicated storage targets; GC walks the
    metadata namespace (``delete_tree``) so ``keep=`` holds here exactly
    as it does on the local backend.  A backend sees the namespace as it
    was when its cluster was opened and as it writes it: a reader of
    another process's writes opens its backend after them, or
    ``reopen``s it (``elastic.ElasticCheckpointer`` does after its
    barrier).
    """

    def __init__(self, client, prefix: str = "ckpt", opener=None):
        from repro_torch.fs3.kv import FS3KV
        if isinstance(client, FS3KV):
            self.kv = client
        else:
            self.kv = FS3KV(client, namespace=prefix.strip("/"))
        self._opener = opener

    def reopen(self):
        """A fresh client over the same cluster root (``fs3_backend``'s
        backends only): sees what other processes wrote since this one
        was opened."""
        from repro_torch.fs3.kv import FS3KV
        if self._opener is None:
            raise ValueError("this 3FS backend has no root to re-open")
        self.kv.client.c.io.pool.shutdown(wait=False)
        self.kv = FS3KV(self._opener(), namespace=self.kv.ns)

    def write(self, name: str, data: bytes):
        self.kv.put(name, data)

    def read(self, name: str) -> bytes:
        raw = self.kv.get(name)
        if raw is None:
            raise FileNotFoundError(name)
        return raw

    def exists(self, name: str) -> bool:
        return self.kv.exists(name)

    def list_steps(self) -> list[int]:
        steps = []
        for name in self.kv.keys():
            if name.startswith("step_"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return steps

    def delete_tree(self, prefix: str):
        self.kv.delete_tree(prefix)


def fs3_backend(root: str, *, n_nodes: int = 3, replication: int = 2,
                prefix: str = "ckpt") -> _FS3Backend:
    """Spin up an in-process 3FS cluster rooted at ``root`` and return a
    checkpoint backend writing through it (``--ckpt-fs3``)."""
    from repro_torch.fs3.client import FS3Client, FS3Cluster

    def opener():
        return FS3Client(FS3Cluster(root, n_nodes=n_nodes,
                                    replication=replication))
    return _FS3Backend(opener(), prefix=prefix, opener=opener)


# ----------------------- chunk format (shared) -----------------------


def _raw(t: torch.Tensor) -> memoryview:
    """The bytes of tensor ``t`` (brought to host first if it is not
    there: a snapshot hands this host copies)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def pack_named(named, step: int, chunk_bytes: int):
    """Pack ``(name, tensor)`` pairs into fixed-size chunk files.

    Returns ``(index, writes)``: the ``index.json`` dict mapping every
    tensor to its (chunk, offset, size, shape, dtype) record, and the
    list of ``(backend_name, bytes-like)`` chunk writes (a memoryview
    over the tensor's bytes where it fills its chunk alone: no copy).
    Shared between :class:`CheckpointManager` and the elastic sharded
    saves.
    """
    index = {"step": step, "tensors": {}, "chunks": []}
    buf, buf_used, chunk_id = [], 0, 0
    writes = []

    def flush():
        nonlocal buf, buf_used, chunk_id
        if not buf:
            return
        name = f"step_{step}/chunk_{chunk_id}.bin"
        # a tensor alone in its chunk goes out as a view of its bytes
        writes.append((name, buf[0] if len(buf) == 1 else b"".join(buf)))
        index["chunks"].append(name)
        buf, buf_used = [], 0
        chunk_id += 1

    for name, leaf in named:
        raw = _raw(leaf)
        if buf_used and buf_used + len(raw) > chunk_bytes:
            flush()
        index["tensors"][name] = {
            "chunk": chunk_id, "offset": buf_used, "size": len(raw),
            "shape": list(leaf.shape), "dtype": dtype_name(leaf.dtype),
        }
        buf.append(raw)
        buf_used += len(raw)
    flush()
    return index, writes


def _as_uint8(data: bytes) -> torch.Tensor:
    if not data:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        # read-only bytes: the tensors made from them are only read
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(data, dtype=torch.uint8)


def read_named(backend, step: int):
    """Read every tensor of a checkpoint step in its *stored* dtype.

    Returns ``(tensors, index)`` with ``tensors`` mapping tensor name to
    a host tensor over the bytes read (read-only: copy before writing;
    ``CheckpointManager.restore`` copies into fresh tensors).  The chunks
    are read ``READ_WORKERS`` at a time, under a ``ckpt.read`` span.
    """
    with span("ckpt.read"), ThreadPoolExecutor(READ_WORKERS) as pool:
        index = json.loads(backend.read(f"step_{step}/index.json"))
        chunks = dict(enumerate(pool.map(        # 3FS batch read
            lambda name: _as_uint8(backend.read(name)), index["chunks"])))
    tensors = {}
    for name, rec in index["tensors"].items():
        dt = stored_dtype(rec["dtype"])
        raw = chunks[rec["chunk"]][rec["offset"]:rec["offset"] + rec["size"]]
        if rec["offset"] % dt.itemsize:
            raw = raw.clone()          # a view needs an aligned offset
        tensors[name] = raw.view(dt).reshape(rec["shape"])
    return tensors, index


def adopt(stored: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A fresh tensor with ``like``'s dtype and device holding
    ``stored``'s values (the stored bytes decoded, then cast)."""
    out = torch.empty(tuple(stored.shape), dtype=like.dtype,
                      device=like.device)
    out.copy_(stored)
    return out


class CheckpointManager:
    def __init__(self, root_or_backend, *, keep: int = 3,
                 chunk_bytes: int = 16 * 1024 * 1024,
                 period_s: float = 300.0, clock=None):
        if isinstance(root_or_backend, str):
            self.backend = _LocalBackend(root_or_backend)
        else:
            self.backend = root_or_backend
        self.keep = keep
        self.chunk_bytes = chunk_bytes
        self.period_s = period_s
        self._clock = telemetry.now if clock is None else clock
        self._pending: list[threading.Thread] = []
        self._last_save_t: float | None = None
        self._lock = threading.Lock()
        self.seconds: dict = {}

    # ------------------------- save -------------------------

    def snapshot(self, named) -> list:
        """Host copies of ``(name, tensor)`` pairs for a save
        (``host_copy``)."""
        return host_copy(named)

    def save(self, state, step: int, blocking: bool = True):
        """Snapshot to host (on this thread, complete on return), then
        write (on a background thread unless blocking)."""
        t0 = telemetry.now()
        with span("ckpt.d2h", step=step):
            host = self.snapshot(named_leaves(state))
        self.seconds["d2h"] = telemetry.now() - t0
        self._start(self._write, (host, step, None), blocking)

    def _start(self, write, args, blocking):
        if blocking:
            write(*args)
            return
        t = threading.Thread(target=write, args=args, daemon=True)
        t.start()
        with self._lock:
            self._pending.append(t)

    def maybe_save(self, state, step: int, now: float | None = None) -> bool:
        """Periodic policy (paper: every 5 minutes).  The first call
        always saves; afterwards a save fires once per ``period_s`` on
        the injected clock (default ``telemetry.now``)."""
        now = self._clock() if now is None else now
        last = self._last_save_t
        if last is None or now - last >= self.period_s:
            self._last_save_t = now
            self.save(state, step, blocking=False)
            return True
        return False

    def _write(self, named, step: int, extra):
        t0 = telemetry.now()
        with span("ckpt.write", step=step):
            self.write_named(named, step, extra_files=extra)
        self.seconds["write"] = telemetry.now() - t0

    def write_named(self, named, step: int, extra_files=None):
        """Write ``(name, tensor)`` pairs as one atomic checkpoint step:
        chunks first, then index, optional sidecar files (e.g. the plan
        manifest), and the ``latest`` pointer last."""
        index, writes = pack_named(named, step, self.chunk_bytes)
        for name, data in writes:          # 3FS batch write
            self.backend.write(name, data)
        self.backend.write(f"step_{step}/index.json",
                           json.dumps(index).encode())
        for name, data in (extra_files or {}).items():
            self.backend.write(f"step_{step}/{name}", data)
        self.backend.write("latest.json",
                           json.dumps({"step": step}).encode())
        self._gc(step)

    def _gc(self, latest_step: int):
        if self.keep <= 0:
            return
        steps = [s for s in self.backend.list_steps() if s != latest_step]
        steps.append(latest_step)      # never collect what we just wrote
        for s in sorted(set(steps))[: -self.keep]:
            self.backend.delete_tree(f"step_{s}")

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()

    # ------------------------- restore -------------------------

    def latest_step(self):
        if not self.backend.exists("latest.json"):
            return None
        return json.loads(self.backend.read("latest.json"))["step"]

    def restore(self, step: int, template):
        """The state of ``step`` in ``template``'s nesting, each leaf a
        fresh tensor with the template leaf's dtype and device."""
        t0 = telemetry.now()
        with span("ckpt.restore", step=step):
            tensors, _ = read_named(self.backend, step)
            out = [adopt(tensors[name], leaf)
                   for name, leaf in named_leaves(template)]
        self.seconds["restore"] = telemetry.now() - t0
        return unflatten_like(template, out)

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template), step
