"""The port's checkpoint manager (``repro_torch.ckpt``): the JAX
package's ``tests/test_ckpt.py`` repeated on tensors, the chunk and index
files byte for byte against the JAX ``CheckpointManager``'s, the snapshot
taken before an in-place step, the prefetch loader, and a crash and
resume through the port's launcher equal to the straight run."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import (CheckpointManager, DTYPE_NAMES,  # noqa: E402
                              named_leaves, stored_dtype)
from repro_torch.ckpt import manager as manager_lib  # noqa: E402


@pytest.fixture()
def state():
    return {
        "params": {"w": torch.arange(256, dtype=torch.bfloat16).reshape(
            16, 16), "b": torch.ones(7)},
        "m": [torch.full((33,), 2.0)],
        "step": torch.tensor(11, dtype=torch.int32),
    }


def _zeros_like(state):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in state["params"].items()},
            "m": [torch.zeros_like(state["m"][0])],
            "step": torch.zeros_like(state["step"])}


def _same(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def test_roundtrip_bf16(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), chunk_bytes=128)
    mgr.save(state, 11, blocking=True)
    restored, step = mgr.restore_latest(_zeros_like(state))
    assert step == 11
    assert _same(restored, state)


def test_index_has_offsets(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), chunk_bytes=128)
    mgr.save(state, 1, blocking=True)
    index = json.loads((tmp_path / "step_1" / "index.json").read_text())
    assert len(index["chunks"]) > 1, "expected multiple chunks"
    for rec in index["tensors"].values():
        assert set(rec) >= {"chunk", "offset", "size", "shape", "dtype"}
    assert index["tensors"]["step"]["shape"] == []


def test_async_save_and_wait(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 5, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_gc_keeps_latest(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s, blocking=True)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_3", "step_4"]


def test_periodic_policy(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), period_s=300.0)
    t0 = 1000.0
    assert mgr.maybe_save(state, 1, now=t0)           # first fires
    assert not mgr.maybe_save(state, 2, now=t0 + 299)  # within window
    assert mgr.maybe_save(state, 3, now=t0 + 301)      # past 5 minutes
    mgr.wait()


def test_restore_missing_returns_none(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(_zeros_like(state)) is None


def test_injectable_clock_drives_periodic_policy(tmp_path, state):
    """No wall clock, no sleeping: the period policy runs entirely on the
    injected clock (default is telemetry.now)."""
    ticks = iter([100.0, 100.0 + 299.0, 100.0 + 301.0])
    mgr = CheckpointManager(str(tmp_path), period_s=300.0,
                            clock=lambda: next(ticks))
    assert mgr.maybe_save(state, 1)
    mgr.wait()        # async saves of different steps race the pointer
    assert not mgr.maybe_save(state, 2)
    assert mgr.maybe_save(state, 3)
    mgr.wait()
    assert mgr.latest_step() == 3


def test_stored_dtype_is_authoritative(tmp_path):
    """Restore decodes bytes with the *stored* dtype (bf16 and e4m3 by
    the port's own table, which names every dtype as numpy does) and
    only then casts to the template dtype."""
    import ml_dtypes
    src = {"w": torch.arange(16, dtype=torch.bfloat16) / 3,
           "q": torch.linspace(-2, 2, 8).to(torch.float8_e4m3fn),
           "b": torch.ones(4)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(src, 1, blocking=True)
    index = json.loads((tmp_path / "step_1" / "index.json").read_text())
    assert index["tensors"]["w"]["dtype"] == "bfloat16"
    assert index["tensors"]["q"]["dtype"] == "float8_e4m3fn"
    # widen on restore: values must survive the cast, not be reinterpreted
    tmpl = {k: torch.zeros(v.shape) for k, v in src.items()}
    out = mgr.restore(1, tmpl)
    for k in src:
        assert out[k].dtype == torch.float32
        assert torch.equal(out[k], src[k].float()), k
    for dt, name in DTYPE_NAMES.items():
        npdt = np.dtype(getattr(ml_dtypes, name, None) or name)
        assert str(npdt) == name and stored_dtype(name) is dt
        assert npdt.itemsize == dt.itemsize


def test_fs3_backend_gc_and_roundtrip(tmp_path, state):
    """keep= holds on the 3FS backend too: delete_tree walks the CRAQ
    metadata namespace."""
    from repro_torch.ckpt import fs3_backend
    be = fs3_backend(str(tmp_path / "fs3"))
    mgr = CheckpointManager(be, keep=2, chunk_bytes=128)
    for s in (1, 2, 3, 4):
        mgr.save(state, s, blocking=True)
    assert sorted(be.list_steps()) == [3, 4]
    assert not be.exists("step_1/index.json")
    assert not be.exists("step_2/index.json")
    restored, step = mgr.restore_latest(_zeros_like(state))
    assert step == 4 and _same(restored, state)


def test_fs3_backend_survives_restart(tmp_path, state):
    """A fresh cluster over the same root recovers the CRAQ version
    tables from the backing devices."""
    from repro_torch.ckpt import fs3_backend
    mgr = CheckpointManager(fs3_backend(str(tmp_path / "fs3")),
                            chunk_bytes=128)
    mgr.save(state, 7, blocking=True)
    mgr2 = CheckpointManager(fs3_backend(str(tmp_path / "fs3")),
                             chunk_bytes=128)
    restored, step = mgr2.restore_latest(_zeros_like(state))
    assert step == 7 and _same(restored, state)
    # post-restart writes must supersede recovered versions, not lose
    plus = {"params": {k: v + 1 for k, v in state["params"].items()},
            "m": [state["m"][0] + 1], "step": state["step"] + 1}
    mgr2.save(plus, 8, blocking=True)
    again, step = mgr2.restore_latest(_zeros_like(state))
    assert step == 8 and _same(again, plus)


# ------------------------ byte layout against JAX -------------------------


def _numpy_state(seed=0):
    """One state as host arrays: bf16 and e4m3 leaves, odd sizes (so
    tensors start at unaligned chunk offsets), a 0-d step."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"params": {"emb": f(5, 3).astype(ml_dtypes.bfloat16),
                       "layers": {"wq": f(2, 3, 7).astype(ml_dtypes.bfloat16),
                                  "q8": f(9).astype(ml_dtypes.float8_e4m3fn)}},
            "master": {"emb": f(5, 3), "layers": {"wq": f(2, 3, 7)}},
            "v": [f(11), np.arange(3, dtype=np.int32),
                  np.asarray([True, False, True])],
            "step": np.asarray(7, np.int32)}


def _to_port(tree):
    from repro_torch.bridge import tensor_from_numpy
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_port(v) for v in tree]
    return tensor_from_numpy(tree)


def _bitwise(a, b, name=""):
    assert (a.dtype, a.shape) == (b.dtype, b.shape), name
    assert a.tobytes() == b.tobytes(), name


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_files_byte_identical_to_jax_and_cross_restore(tmp_path):
    """For the same state the port writes the JAX manager's chunk files,
    index and pointer byte for byte; each package restores the other's
    checkpoint bitwise."""
    import jax
    import jax.numpy as jnp

    from repro.ckpt import CheckpointManager as JaxManager
    from repro_torch.bridge import tensor_to_numpy
    host = _numpy_state()
    jstate = jax.tree_util.tree_map(jnp.asarray, host)
    JaxManager(str(tmp_path / "jax"), chunk_bytes=96).save(jstate, 3)
    port = CheckpointManager(str(tmp_path / "port"), chunk_bytes=96)
    port.save(_to_port(host), 3)
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(jfiles) > 4 and jfiles == tfiles

    # JAX's files into the port, the port's into JAX
    back = CheckpointManager(str(tmp_path / "jax")).restore(
        3, _to_port(host))
    for (n, a), (_, b) in zip(named_leaves(host), named_leaves(back)):
        _bitwise(a, tensor_to_numpy(b), n)
    jback = JaxManager(str(tmp_path / "port")).restore(3, jstate)
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    jax.tree_util.tree_leaves(jback)):
        _bitwise(np.asarray(a), np.asarray(b))


# ------------------- the snapshot before an in-place step -------------------


@pytest.mark.parametrize("kind", ["manager", "elastic"])
def test_async_save_survives_in_place_steps(tmp_path, monkeypatch, kind):
    """``save(..., blocking=False)`` then two in-place AdamW steps at
    once: the checkpoint holds the state as it was at the save.  The
    writer is held back until the steps are done, as a write of a real
    state is slower than a step; the planted snapshot that keeps
    references instead of copies fails the same check."""
    import threading

    from repro_torch.elastic import ElasticCheckpointer
    from repro_torch.optim import AdamW
    from repro_torch.parallel import ParallelPlan

    rng = np.random.default_rng(1)
    params = {"a": torch.from_numpy(rng.standard_normal((6, 5),
                                                        dtype=np.float32)),
              "b": {"c": torch.from_numpy(rng.standard_normal(
                  9, dtype=np.float32))}}
    opt = AdamW(lr=1e-2, param_dtype="bfloat16")
    grads = lambda i: {"a": torch.full((6, 5), 0.1 * i + 0.3),  # noqa: E731
                       "b": {"c": torch.full((9,), -0.2 * i)}}

    gate = threading.Event()
    pack = manager_lib.pack_named

    def held_pack(*a, **k):
        gate.wait(timeout=60)
        return pack(*a, **k)
    monkeypatch.setattr(manager_lib, "pack_named", held_pack)

    def run(root, planted):
        state = opt.init({k: (v.clone() if torch.is_tensor(v) else
                              {"c": v["c"].clone()})
                          for k, v in params.items()})
        state = opt.apply(state, grads(1))
        mgr = CheckpointManager(root) if kind == "manager" else \
            ElasticCheckpointer(root, ParallelPlan())
        if planted:
            mgr.snapshot = list      # the live tensors themselves
        gate.clear()
        at_save = [t.clone() for _, t in named_leaves(state)]
        mgr.save(state, 1, blocking=False)
        for i in (2, 3):                       # in place, at once
            state = opt.apply(state, grads(i))
        gate.set()
        mgr.wait()
        restored = mgr.restore(1, state)
        return all(torch.equal(t, r) for t, (_, r) in
                   zip(at_save, named_leaves(restored)))

    assert run(str(tmp_path / "ok"), planted=False)
    assert not run(str(tmp_path / "planted"), planted=True)


# ------------------------------- the loader --------------------------------


def test_loader_prefetch_determinism():
    """A loader started at step 2 yields the batches of one started at
    0 from step 2 on, and the same as the JAX package's loader."""
    from repro.configs.registry import smoke_config as jsmoke
    from repro.data import make_synthetic_loader as jloader
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data import make_synthetic_loader
    cfg = smoke_config("phi4-mini-3.8b")
    l1 = make_synthetic_loader(cfg, 2, 16, seed=3)
    l2 = make_synthetic_loader(cfg, 2, 16, seed=3, start_step=2)
    lj = jloader(jsmoke("phi4-mini-3.8b"), 2, 16, seed=3, start_step=2)
    out1 = {}
    for step, b in l1:
        out1[step] = b
        if step >= 4:
            break
    l1.stop()
    for (step, b), (jstep, jb) in zip(l2, lj):
        assert step == jstep
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], out1[step][k])
            np.testing.assert_array_equal(b[k], jb[k])
        if step >= 4:
            break
    l2.stop()
    lj.stop()


def test_loader_surfaces_a_fetch_error():
    from repro_torch.data import PrefetchLoader

    def fetch(step):
        if step == 2:
            raise RuntimeError("shard lost")
        return {"step": step}
    loader = PrefetchLoader(fetch).start(0)
    seen = []
    with pytest.raises(RuntimeError, match="shard lost"):
        for step, b in loader:
            seen.append(b["step"])
    loader.stop()
    assert seen == [0, 1]


# --------------------------- resume through the CLI --------------------------


def _masters(root, step):
    from repro_torch.ckpt import fs3_backend, read_named
    tensors, _ = read_named(fs3_backend(root), step)
    return {n: t for n, t in tensors.items() if n.startswith("master/")}


def test_cli_crash_and_resume_bitexact(tmp_path, monkeypatch, capsys):
    """``--ckpt-dir --ckpt-fs3``: a run of 10 steps that dies after its
    step-5 checkpoint (the loader's fetch fails at step 6), resumed with
    ``--resume``, ends with the masters of 10 straight steps, bitwise
    (a checkpoint's step counts the steps its state has taken, so the
    resume neither repeats nor skips a batch)."""
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    argv = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--steps", "10", "--batch", "2", "--seq", "16", "--ckpt-fs3",
            "--ckpt-every", "5"]
    straight = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])

    real = synthetic.batch_for_model

    def dies_at_6(cfg, kind, step, *a, **k):
        if step == 6:
            raise RuntimeError("node lost")
        return real(cfg, kind, step, *a, **k)
    monkeypatch.setattr(synthetic, "batch_for_model", dies_at_6)
    root = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="node lost"):
        train.main(argv + ["--ckpt-dir", root, "--ckpt-async"])
    monkeypatch.setattr(synthetic, "batch_for_model", real)
    capsys.readouterr()
    resumed = train.main(argv + ["--ckpt-dir", root, "--resume"])
    assert "resumed from step 5" in capsys.readouterr().out
    assert resumed == straight[5:]
    a, b = _masters(str(tmp_path / "a"), 10), _masters(root, 10)
    assert sorted(a) == sorted(b) and len(a) > 5
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_cli_refuses_a_cross_plan_resume(tmp_path, monkeypatch):
    """A checkpoint stamped under gspmd does not resume under ddp
    without ``--resume-plan``; with it, it reshards."""
    from repro_torch.core.grid import free_port
    from repro_torch.launch import train
    argv = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    train.main(argv + ["--steps", "2"])
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    ddp = argv + ["--steps", "3", "--parallel", "ddp", "--zero1",
                  "--resume"]
    with pytest.raises(SystemExit, match="stamped under plan 'gspmd'"):
        train.main(ddp)
    assert len(train.main(ddp + ["--resume-plan"])) == 1
