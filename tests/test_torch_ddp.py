"""The port's HaiScale DDP path (``repro_torch.core``, ``ParallelPlan(
mode="ddp")``, ``launch.train --parallel ddp``) against the JAX package
on the CPU.

One spawn of 8 gloo ranks as 2 pods x 4 data
(``repro_torch.testing.multidev.run_ranks`` with ``check_all``) and one
JAX interpreter with 8 fake devices (``tests/_torch_ddp_jax.py``, which
calls the ``repro.core`` functions and ``make_ddp_train_step``
directly) run side by side on the inputs of the JAX package's
``testing/multidev.py`` checks and on the same numpy-drawn phi4-mini
smoke weights.  Tolerances: hfreduce, flat, tree and ring within 1e-5
of max |sum|; the bf16 / int8 / fp8 wire formats within one wire ulp or
one int8 code of JAX's output (gloo and XLA add in other orders, which
can move a rounding by one step); the DDP step's loss within 1e-5
relative, its synced gradients within 1e-5 of each leaf's max |g|, and
its masters within 5e-3 (the JAX check's own bound).
Overlap against post-hoc sync is bitwise, ZeRO-1 against the replicated
optimizer within 1e-5 over 3 steps; both within the port."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_pair import numpy_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _phi4_smoke_defs():
    import dataclasses as dc

    from repro.configs.registry import smoke_config
    from repro.models import build_model
    cfg = dc.replace(smoke_config("phi4-mini-3.8b"), n_layers=2,
                     compute_dtype="float32")
    return build_model(cfg).param_defs()


def _flat_keys(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_keys(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port rank results, JAX outputs): the JAX interpreter runs while
    the ranks do."""
    from repro_torch.testing.multidev import check_all, run_ranks
    d = tmp_path_factory.mktemp("ddp")
    params = numpy_params(_phi4_smoke_defs())
    np.savez(d / "params.npz", **_flat_keys(params))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jax_run = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ddp_jax.py"),
         str(d / "params.npz"), str(d / "jax.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = run_ranks(check_all, 2, 4, "cpu", args=(params,),
                          timeout=300)
    finally:
        log, _ = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, log
    return [r for r, _ in ranks], dict(np.load(d / "jax.npz"))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_every_rank_holds_the_same_result(runs):
    port, _ = runs
    for r in port[1:]:
        for k, v in port[0]["collectives"].items():
            np.testing.assert_array_equal(r["collectives"][k], v, err_msg=k)
        assert r["ddp"]["step"]["loss"] == port[0]["ddp"]["step"]["loss"]


@pytest.mark.parametrize("name", ["hfreduce", "flat", "tree", "ring",
                                  "hfreduce_tree", "hfreduce_pytree"])
def test_allreduce_schedules_match_jax(runs, name):
    """hfreduce_pytree: the hfreduce_tree rows cut into a tree of two
    leaves, reduced leaf by leaf."""
    port, ref = runs
    got = port[0]["collectives"][name]
    want = ref["hfreduce_tree" if name == "hfreduce_pytree" else name]
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def _ulp_bf16(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _ulp_e4m3(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -6))) - 3)


@pytest.mark.parametrize("wire", ["bf16", "int8", "fp8", "fp8_fold"])
def test_compressed_psums_match_jax(runs, wire):
    """Within one step of the wire format of JAX's output: an e4m3 ulp
    at the larger magnitude, or the int8 code of the output's 256-block
    (max |block| / 127).  bf16: gloo adds the 8 bf16 terms rounding
    each add (P - 1 = 7 roundings of at most half an ulp of sum |x_i|),
    where XLA rounds the sum once, so the two lie within P / 2 = 4 bf16
    ulps of sum |x_i| (the first reading: 8 ulps of max |x_i|)."""
    port, ref = runs
    got, want = port[0]["collectives"][wire], ref[wire]
    diff = np.abs(got - want)
    if wire == "bf16":
        x = torch.tensor(np.random.default_rng(1).standard_normal(
            (8, 4096)), dtype=torch.bfloat16).float().numpy()
        step = 4 * _ulp_bf16(np.abs(x).sum(0))
    elif wire == "int8":
        code = np.abs(want).reshape(-1, 256).max(axis=1) / 127.0
        step = np.repeat(code, 256) * (1 + 1e-6)
    else:
        step = _ulp_e4m3(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(diff <= step), float((diff / step).max())
    exact = np.random.default_rng(1).standard_normal((8, 4096)).sum(0)
    if wire == "fp8_fold":
        exact = (150.0 + np.random.default_rng(7).standard_normal(
            (8, 1024))).mean(0)
    # the JAX check's own bounds on the error against the exact result
    bound = {"bf16": 0.02, "int8": 0.05, "fp8": 0.08, "fp8_fold": 0.08}
    assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < bound[wire]


def test_fp8_needs_the_mean_folded_before_the_weak_phase(runs):
    """Dividing after the fp8 phase overflows e4m3: JAX gives NaN, torch
    saturates at 448 (ROADMAP watch list) — either way the error is
    large, while the folded mean is accurate."""
    port, ref = runs
    exact = (150.0 + np.random.default_rng(7).standard_normal(
        (8, 1024))).mean(0)
    after = port[0]["collectives"]["fp8_after"]
    fold = port[0]["collectives"]["fp8_fold"]
    err_after = np.max(np.abs(after - exact)) / np.max(np.abs(exact))
    err_fold = np.max(np.abs(fold - exact)) / np.max(np.abs(exact))
    assert np.isfinite(after).all() and np.max(np.abs(after)) <= 448 / 8
    assert err_fold < 0.08 and err_after > 10 * err_fold
    assert not np.isfinite(ref["fp8_after"]).all()


def test_ddp_step_matches_jax(runs):
    """One overlapped DDP step (2 pods x 4 data, int8 off) against the
    JAX shard_map step on the same weights and batch: the loss, the
    synced gradients the step hands its optimizer (each leaf within
    1e-5 of its max |g|: a sync off by any factor, the 1/8 mean among
    them, fails here, where AdamW's first update, about lr · sign(g),
    would hide it in the masters), and the masters after the update."""
    port, ref = runs
    step = port[0]["ddp"]["step"]
    np.testing.assert_allclose(step["loss"], float(ref["ddp_loss"]),
                               rtol=1e-5, atol=0)
    assert len(step["synced"]) == len(step["master"])
    for i, leaf in enumerate(step["synced"]):
        assert _rel(leaf, ref[f"ddp_synced_{i}"]) < 1e-5, i
    for i, leaf in enumerate(step["master"]):
        np.testing.assert_allclose(leaf, ref[f"ddp_master_{i}"], rtol=0,
                                   atol=5e-3)


def test_overlap_equals_posthoc_bitwise(runs):
    port, _ = runs
    rows = port[0]["ddp"]["overlap"]
    assert {r["bucket_bytes"] for r in rows} == {1 << 16, 1 << 22}
    assert {r["compress"] for r in rows} == {"", "int8"}
    assert any(r["buckets"] > 1 for r in rows)
    for r in rows:
        assert r["grad_diff"] == r["master_diff"] == r["loss_diff"] == 0, r
        assert r["tree_sync_diff"] == 0, r


def test_zero1_tracks_replicated(runs):
    port, _ = runs
    z = port[0]["ddp"]["zero1"]
    np.testing.assert_allclose(z["losses"], z["ref_losses"], rtol=1e-5,
                               atol=0)
    assert z["params_diff"] < 1e-4


def test_train_cli_ddp_on_cpu(monkeypatch):
    """``--parallel ddp`` as torchrun starts one rank (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): on one rank the sync is the identity, so
    the losses are the one-device gspmd run's; the CLI releases the
    process group it started."""
    import torch.distributed as dist

    from repro_torch.core.grid import free_port
    from repro_torch.launch import train
    argv = ["--arch", "gpt2-medium", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "16"]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    ddp = train.main(argv + ["--parallel", "ddp", "--bucket-mb", "1"])
    assert not dist.is_initialized()
    gspmd = train.main(argv)
    np.testing.assert_allclose(ddp, gspmd, rtol=1e-6, atol=0)


def test_cost_model_and_error_feedback_match_jax():
    """The cross-pod byte counts, and one error-feedback step through
    the int8 round trip (the plain quantizer on a CPU tensor) against
    JAX's on a length its padding has to handle: the compressed value
    bitwise, the residual x + r - y within one fp32 ulp of x + r (XLA
    fuses the sum and the difference; the cancellation shows the last
    bit of the sum)."""
    import jax.numpy as jnp

    from repro.core import compression as jc
    from repro.core.hfreduce import crosspod_bytes_flat as jflat
    from repro.core.hfreduce import crosspod_bytes_hier as jhier
    from repro_torch.core import compression as tc
    from repro_torch.core.hfreduce import crosspod_bytes_flat, \
        crosspod_bytes_hier
    for args in ((1 << 20, 1, 8), (1 << 20, 2, 4), (3 << 20, 4, 8)):
        assert crosspod_bytes_flat(*args) == jflat(*args)
        assert crosspod_bytes_hier(*args) == jhier(*args)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(1000).astype(np.float32)
    r = (rng.standard_normal(1000) * 1e-2).astype(np.float32)
    jy, jr = jax.jit(lambda a, b: jc.ef_compress(a, b, jc.int8_roundtrip))(
        jnp.asarray(x), jnp.asarray(r))
    ty, tr = tc.ef_compress(torch.from_numpy(x), torch.from_numpy(r),
                            tc.int8_roundtrip)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert np.all(np.abs(tr.numpy() - np.asarray(jr))
                  <= np.spacing(np.abs(x + r)))


def test_tree_schedule_matches_jax():
    from repro.core.tree_allreduce import tree_schedule as jsched
    from repro_torch.core.tree_allreduce import tree_schedule
    for n in (2, 3, 4, 7, 8):
        for shift in (0, n // 2 or 1):
            assert tree_schedule(n, shift) == jsched(n, shift)


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16, 1 << 22])
def test_plan_buckets_match_jax(budget):
    """Bucket slices and leaf ranges equal JAX's on the phi4 smoke tree
    (fp32 and as a bf16 wire)."""
    from repro.core import bucketing as jb
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core import bucketing as tb
    params = numpy_params(_phi4_smoke_defs())
    tp = params_from_numpy(params, device="cpu")
    for wire in (None, "bfloat16"):
        j = jb.plan_buckets(params, budget, wire_dtype=wire)
        t = tb.plan_buckets(tp, budget, wire_dtype=wire)
        assert t.bucket_slices == j.bucket_slices
        assert tb.bucket_leaf_ranges(t) == jb.bucket_leaf_ranges(j)
    flat = tb.flatten_tree(tp)
    back = tb.unflatten_tree(t, flat)
    for a, b in zip(tb.tree_leaves(back), tb.tree_leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv,err", [
    (["--zero1"], SystemExit), (["--no-overlap"], SystemExit),
    (["--compress", "int8"], SystemExit), (["--bucket-mb", "4"], SystemExit),
    (["--parallel", "ddp", "--zero1", "--compress", "int8"], ValueError)])
def test_train_cli_refuses_what_jax_refuses(argv, err):
    from repro_torch.launch import train
    with pytest.raises(err):
        train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
                    *argv])


def test_grid_refuses_nccl_and_ddp_needs_a_grid():
    from repro_torch.core.grid import Grid
    from repro_torch.parallel import ParallelPlan, make_train_step
    with pytest.raises(NotImplementedError, match="nccl"):
        Grid(2, 4, backend="nccl")
    with pytest.raises(ValueError, match="grid"):
        make_train_step(ParallelPlan(mode="ddp"), None, None, device="cpu")
