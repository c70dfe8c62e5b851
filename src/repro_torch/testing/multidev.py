"""Multi-process checks of the port's HaiScale DDP path (port of
``repro/testing/multidev.py``).

``run_ranks(fn, pods, data, device, stage)`` spawns ``pods * data``
ranks (``torch.multiprocessing``, "spawn"), joins them in a gloo
process group on localhost (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
/ ``MASTER_PORT`` set as torchrun sets them), builds the
``core.grid.Grid`` and calls ``fn(grid, device, *args)`` on each.  It
returns every rank's (result, kernel launch counts) in rank order and
raises if any rank fails or the run outlives ``timeout``.  ``fn`` must
be importable by name (a module-level function); results travel
pickled, so return numpy arrays and numbers, not big tensors.

The ``check_*`` functions are rank functions for ``run_ranks`` on the
inputs of the JAX package's checks of the same names (2 pods x 4 data or
one group of 8); they return each rank's outputs, which the tests hold
against the JAX functions' outputs.
"""
from __future__ import annotations

import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.grid import free_port
from repro_torch.telemetry import now


def _worker(fn, rank, pods, data, device, stage, port, args, results):
    world = pods * data
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if str(device).startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        from repro_torch.core.grid import Grid
        from repro_torch.kernels import launch_counts, reset_launch_counts
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world)
        grid = Grid(pods, data, stage=stage)
        reset_launch_counts()
        out = fn(grid, device, *args)
        results.put((rank, True, out, launch_counts()))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc(), None))
        raise SystemExit(1)


def run_ranks(fn, pods, data, device="cpu", stage=None, args=(),
              timeout=600.0):
    """[(result, launch counts) of rank r for r in range(pods * data)]."""
    world = pods * data
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(fn, r, pods, data, device,
                                               stage, port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, error = {}, None
    t_end = now() + timeout
    try:
        while len(got) < world and error is None:
            try:
                rank, ok, out, counts = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    error = f"ranks {dead} exited without a result"
                elif now() > t_end:
                    error = f"ranks timed out after {timeout:.0f} s"
                continue
            if not ok:
                error = f"rank {rank} failed:\n{out}"
            got[rank] = (out, counts)
        if error is None:
            for p in procs:
                p.join(timeout=max(1.0, t_end - now()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
    if error is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}): "
                           f"{error}")
    return [got[r] for r in range(world)]


# ------------------------------- checks ------------------------------------


def _np(t):
    return t.detach().cpu().float().numpy()


def check_collectives(grid, device):
    """Every collective of ``core`` on the JAX checks' inputs, this
    rank's row: hfreduce and flat_allreduce (``check_hfreduce``),
    tree and ring over all 8 ranks (``check_tree_allreduce``), bf16 /
    int8 / fp8 psum over all 8 (``check_compressed_psum``),
    hfreduce_tree (``check_hfreduce_tree_combo``; and hfreduce_pytree
    on the same rows cut into a tree) and fp8 with the mean
    folded before the weak phase and after it
    (``check_fp8_prescale``)."""
    from repro_torch.core.compression import bf16_psum, fp8_psum, int8_psum
    from repro_torch.core.hfreduce import flat_allreduce, hfreduce, \
        hfreduce_pytree, hfreduce_tree
    from repro_torch.core.tree_allreduce import ring_allreduce, \
        tree_allreduce
    r, S, W, A = grid.rank, grid.strong, grid.weak, grid.world

    def row(x):
        return torch.as_tensor(np.asarray(x[r], np.float32), device=device)

    x = np.arange(8 * 1000, dtype=np.float32).reshape(8, 1000) / 100.0
    out = {"hfreduce": hfreduce(row(x), strong=S, weak=W),
           "flat": flat_allreduce(row(x), group=A)}
    x = np.random.default_rng(0).standard_normal((8, 257))
    out["tree"] = tree_allreduce(row(x), A)
    out["ring"] = ring_allreduce(row(x), A)
    x = np.random.default_rng(1).standard_normal((8, 4096))
    out["bf16"] = bf16_psum(row(x), A)
    out["int8"] = int8_psum(row(x), A)
    out["fp8"] = fp8_psum(row(x), A)
    x = np.random.default_rng(2).standard_normal((8, 333))
    out["hfreduce_tree"] = hfreduce_tree(row(x), strong=S, weak=W)
    tree = hfreduce_pytree({"a": row(x)[:300].reshape(3, 100),
                            "b": {"c": row(x)[300:]}}, strong=S, weak=W)
    out["hfreduce_pytree"] = torch.cat([tree["a"].reshape(-1),
                                        tree["b"]["c"]])
    x = 150.0 + np.random.default_rng(7).standard_normal((8, 1024))
    out["fp8_fold"] = hfreduce(row(x), strong=S, weak=W,
                               weak_psum=fp8_psum, prescale=1.0 / 8.0)
    out["fp8_after"] = hfreduce(row(x), strong=S, weak=W,
                                weak_psum=fp8_psum) / 8.0
    return {k: _np(v) for k, v in out.items()}


def small_dense(params_np, device, lr=1e-2):
    """The JAX checks' ``_small_dense`` setting on given weights: the
    phi4-mini smoke config with 2 layers in fp32, AdamW(lr, fp32
    params); returns (cfg, model, optimizer, params)."""
    import dataclasses as dc

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    cfg = dc.replace(smoke_config("phi4-mini-3.8b"), n_layers=2,
                     compute_dtype="float32")
    return (cfg, build_model(cfg), AdamW(lr=lr, param_dtype="float32"),
            params_from_numpy(params_np, device=device))


def _batch(cfg, i, b=8, s=32):
    from repro_torch.data.synthetic import batch_for_model
    return batch_for_model(cfg, "train", i, b, s)


def _tree_np(tree):
    from repro_torch.models.params import tree_leaves
    return [_np(t) for t in tree_leaves(tree)]


class _Recording:
    """An optimizer that applies ``opt`` and keeps the synced gradients
    the step handed it in the new state (``"synced"``)."""

    def __init__(self, opt):
        self.opt = opt

    def apply(self, state, grads):
        return {**self.opt.apply(state, grads), "synced": grads}


def check_ddp(grid, device, params_np):
    """The JAX DDP checks on ``params_np``:

    - ``step``: one overlapped DDP step (``check_ddp_step``): the loss,
      the synced gradients the step handed its optimizer, and the fp32
      masters after it;
    - ``overlap``: for bucket budgets 2^16 and 2^22 and wire formats ""
      and "int8", the synced gradients and the masters after one step
      with overlap on and off (``check_ddp_overlap``), and the
      whole-tree ``sync`` of this rank's gradients against overlap off,
      as max |diff|, and the bucket count;
    - ``zero1``: 3 steps of ZeRO-1 and of the replicated optimizer
      (``check_ddp_zero1``): both loss lists and the max |diff| of the
      working params."""
    from repro_torch.core.ddp import make_ddp_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train_lib import loss_and_grads
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    cfg, model, opt, params = small_dense(params_np, device)

    def fresh(plan):
        return init_state(plan, opt, tree_map(torch.clone, params), grid)

    def maxdiff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    # no per-layer recomputation: the same values, and the ranks never
    # import torch._dynamo (torch.utils.checkpoint does, ~3 s a process)
    no_remat = {"remat": "none"}
    out = {}
    plan = ParallelPlan(mode="ddp", **no_remat)
    state, m = make_train_step(plan, model, _Recording(opt), grid=grid,
                               device=device)(fresh(plan), _batch(cfg, 0))
    out["step"] = {"loss": float(m["loss"]),
                   "master": _tree_np(state["master"]),
                   "synced": _tree_np(state["synced"])}

    # this rank's own gradients, for the whole-tree sync
    # (bucketing.bucketed_apply), which must compute the same bits
    _, _, local = loss_and_grads(model, params, {
        k: torch.as_tensor(v)[grid.rows(len(v))]
        for k, v in _batch(cfg, 0).items()}, remat=False)
    rows = []
    for bucket_bytes in (1 << 16, 1 << 22):
        for compress in ("", "int8"):
            res = {}
            for overlap in (True, False):
                p = ParallelPlan(mode="ddp", overlap=overlap,
                                 compress=compress,
                                 bucket_bytes=bucket_bytes, **no_remat)
                step = make_ddp_train_step(model, opt, grid, p,
                                           device=device)
                st = fresh(p)
                loss, _, g = step.loss_and_grads(st["params"],
                                                 _batch(cfg, 0))
                res[overlap] = (loss, g, opt.apply(st, g)["master"], step)
            on, off = res[True], res[False]
            rows.append({"bucket_bytes": bucket_bytes, "compress": compress,
                         "buckets": len(on[3].ranges),
                         "grad_diff": maxdiff(on[1], off[1]),
                         "tree_sync_diff": maxdiff(off[3].sync(local),
                                                   off[1]),
                         "master_diff": maxdiff(on[2], off[2]),
                         "loss_diff": abs(float(on[0]) - float(off[0]))})
    out["overlap"] = rows

    plan_z = ParallelPlan(mode="ddp", zero1=True, overlap=False, **no_remat)
    plan_r = ParallelPlan(mode="ddp", overlap=False, **no_remat)
    step_z = make_train_step(plan_z, model, opt, grid=grid, device=device)
    step_r = make_train_step(plan_r, model, opt, grid=grid, device=device)
    st_z, st_r = fresh(plan_z), fresh(plan_r)
    lz, lr = [], []
    for i in range(3):
        st_z, mz = step_z(st_z, _batch(cfg, i))
        st_r, mr = step_r(st_r, _batch(cfg, i))
        lz.append(float(mz["loss"]))
        lr.append(float(mr["loss"]))
    out["zero1"] = {"losses": lz, "ref_losses": lr,
                    "params_diff": maxdiff(st_z["params"], st_r["params"])}
    return out


def check_all(grid, device, params_np):
    """``check_collectives`` and ``check_ddp`` in one spawn of the
    ranks."""
    return {"collectives": check_collectives(grid, device),
            "ddp": check_ddp(grid, device, params_np)}
