"""Multi-process checks of the port's HaiScale DDP path (port of
``repro/testing/multidev.py``).

``run_ranks(fn, pods, data, device, staging, pipe=1)`` spawns ``pipe
* pods * data`` ranks (``torch.multiprocessing``, "spawn"), joins them
in a gloo process group on localhost (``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` set as torchrun sets them), builds
the ``core.grid.Grid`` and calls ``fn(grid, device, *args)`` on each.  It
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

import dataclasses
import importlib
import os
import queue
import shutil
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.grid import free_port
from repro_torch.telemetry import now


def _worker(fn, rank, pods, data, pipe, device, staging, port, args,
            results):
    world = pipe * pods * data
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
        grid = Grid(pods, data, pipe, staging=staging)
        reset_launch_counts()
        out = fn(grid, device, *args)
        results.put((rank, True, out, launch_counts()))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc(), None))
        raise SystemExit(1)


def run_ranks(fn, pods, data, device="cpu", staging=None, args=(),
              timeout=600.0, pipe=1):
    """[(result, launch counts) of rank r for r in range(pipe * pods *
    data)]."""
    world = pipe * pods * data
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(fn, r, pods, data, pipe,
                                               device, staging, port, args,
                                               results))
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


def check_elastic_zero1(grid, device, root):
    """Plan-stamped ZeRO-1 checkpoints across ranks (the port's
    counterpart of the JAX ``check_elastic_*``): gpt2-medium's smoke
    config under ``ParallelPlan(mode="ddp", zero1=True)`` on every rank
    of ``grid``.  Four steps straight; then two steps, an async save to
    a 3FS root under ``root`` (rank 0 gathers the flat shards and
    writes), the state dropped, every rank opening a fresh backend after
    a barrier and restoring its own shard, and two more steps.  Rank 0
    alone restores the checkpoint onto gspmd (one process, a tree
    state) and saves that; every rank restores it back onto ZeRO-1.
    Returns this rank's losses, step-2 / final / round-tripped shards,
    and on rank 0 the gspmd tree's masters as one flat vector."""
    import dataclasses as dc
    import os

    from repro_torch.ckpt import fs3_backend
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.ddp import init_zero1_state
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.elastic import ElasticCheckpointer, save_sharded
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamW
    from repro_torch.parallel import ParallelPlan, make_train_step

    cfg = dc.replace(smoke_config("gpt2-medium"), compute_dtype="float32")
    model = build_model(cfg)
    opt = AdamW(lr=1e-2, param_dtype="float32")
    plan = ParallelPlan(mode="ddp", zero1=True, overlap=False)
    step = make_train_step(plan, model, opt, device=device, grid=grid)
    params = model.init(0, device=device)

    def fresh():                  # the state adopts fp32 params: clone
        return init_zero1_state(tree_map(torch.clone, params), opt, grid)

    def run(state, steps):
        losses = []
        for i in steps:
            state, m = step(state, batch_for_model(cfg, "train", i,
                                                   2 * grid.size, 16))
            losses.append(float(m["loss"]))
        return state, losses

    def shard(state):
        return np.concatenate([_np(state[k]) for k in ("master", "m", "v")])

    out = {}
    state, out["straight"] = run(fresh(), range(4))
    out["final_straight"] = shard(state)
    state, _ = run(fresh(), range(2))
    ck = ElasticCheckpointer(fs3_backend(os.path.join(root, "z")), plan,
                             grid)
    ck.save(state, 2, blocking=False)
    out["at_save"] = shard(state)
    ck.wait()
    del state, ck
    dist.barrier(group=grid.world)           # rank 0 has written
    ck = ElasticCheckpointer(fs3_backend(os.path.join(root, "z")), plan,
                             grid)
    state, out["restored_step"] = ck.restore_latest(fresh())
    out["restored"] = shard(state)
    out["restored_opt_step"] = int(state["step"])
    state, out["resumed"] = run(state, range(2, 4))
    out["final_resumed"] = shard(state)

    gspmd = ParallelPlan(mode="gspmd")
    tree_root = os.path.join(root, "tree")
    if grid.rank == 0:
        one = ElasticCheckpointer(fs3_backend(os.path.join(root, "z")),
                                  gspmd, None)
        tree, _ = one.restore_for(gspmd, None, params)
        out["tree_master"] = np.concatenate(
            [_np(x).reshape(-1) for x in tree_leaves(tree["master"])])
        save_sharded(tree, gspmd, None, step=2, root_or_backend=tree_root)
    dist.barrier(group=grid.world)
    back, _ = ElasticCheckpointer(tree_root, plan, grid).restore_for(
        plan, grid, params)
    out["back"] = shard(back)
    return out


def check_pp(grid, device, params_np, root):
    """The JAX package's pipeline checks on a pipe 2 x pod 2 x data 2
    ``grid`` (``run_ranks(..., pipe=2)``):

    - ``train``: ``check_pp_train`` — 5 steps of 16 x 32 under
      ``ParallelPlan(mode="pp")`` for schedules gpipe and 1f1b at
      ``pp_microbatches`` 2 and 4 on ``small_dense(params_np)``: every
      rank's losses and, on rank 0, the fp32 masters after the last
      step;
    - ``pipeline``: ``check_pipeline`` on a second grid, pipe 4 x data 2
      over the same ranks — 8 tanh layers of 16 x 16 weights
      (``np.random.default_rng(3)``, x 8 x 16, 4 microbatches) through
      ``make_pipelined_forward``: this rank's output and the gradient
      of sum(y ** 2) summed over its pipe group (the whole stacked
      gradient);
    - ``resume``: the launcher (``launch.train.main``) under ``--parallel
      pp`` with 2 stages over every rank: 4 steps straight, saving at
      steps 2 and 4 under ``root``/straight; then, from a copy of its
      step-2 checkpoint alone under ``root``/resumed, ``--resume`` to
      step 4; both runs' losses (the checkpoints stay under ``root``)."""
    from repro_torch.core.grid import Grid, all_reduce
    from repro_torch.launch import train
    from repro_torch.models.params import tree_map
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.parallel.pp import make_pipelined_forward
    out = {"coords": (grid.stage, grid.pod, grid.data_index),
           "rows": (grid.rows(16).start, grid.rows(16).stop), "train": {}}
    cfg, model, opt, params = small_dense(params_np, device)
    for schedule in ("gpipe", "1f1b"):
        for m in (2, 4):
            plan = ParallelPlan(mode="pp", pp_schedule=schedule,
                                pp_microbatches=m)
            state = init_state(plan, opt, tree_map(torch.clone, params),
                               grid)
            step = make_train_step(plan, model, opt, device=device,
                                   grid=grid)
            losses = []
            for i in range(5):
                state, metrics = step(state, _batch(cfg, i, 16, 32))
                losses.append(float(metrics["loss"]))
            out["train"][f"{schedule}_m{m}"] = {
                "losses": losses,
                "master": _tree_np(state["master"]) if grid.rank == 0
                else None}

    grid4 = Grid(1, 2, 4, staging=grid.staging)
    rng = np.random.default_rng(3)
    L, d, b, m = 8, 16, 8, 4
    w = torch.tensor(rng.standard_normal((L, d, d)) * 0.3,
                     dtype=torch.float32, device=device, requires_grad=True)
    x = torch.tensor(rng.standard_normal((b, d)), dtype=torch.float32,
                     device=device)
    f = make_pipelined_forward(lambda lw, h: torch.tanh(h @ lw), 4, m, grid4)
    y = f(w, x)
    (y ** 2).sum().backward()
    out["pipeline"] = {"y": _np(y), "grad": _np(all_reduce(w.grad,
                                                           grid4.pipe))}

    argv = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", str(device),
            "--parallel", "pp", "--pp-stages", "2", "--pp-microbatches", "2",
            "--batch", "8", "--seq", "16", "--steps", "4", "--log-every",
            "100"]
    straight = os.path.join(root, "straight")
    resumed = os.path.join(root, "resumed")
    out["resume"] = {"straight": train.main(
        argv + ["--ckpt-dir", straight, "--ckpt-every", "2"])}
    if grid.rank == 0:      # the straight run's step-2 checkpoint, alone
        shutil.copytree(os.path.join(straight, "step_2"),
                        os.path.join(resumed, "step_2"))
        with open(os.path.join(resumed, "latest.json"), "w") as f:
            f.write('{"step": 2}')
    dist.barrier()
    out["resume"]["resumed"] = train.main(argv + ["--ckpt-dir", resumed,
                                                  "--resume"])
    return out


# ------------------ elastic fault tolerance (A14) ----------------------


@dataclasses.dataclass(frozen=True)
class Drill:
    """The sizes of one elastic drill: ``steps`` a run, a checkpoint
    every ``ckpt_every`` steps, the failure injected before step
    ``kill_at``, a global batch of ``batch`` rows x ``seq`` tokens, pp
    in ``pp_microbatches`` microbatches, the plans' ``remat``, the 3FS
    cluster's ``replication`` and the validator's check sizes
    (``Validator(**validator)``).  The step counts are the JAX
    checks'.  ``fork_ref``: the unbroken run forks from the drill's own
    state where the failure strikes (a copy of it takes the remaining
    steps; the steps before it are the drill's own) instead of running
    from step 0 on its own."""

    steps: int = 10
    ckpt_every: int = 5
    kill_at: int = 7
    batch: int = 16
    seq: int = 32
    pp_microbatches: int = 2
    remat: str = "full"
    replication: int = 2
    validator: tuple = (("gemm_n", 64), ("mem_mb", 2), ("storage_mb", 1))
    fork_ref: bool = False


# planted faults of the drill (``check_elastic(..., fault=)``), each
# with the gate that must catch it
RESUME_AT_FAILURE = "the runner resumes at the failure step"
SHARDS_SWAPPED = "the survivors' ZeRO-1 shards at each other's offsets"
SICK_GEMM = "the validator's GEMM check broken"


def small_elastic(device):
    """The JAX elastic checks' setting: the phi4-mini smoke config with
    2 layers in fp32, AdamW(1e-3, fp32 params), the port's own weights
    from seed 0; returns (cfg, model, optimizer, params)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(smoke_config("phi4-mini-3.8b"), n_layers=2,
                              compute_dtype="float32")
    model = build_model(cfg)
    return (cfg, model, AdamW(lr=1e-3, param_dtype="float32"),
            model.init(0, device=device))


def _event_digest(report, event_log, tmpdir, name="events.jsonl"):
    """Persist the runner's JSONL stream and check exactly-once: the file
    holds the same records as ``report.events`` (one emit point), every
    record is unique (kinds counted, timestamps excluded from the key)
    (``repro/testing/multidev.py:_event_digest``).  ``order``: the
    kinds in the order they were emitted."""
    import json
    path = os.path.join(tmpdir, name)
    event_log.write(path)
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    kinds, seen, unique = {}, set(), True
    for rec in lines:
        kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
        key = json.dumps({k: v for k, v in rec.items() if k != "t"},
                         sort_keys=True)
        unique = unique and key not in seen
        seen.add(key)
    return {
        "n_jsonl": len(lines),
        "n_report": len(report.events),
        "jsonl_matches_report": lines == [dict(r) for r in report.events],
        "unique": unique,
        "kinds": kinds,
        "order": [r["kind"] for r in lines],
    }


def _fresh(tree):
    from repro_torch.models.params import tree_map
    return tree_map(torch.clone, tree)


def _state_diff(a, b):
    """(max |a - b| over every leaf of two states, all leaves bitwise
    equal)."""
    from repro_torch.ckpt import named_leaves
    la, lb = named_leaves(a), named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    diff = max(float((x.double() - y.double()).abs().max()) if x.numel()
               else 0.0 for (_, x), (_, y) in zip(la, lb))
    same = all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(la, lb))
    return diff, same


def _timing(report, mgr, t_phase):
    """Step times, the checkpointer's last seconds and the phase's."""
    from repro_torch.telemetry import get_registry
    reg = get_registry()
    return {"step_s": list(report.step_times), "ckpt_s": dict(mgr.seconds),
            "spans_s": {k: reg.histogram(f"span.{k}").sum for k in (
                "ckpt.save", "ckpt.d2h", "ckpt.write", "ckpt.restore",
                "ckpt.read", "validator.node_healthy")},
            "seconds": now() - t_phase}


def _recording_validator(drill, device, grid, sick):
    """A ``platform.Validator`` that keeps its last results
    (``.results``); ``sick``: its GEMM check reports a wrong product."""
    from repro_torch.platform import Validator
    from repro_torch.platform.validator import CheckResult

    class Recording(Validator):
        results = None

        def run_all(self, storage_root=None):
            self.results = super().run_all(storage_root)
            return self.results

        if sick:
            def check_gemm(self):
                good = Validator.check_gemm(self)
                return CheckResult(good.name, False, good.value, good.unit,
                                   "planted: the product is off by one")
    return Recording(**dict(drill.validator), device=device, grid=grid)


def _check_values(validator):
    return {c.name: {"ok": c.ok, "value": float(c.value), "unit": c.unit,
                     "detail": c.detail}
            for c in (validator.results or [])}


def _ckpt_step(drill):
    """The checkpoint a failure before ``drill.kill_at`` restores."""
    return drill.kill_at // drill.ckpt_every * drill.ckpt_every


def _injector(drill, cls, fork=None):
    """A ``FailureInjector`` of ``cls`` before ``drill.kill_at``; with
    ``fork``, ``fork(step)`` runs first, where the failure strikes."""
    from repro_torch.platform import FailureInjector

    class Forking(FailureInjector):
        def check(self, step):
            if fork is not None and step in self.fail_steps:
                fork(step)
            super().check(step)
    return Forking({drill.kill_at: cls})


def _unbroken(step_fn, fetch, drill, state, start, before):
    """The unbroken run from ``state`` at ``start``: ``before`` (the
    losses of the steps that led there), then a copy of ``state``
    through the remaining steps.  Returns (losses, final state, kernel
    launches of those steps)."""
    from repro_torch.kernels import launch_counts
    counts = launch_counts()
    losses = list(before)
    state = _fresh(state)
    for i in range(start, drill.steps):
        state, m = step_fn(state, fetch(i))
        losses.append(float(m["loss"]))
    return losses, state, _minus(launch_counts(), counts)


def _minus(a, b):
    return {k: a[k] - b.get(k, 0) for k in a}


def check_elastic_kill_resume(grid, device, root, setup, drill=Drill(),
                              fault=None, ref=None):
    """Same-plan kill / resume (``repro/testing/multidev.py:
    check_elastic_kill_resume``): ddp + ZeRO-1 over every rank of
    ``grid`` under ``FTRunner`` with an ``ElasticCheckpointer`` on 3FS
    under ``root``, a checkpoint every ``drill.ckpt_every`` steps
    (async), the first non-fatal class of ``FailureModel(0).sample(1250,
    48.0)`` injected before ``drill.kill_at``, the validator run on
    ``device``.  ``setup(device)`` gives (cfg, model, optimizer,
    params).  The unbroken run is the same step, ``drill.steps`` times,
    on a fresh state (``ref``: (losses, state) of an earlier call's,
    else run here and kept under ``"_ref"``).  Returns the losses
    (replay included) against the unbroken run's, whether the final
    states are bitwise equal, the report's counters, ``_event_digest``
    and the timings.  ``fault``: ``RESUME_AT_FAILURE`` (which the
    bitwise gate must catch) or ``SICK_GEMM`` (the rescale gate)."""
    from repro_torch.ckpt import fs3_backend
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.elastic import ElasticCheckpointer
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.platform import FailureModel, FTRunner
    t_phase = now()
    cfg, model, opt, params = setup(device)
    plan = ParallelPlan(mode="ddp", zero1=True, overlap=False,
                        remat=drill.remat)

    def fetch(i):
        return batch_for_model(cfg, "train", i, drill.batch, drill.seq)

    base = make_train_step(plan, model, opt, device=device, grid=grid)
    cls = next(e.cls for e in FailureModel(seed=0).sample(1250, 48.0)
               if not e.fatal)
    out = {"cls": cls, "fault": fault}
    if ref is None and not drill.fork_ref:
        reset_launch_counts()
        ref = out["_ref"] = _unbroken(
            base, fetch, drill, init_state(plan, opt, params, grid), 0,
            [])[:2]
        out["ref_launches"] = launch_counts()
        out["ref_steps"] = drill.steps

    losses, forked = [], []

    def fork(step):
        forked.extend(_unbroken(base, fetch, drill, runner.state, step,
                                losses))

    def wrapped(state, batch):
        state, m = base(state, batch)
        losses.append(float(m["loss"]))
        return state, m

    tag = "same" if fault is None else f"same_{_FAULT_TAGS[fault]}"
    mgr = ElasticCheckpointer(fs3_backend(os.path.join(root, tag),
                                          replication=drill.replication),
                              plan, grid)
    injector = _injector(drill, cls, fork if ref is None else None)
    restore_fn = None
    if fault == RESUME_AT_FAILURE:
        def restore_fn(template, _new_world):
            state, _ = mgr.restore_latest(template)
            return state, injector.raised[-1][0]
    validator = _recording_validator(drill, device, grid,
                                     sick=fault == SICK_GEMM)
    reset_launch_counts()
    runner = FTRunner(lambda world: wrapped, fetch, mgr,
                      init_state(plan, opt, _fresh(params), grid),
                      world_size=2, ckpt_every=drill.ckpt_every,
                      injector=injector, validator=validator,
                      restore_fn=restore_fn)
    report = runner.run(drill.steps)
    launches = launch_counts()
    if ref is None:                    # forked where the failure struck
        ref = out["_ref"] = forked[:2]
        out["ref_launches"] = forked[2]
        out["ref_steps"] = drill.steps - drill.kill_at
        launches = _minus(launches, forked[2])
    ref_losses, ref_state = ref
    want = ref_losses[:drill.kill_at] + ref_losses[_ckpt_step(drill):]
    diff, same = _state_diff(runner.state, ref_state)
    out.update({
        "losses": losses, "ref_losses": ref_losses,
        "losses_bitwise": losses == want,
        "n_losses": [len(losses), len(want)],
        "state_diff": diff, "state_bitwise": same,
        "launches": launches, "failures": report.failures,
        "restores": report.restores, "rescales": report.rescales,
        "lost_steps": report.lost_steps, "world": runner.world,
        "validator": _check_values(validator),
        "digest": _event_digest(report, runner.event_log,
                                os.path.join(root, tag),
                                f"events.rank{grid.rank}.jsonl"),
        **_timing(report, mgr, t_phase)})
    return out


def check_elastic_cross_plan(grid, device, root, setup, drill=Drill(),
                             fault=None, ref_losses=None):
    """Cross-plan kill / rescale (``repro/testing/multidev.py:
    check_elastic_cross_plan``) on ``grid``, pipe 2 x pod 1 x data 2 (4
    ranks): pp under ``FTRunner`` with plan-stamped 3FS checkpoints; the
    first fatal class of ``FailureModel(1).sample(1250, 48.0)`` before
    ``drill.kill_at``; the validator on ``device``; the runner's
    ``restore_fn`` reshards the last checkpoint onto ddp + ZeRO-1 over
    the first 2 ranks (``Grid(1, 2, members=2)``, built by every rank
    first) with the same global batch, and ranks 2 and 3 leave
    (``GangExit``).  The unbroken pp run is the same pp step,
    ``drill.steps`` times (``ref_losses``: an earlier call's).  Returns
    every loss of the run (pp before the kill, ddp after it), the
    post-restore losses against the unbroken run's, the report's
    counters, ``_event_digest`` and the timings; on a leaving rank only
    what it saw before it left.  ``fault``: ``SHARDS_SWAPPED`` (each
    survivor restores the other's ZeRO-1 shard)."""
    from repro_torch.ckpt import fs3_backend
    from repro_torch.core.grid import Grid
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.elastic import ElasticCheckpointer
    from repro_torch.elastic.sharded import _rank_offsets
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.platform import FailureModel, FTRunner, GangExit
    # the module (the package's attribute of that name is the function)
    reshard_mod = importlib.import_module("repro_torch.elastic.reshard")
    t_phase = now()
    survivors = Grid(1, 2, staging=grid.staging, members=2)
    cfg, model, opt, params = setup(device)
    plan_pp = ParallelPlan(mode="pp", pp_microbatches=drill.pp_microbatches,
                           remat=drill.remat)
    plan_dp = ParallelPlan(mode="ddp", zero1=True, overlap=False,
                           remat=drill.remat)

    def plan_for(world):
        return (plan_pp, grid) if world >= 2 else (plan_dp, survivors)

    def fetch(i):
        return batch_for_model(cfg, "train", i, drill.batch, drill.seq)

    step_pp = make_train_step(plan_pp, model, opt, device=device, grid=grid)
    cls = next(e.cls for e in FailureModel(seed=1).sample(1250, 48.0)
               if e.fatal)
    out = {"cls": cls, "fault": fault, "rank": grid.rank}
    if ref_losses is None and not drill.fork_ref:
        reset_launch_counts()
        ref_losses = _unbroken(step_pp, fetch, drill,
                               init_state(plan_pp, opt, params, grid), 0,
                               [])[0]
        out["ref_launches"] = launch_counts()
        out["ref_steps"] = drill.steps

    losses, cache, forked = [], {}, []

    def fork(step):
        forked.extend(_unbroken(step_pp, fetch, drill, runner.state, step,
                                losses))

    def make_step(world):
        if world not in cache:
            p, g = plan_for(world)
            base = step_pp if p is plan_pp else make_train_step(
                p, model, opt, device=device, grid=g)

            def wrapped(state, batch, _base=base):
                state, m = _base(state, batch)
                losses.append(float(m["loss"]))
                return state, m
            cache[world] = wrapped
        return cache[world]

    tag = "cross" if fault is None else f"cross_{_FAULT_TAGS[fault]}"
    mgr = ElasticCheckpointer(fs3_backend(os.path.join(root, tag),
                                          replication=drill.replication),
                              plan_pp, grid)
    injector = _injector(drill, cls, fork if ref_losses is None else None)

    def restore_fn(template, new_world):
        p, g = plan_for(new_world)
        if not g.member:
            raise GangExit(injector.raised[-1][0], new_world)
        if fault != SHARDS_SWAPPED or p is plan_pp:
            return mgr.restore_for(p, g, template["params"])
        # planted: each survivor cuts the other's shard
        offsets = _rank_offsets(template["params"], g)
        layout = reshard_mod._zero1_layout

        def swapped(params_template, g_b):
            total, padded, _ = layout(params_template, g_b)
            return total, padded, offsets[g_b.rank ^ 1]
        reshard_mod._zero1_layout = swapped
        try:
            return mgr.restore_for(p, g, template["params"])
        finally:
            reshard_mod._zero1_layout = layout

    validator = _recording_validator(drill, device, grid, sick=False)
    reset_launch_counts()
    runner = FTRunner(make_step, fetch, mgr,
                      init_state(plan_pp, opt, _fresh(params), grid),
                      world_size=2, min_world=1,
                      ckpt_every=drill.ckpt_every, injector=injector,
                      validator=validator, restore_fn=restore_fn)
    if ref_losses is not None:
        out["ref_losses"] = ref_losses

    def fork_out():
        """The forked unbroken run's losses and launches, and the
        drill's own launches."""
        launches = launch_counts()
        if forked:
            out.update(ref_losses=forked[0], ref_launches=forked[2],
                       ref_steps=drill.steps - drill.kill_at)
            launches = _minus(launches, forked[2])
        return launches

    try:
        report = runner.run(drill.steps)
    except GangExit as e:
        out.update({"left_at": e.step, "losses": losses,
                    "launches": fork_out(),
                    "validator": _check_values(validator),
                    "events": [r["kind"] for r in runner.event_log.events],
                    "seconds": now() - t_phase})
        return out
    launches = fork_out()
    cont = losses[drill.kill_at:]
    post_ref = out["ref_losses"][_ckpt_step(drill):]
    out.update({
        "losses": losses, "cont_losses": cont,
        "post_err": max(abs(a - b) for a, b in zip(cont, post_ref)),
        "post_rel": max(abs(a - b) / abs(b) for a, b in zip(cont, post_ref)),
        "launches": launches,
        "failures": report.failures, "restores": report.restores,
        "rescales": report.rescales, "lost_steps": report.lost_steps,
        "world": runner.world, "validator": _check_values(validator),
        "digest": _event_digest(report, runner.event_log,
                                os.path.join(root, tag),
                                f"events.rank{grid.rank}.jsonl"),
        **_timing(report, mgr, t_phase)})
    return out


_FAULT_TAGS = {RESUME_AT_FAILURE: "resume_at_failure",
               SHARDS_SWAPPED: "shards_swapped", SICK_GEMM: "sick_gemm"}


def _done(root, tag):
    """Every rank past its run; rank 0 removes the run's checkpoints
    (the next run's writes reuse the disk)."""
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(root, tag), ignore_errors=True)


def check_elastic(grid, device, root, setup, drill=Drill(), faults=(),
                  same_drill=None):
    """Both elastic legs in one spawn of 4 ranks (pipe 2 x pod 1 x data
    2, ``run_ranks(..., pods=1, data=2, pipe=2)``): the same-plan leg
    over ``Grid(2, 2)`` of the same ranks (with ``same_drill``'s sizes,
    default ``drill``'s), then the cross-plan leg, then one run of each
    planted fault in ``faults`` (it reuses the clean leg's unbroken
    run).  Each run's checkpoints are removed when every rank is past
    it.  Returns {"same_plan", "cross_plan", "faults": {fault: result}}
    with numbers only."""
    from repro_torch.core.grid import Grid
    grid_dp = Grid(2, 2, staging=grid.staging)
    same_drill = same_drill or drill
    same = check_elastic_kill_resume(grid_dp, device, root, setup,
                                     same_drill)
    _done(root, "same")
    ref = same.pop("_ref")
    out = {"same_plan": same, "faults": {}}
    for fault in faults:
        if fault in (RESUME_AT_FAILURE, SICK_GEMM):
            out["faults"][fault] = check_elastic_kill_resume(
                grid_dp, device, root, setup, same_drill, fault=fault,
                ref=ref)
            _done(root, f"same_{_FAULT_TAGS[fault]}")
    del ref
    out["cross_plan"] = check_elastic_cross_plan(grid, device, root, setup,
                                                 drill)
    _done(root, "cross")
    for fault in faults:
        if fault == SHARDS_SWAPPED:
            out["faults"][fault] = check_elastic_cross_plan(
                grid, device, root, setup, drill, fault=fault,
                ref_losses=out["cross_plan"]["ref_losses"])
            _done(root, f"cross_{_FAULT_TAGS[fault]}")
    return out


def check_elastic_all(grid, device, root, drill=Drill(), faults=()):
    """``check_elastic_zero1`` on ``Grid(2, 2)`` of the spawn's 4 ranks,
    then ``check_elastic`` (``small_elastic``) on the spawn's grid (pipe
    2 x pod 1 x data 2): the elastic checks of both slices in one
    spawn."""
    from repro_torch.core.grid import Grid
    zero1 = check_elastic_zero1(Grid(2, 2, staging=grid.staging), device,
                                os.path.join(root, "zero1"))
    return {"zero1": zero1,
            "drill": check_elastic(grid, device, os.path.join(root, "drill"),
                                   small_elastic, drill, faults)}
