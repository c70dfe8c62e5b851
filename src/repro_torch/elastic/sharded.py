"""Sharded, plan-stamped checkpoints and the async save pipeline (port of
``repro/elastic/sharded.py``; paper §VII-A, DESIGN.md §13).

:class:`ElasticCheckpointer` extends the chunked
:class:`~repro_torch.ckpt.manager.CheckpointManager` in two ways:

  * **shard slices, not gathered tensors** — for a ZeRO-1 run the flat
    fp32 master/moment vectors are written as every rank's ``[start,
    end)`` slice; replicated trees are written as whole leaves;
  * **plan stamping** — every step carries a ``plan.json`` manifest
    (:mod:`repro_torch.elastic.manifest`) so a later run can decide
    whether it may resume bitwise (same plan) or must reshard
    (cross-plan, :func:`repro_torch.elastic.reshard.reshard`).

Ranks.  A ZeRO-1 shard lives in its own process (``core/ddp.py``), so
the save is collective: each rank copies its flat slices to host, rank
0 gathers every rank's over the grid's gloo group and is the one writer
(replicated state needs no gather: rank 0 of the whole grid, every
pipeline stage's ranks included, writes it, and the others return at
once).  A restore reads on every rank after a barrier over every rank
(rank 0's pending writes joined first), each rank cutting its own slice
from the canonical flats: every rank reads the files in parallel, where
reading on rank 0 and scattering would push the whole optimizer state
through one process and gloo.  A 3FS backend sees the namespace as it
was when opened, so after the barrier every reader re-opens it
(``reopen``).  A cross-plan restore (``restore_for``) takes its barrier
over the target grid alone, so ranks that leave in an elastic rescale
need not join it.

The pipeline stays off the critical path: the host copy (and the
gather) runs under a ``ckpt.d2h`` span on the caller's thread and is
complete when ``save`` returns — the port's steps update the state in
place — the chunked write on a background thread under ``ckpt.write``,
and restores under ``ckpt.restore``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import CheckpointManager, host_copy, \
    named_leaves
from repro_torch.core.ddp import _zero1_layout
from repro_torch.elastic import manifest as manifest_lib
from repro_torch.elastic.reshard import reshard
from repro_torch.telemetry import now, span

FLAT_KEYS = ("master", "m", "v")


class PlanMismatchError(RuntimeError):
    """Checkpoint was stamped under a different ParallelPlan; resume with
    an explicit cross-plan reshard (``restore_for`` / ``--resume-plan``)."""


def _is_zero1_flat(plan, state) -> bool:
    return (plan.mode == "ddp" and plan.zero1
            and isinstance(state, dict) and "master" in state
            and getattr(state["master"], "ndim", None) == 1)


def _multi(grid) -> bool:
    return grid is not None and grid.ranks > 1


def _rank_offsets(params, grid) -> list:
    """Every rank's flat shard offset, in rank order."""
    _, padded, _ = _zero1_layout(params, grid)
    shard = padded // grid.size
    return [j * (padded // grid.data) + pod * shard
            for pod, j in (divmod(r, grid.data) for r in range(grid.size))]


def snapshot_sharded(state, plan, grid, step: int, copy=host_copy):
    """Host snapshot: ``(named host tensors, plan manifest)``, complete
    on return; ``(None, None)`` on a rank that does not write.
    ``copy``: named tensors -> named host copies
    (``ckpt.manager.host_copy``).

    ZeRO-1 flat components become ``flat/<key>/<start>`` shard slices
    (every rank's, gathered to rank 0); everything else keeps its tree
    path (``params/...``, ``master/...``).
    """
    writer = grid is None or grid.rank == 0
    with span("ckpt.d2h", step=step):
        if _is_zero1_flat(plan, state):
            mine = [(k, state[k]) for k in FLAT_KEYS]
            if writer:
                mine = [("step", state["step"])] + [
                    (f"params/{p}", leaf)
                    for p, leaf in named_leaves(state["params"])] + mine
            host = copy(mine)
            flats = dict(host[-len(FLAT_KEYS):])
            starts = _rank_offsets(state["params"], grid) if grid \
                else [0]
            slices = {k: [flats[k]] for k in FLAT_KEYS}
            if _multi(grid):
                for k in FLAT_KEYS:
                    got = [torch.empty_like(flats[k])
                           for _ in range(grid.size)] if writer else None
                    dist.gather(flats[k], got, dst=0, group=grid.world)
                    slices[k] = got
            if not writer:
                return None, None
            named = host[:-len(FLAT_KEYS)]
            flat = {}
            for key in FLAT_KEYS:
                comp = {"padded": int(state[key].shape[0]) * len(starts),
                        "shards": []}
                for start, data in sorted(zip(starts, slices[key]),
                                          key=lambda x: x[0]):
                    name = f"flat/{key}/{start:012d}"
                    named.append((name, data))
                    comp["shards"].append({
                        "name": name, "start": int(start),
                        "end": int(start + data.shape[0]),
                    })
                flat[key] = comp
            man = manifest_lib.build_manifest(
                step, plan, grid, state["params"], "zero1_flat", flat=flat)
        else:
            if not writer:
                return None, None
            named = copy(named_leaves(state))
            man = manifest_lib.build_manifest(
                step, plan, grid, state["params"], "tree")
    return named, man


class ElasticCheckpointer(CheckpointManager):
    """Plan-stamped sharded checkpoints with cross-plan restore.

    ``plan`` and ``grid`` (the run's ``core.grid.Grid``, None for one
    device) say how the state is laid out.  ``restore_latest(template)``
    resumes onto them and refuses a cross-plan checkpoint unless
    ``allow_cross_plan=True``; ``restore_for(plan_b, grid_b, ...)``
    reshard-restores onto another plan and re-stamps the checkpointer so
    later saves carry the new plan.  Under a grid of several ranks every
    rank calls ``save`` and ``restore`` together.
    """

    def __init__(self, root_or_backend, plan, grid=None, *,
                 allow_cross_plan: bool = False, **kw):
        super().__init__(root_or_backend, **kw)
        self.plan = plan
        self.grid = grid
        self.allow_cross_plan = allow_cross_plan

    # ------------------------- save -------------------------

    def save(self, state, step: int, blocking: bool = True):
        t0 = now()
        named, man = snapshot_sharded(state, self.plan, self.grid, step,
                                      self.snapshot)
        self.seconds["d2h"] = now() - t0
        if named is None:
            return
        extra = {manifest_lib.MANIFEST_NAME: manifest_lib.dumps(man)}
        self._start(self._write, (named, step, extra), blocking)

    # ------------------------- restore -------------------------

    def load_manifest(self, step: int) -> dict:
        return manifest_lib.loads(self.backend.read(
            f"step_{step}/{manifest_lib.MANIFEST_NAME}"))

    def _sync(self, grid=None):
        """Rank 0's writes done and seen by every rank of ``grid``
        (default: the checkpointer's own): a barrier over the grid's
        ranks, after which every reader re-opens a backend that sees
        the namespace as it was when opened (``reopen``: 3FS)."""
        grid = self.grid if grid is None else grid
        self.wait()
        if _multi(grid):
            dist.barrier(group=grid.all)
            reopen = getattr(self.backend, "reopen", None)
            if grid.rank != 0 and reopen is not None:
                reopen()

    def latest_step(self, grid=None):
        self._sync(grid)
        return super().latest_step()

    def restore(self, step: int, template):
        self._sync()
        t0 = now()
        with span("ckpt.restore", step=step):
            man = self.load_manifest(step)
            if not manifest_lib.plans_equal(self.plan, man["plan"]) \
                    and not self.allow_cross_plan:
                raise PlanMismatchError(
                    f"step {step} was stamped under plan "
                    f"{man['plan']['mode']!r} (zero1={man['plan']['zero1']})"
                    f" != current {self.plan.mode!r}; pass --resume-plan / "
                    "use restore_for() to reshard")
            state, _ = reshard(self, self.plan, self.grid,
                               template["params"], step=step)
        self.seconds["restore"] = now() - t0
        return state

    def restore_for(self, plan_b, grid_b, params_template, *,
                    step: int | None = None):
        """Cross-plan restore: remap the checkpoint onto ``(plan_b,
        grid_b)`` and adopt them for every save that follows.  The
        barrier is over ``grid_b``'s ranks alone, so ranks of the old
        grid outside the new one (an elastic rescale's leavers) need
        not join it; the writer, rank 0, is in every grid."""
        if step is None:
            step = self.latest_step(grid_b)
            if step is None:
                return None
        else:
            self._sync(grid_b)
        t0 = now()
        with span("ckpt.restore", step=step):
            state, step = reshard(self, plan_b, grid_b, params_template,
                                  step=step)
        self.seconds["restore"] = now() - t0
        self.plan, self.grid = plan_b, grid_b
        return state, step


def save_sharded(state, plan, grid=None, *, step: int, root_or_backend,
                 blocking: bool = True, **kw) -> ElasticCheckpointer:
    """One-shot plan-stamped sharded save; returns the checkpointer so
    the caller can ``wait()`` / ``restore_for()`` against it."""
    mgr = ElasticCheckpointer(root_or_backend, plan, grid, **kw)
    mgr.save(state, step, blocking=blocking)
    return mgr
