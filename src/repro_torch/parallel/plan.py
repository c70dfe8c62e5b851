"""ParallelPlan: one description of how a training run maps onto the
devices (port of ``repro/parallel/plan.py``).

The dataclass is a copy of the JAX package's, fields and validation
alike, so a plan reads the same in both packages.  Two executors are
ported: ``mode="gspmd"`` on one device (``train_lib.make_train_step``)
and ``mode="ddp"``, HaiScale DDP with HFReduce over the ranks of a
``core.grid.Grid`` (``core/ddp.py``; ``zero1`` acts there).  ``"pp"``
(the pipelined path, ROADMAP A13) raises ``NotImplementedError``.  There
is no mesh in the port, so the JAX plan's ``mesh_batch_axes`` is not
copied: the grid's ("pod", "data") groups are the batch axes.  The knobs
that split work or state over devices in ways not ported (``tp``,
``ep``, ``opt_shard_model``, ``seq_shard``; ``zero1`` outside ddp)
raise unless they keep their one-device values.  ``fsdp`` shards params
over the batch axes, which on one device hold the whole of every leaf
whichever value it takes.  ``microbatch`` and ``remat`` act.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.device import resolve_device
from repro_torch.telemetry import span

MODES = ("gspmd", "ddp", "pp")
GRAD_SYNCS = ("hfreduce", "flat")
COMPRESSIONS = ("", "bf16", "fp8", "int8")
PP_SCHEDULES = ("gpipe", "1f1b")
_NOT_PORTED = {"pp": "the pipelined path (ROADMAP A13)"}
# the plan's values that keep work and state on one device
_ONE_DEVICE = {"tp": 1, "ep": 1, "zero1": False, "opt_shard_model": False,
               "seq_shard": False}


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """How a training step is parallelized, across all three executors."""

    mode: str = "gspmd"                # gspmd | ddp | pp
    batch_axes: tuple = ("pod", "data")  # mesh axes carrying the batch dim
    # --- gradient sync (ddp + pp modes) ---
    grad_sync: str = "hfreduce"        # hfreduce | flat
    compress: str = ""                 # "" | bf16 | fp8 | int8 (weak axis)
    bucket_bytes: Optional[int] = None  # None -> the default bucket size
    bucketed: bool = True              # False -> one collective per leaf
    overlap: bool = True               # sync inside the backward per bucket
    wire_dtype: Optional[str] = None   # grad wire dtype (None: promoted leaf)
    zero1: bool = False                # shard fp32 masters/moments
    microbatch: int = 1                # grad accumulation (gspmd mode)
    # --- pipeline (pp mode) ---
    pp_axis: str = "pipe"
    pp_schedule: str = "1f1b"          # gpipe | 1f1b
    pp_microbatches: int = 4
    # --- gspmd passthrough (sharding rules) ---
    tp: int = 1
    fsdp: bool = True
    opt_shard_model: bool = False
    seq_shard: bool = False
    remat: str = "full"
    ep: int = 1

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r}; want one of {MODES}")
        if self.grad_sync not in GRAD_SYNCS:
            raise ValueError(
                f"grad_sync={self.grad_sync!r}; want one of {GRAD_SYNCS}")
        if self.compress not in COMPRESSIONS:
            raise ValueError(
                f"compress={self.compress!r}; want one of {COMPRESSIONS}")
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError(
                f"pp_schedule={self.pp_schedule!r}; want one of "
                f"{PP_SCHEDULES}")
        if self.mode == "ddp" and self.zero1 and self.compress:
            raise ValueError(
                "explicit ZeRO-1 reduce-scatters grads (no allreduce to "
                "compress); use compress with zero1=False")
        if self.compress and self.grad_sync == "flat" and \
                self.mode in ("ddp", "pp"):
            raise ValueError(
                "compress is the wire format of the *hierarchical* "
                "cross-pod phase; grad_sync='flat' has no weak phase to "
                "compress")
        if self.mode == "ddp" and self.zero1 and self.overlap:
            raise ValueError(
                "explicit ZeRO-1 already splits the sync around the "
                "optimizer (scatter before, gather after); overlap hooks "
                "apply to the replicated-optimizer path — set overlap=False")
        if self.mode == "ddp" and self.overlap and not self.bucketed:
            raise ValueError(
                "overlap hooks are per-bucket by construction; the "
                "monolithic per-leaf sync (bucketed=False) is a post-hoc "
                "baseline — set overlap=False")
        if self.mode == "ddp" and self.microbatch != 1:
            raise ValueError(
                "the explicit DDP path does not accumulate microbatches "
                "(each accumulation step would re-sync every bucket); use "
                "mode='gspmd' or mode='pp' for microbatching")
        if self.pp_microbatches < 1:
            raise ValueError("pp_microbatches must be >= 1")

    def gspmd_config(self):
        """Lower to the ``ParallelConfig`` the gspmd executor reads."""
        from repro_torch.configs.base import ParallelConfig
        return ParallelConfig(
            tp=self.tp, fsdp=self.fsdp, zero1_pod=self.zero1,
            opt_shard_model=self.opt_shard_model,
            batch_axes=self.batch_axes, seq_shard=self.seq_shard,
            microbatch=self.microbatch, remat=self.remat, ep=self.ep,
            grad_compression=self.compress,
            hier_allreduce=self.grad_sync == "hfreduce")


def _require_ported(plan: ParallelPlan, grid=None) -> None:
    if plan.mode in _NOT_PORTED:
        raise NotImplementedError(
            f"ParallelPlan(mode={plan.mode!r}) is not ported to repro_torch "
            f"yet: {_NOT_PORTED[plan.mode]}; use mode='gspmd' or 'ddp'")
    allowed = {"zero1"} if plan.mode == "ddp" else set()
    multi = {k: getattr(plan, k) for k, one in _ONE_DEVICE.items()
             if getattr(plan, k) != one and k not in allowed}
    if multi:
        raise NotImplementedError(
            f"ParallelPlan{multi} is not ported to repro_torch: it splits "
            f"work or state in ways the port does not run; keep "
            f"{_ONE_DEVICE} (zero1 acts with mode='ddp')")
    if plan.mode == "ddp" and grid is None:
        raise ValueError("mode='ddp' runs over the ranks of a "
                         "core.grid.Grid; pass grid=")


def make_train_step(plan: ParallelPlan, model, optimizer, device=None,
                    grid=None):
    """The train step ``step(state, batch) -> (state, metrics)`` for
    ``plan`` (device default: the card; raises without CUDA unless
    ``device="cpu"``).  ``"gspmd"`` runs on one device; ``"ddp"`` runs
    this rank's part of the global ``batch`` on ``grid``
    (``core.ddp.make_ddp_train_step``).  The step updates ``state`` in
    place (see ``optim.AdamW``) and runs inside a ``train.step``
    telemetry span, as the JAX step does."""
    _require_ported(plan, grid)
    if plan.mode == "ddp":
        from repro_torch.core.ddp import make_ddp_train_step
        step = make_ddp_train_step(model, optimizer, grid, plan,
                                   device=device)
    else:
        from repro_torch import train_lib
        step = train_lib.make_train_step(model, optimizer,
                                         plan.gspmd_config(),
                                         device=resolve_device(device))

    def traced_step(state, batch):
        with span("train.step"):
            return step(state, batch)

    return traced_step


def init_state(plan: ParallelPlan, optimizer, params, grid=None):
    """Optimizer state matching the plan's executor: ``optimizer.init``,
    or this rank's flat shards for ddp with ``zero1``
    (``core.ddp.init_zero1_state``)."""
    _require_ported(plan, grid)
    if plan.mode == "ddp" and plan.zero1:
        from repro_torch.core.ddp import init_zero1_state
        return init_zero1_state(params, optimizer, grid)
    return optimizer.init(params)
