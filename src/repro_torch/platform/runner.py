"""Fault-tolerant training runner: the HAI-platform task lifecycle
(paper §VI-C + §VII) wrapped around a PyTorch train loop (port of
``repro/platform/runner.py``).

  interrupt/failure -> (validator isolates node) -> restore last checkpoint
  -> optionally *elastic* rescale onto fewer nodes -> continue.

Also straggler mitigation: per-step wall times are tracked with a rolling
median; a step slower than ``straggler_factor`` x median raises a
straggler event.

Every discrete platform event (``failure`` / ``validator`` /
``restore`` / ``rescale`` / ``straggler`` / ``ckpt``) goes through
**one** ``repro_torch.telemetry.EventLog`` (the runner's
``event_log``): the ``RunReport.events`` list, the ``on_event``
callback and the persistable JSONL stream all see the *same* record.
Step timing breaks down into ``runner.fetch`` / ``runner.step`` /
``runner.block`` spans plus ``train.{fetch,step}_s`` histograms in the
default registry; the step times themselves read ``telemetry.now``.

Ranks.  Under a ``core.grid.Grid`` every rank runs the same runner: the
injector fires at the same step on each, the validator agrees one
verdict over the grid (``Validator.node_healthy``), saves and restores
are collective (``elastic.ElasticCheckpointer``).  A rescale onto fewer
ranks is the ``restore_fn``'s: on a survivor it restores onto the
smaller grid, on a rank that leaves it raises :class:`GangExit`, which
the runner lets through (that rank's run ends there).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.platform.failures import SimulatedHardwareFailure
from repro_torch.telemetry import EventLog, get_registry, now, span


class GangExit(RuntimeError):
    """Raised by a ``restore_fn`` on a rank outside the rescaled gang:
    the rank stops training (its runner does not catch it)."""

    def __init__(self, step: int, new_world: int):
        super().__init__(f"left the gang at step {step} (world -> "
                         f"{new_world})")
        self.step = step
        self.new_world = new_world


@dataclasses.dataclass
class RunReport:
    steps_done: int = 0
    failures: int = 0
    restores: int = 0
    rescales: int = 0
    stragglers: int = 0
    lost_steps: int = 0
    step_times: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)


class FTRunner:
    """
    make_step(world_size) -> step_fn(state, batch) -> (state, metrics)
      (re-built on elastic rescale; world_size is a logical node count)
    fetch_batch(step) -> batch
    ckpt_manager: repro_torch.ckpt.CheckpointManager (or an
      elastic.ElasticCheckpointer for plan-stamped saves)
    injector: optional FailureInjector (check(step) raises)
    validator: optional platform.Validator — after a failure the node is
      health-checked (``node_healthy()``); a node failing its checks is
      excluded from the restored gang even when the failure class itself
      was non-fatal, and a ``validator`` event records the verdict.
    restore_fn: optional ``(state_template, new_world) -> (state, step)``
      hook — the elastic harness uses it to reshard the checkpoint onto
      the shrunken grid (cross-plan restore); default is the manager's
      same-plan ``restore_latest``.
    event_log: optional telemetry.EventLog (one is created per runner
      otherwise); ``runner.event_log.write(path)`` persists the stream.
    """

    def __init__(self, make_step, fetch_batch, ckpt_manager, state,
                 *, world_size: int, min_world: int = 1,
                 ckpt_every: int = 10, injector=None, validator=None,
                 restore_fn: Optional[Callable] = None,
                 straggler_factor: float = 4.0,
                 on_event: Optional[Callable] = None,
                 event_log: Optional[EventLog] = None):
        self.make_step = make_step
        self.fetch_batch = fetch_batch
        self.ckpt = ckpt_manager
        self.state = state
        self.world = world_size
        self.min_world = min_world
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.validator = validator
        self.restore_fn = restore_fn
        self.straggler_factor = straggler_factor
        self.on_event = on_event or (lambda *a: None)
        self.event_log = event_log or EventLog()

    def _log(self, report, kind, **kw):
        # single emit point: the report, the callback, and the JSONL
        # stream share one record — they cannot drift apart
        rec = self.event_log.emit(kind, **kw)
        report.events.append(rec)
        self.on_event(kind, kw)

    def run(self, total_steps: int, start_step: int = 0) -> RunReport:
        reg = get_registry()
        h_step = reg.histogram("train.step_s")
        h_fetch = reg.histogram("train.fetch_s")
        report = RunReport()
        step_fn = self.make_step(self.world)
        with span("ckpt.save", step=start_step, blocking=True):
            self.ckpt.save(self.state, start_step, blocking=True)
        self._log(report, "ckpt", step=start_step, blocking=True)
        step = start_step

        while step < total_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                t0 = now()
                with span("runner.fetch", step=step):
                    batch = self.fetch_batch(step)
                t1 = now()
                h_fetch.record(t1 - t0)
                # step = dispatch, block = device sync: together they are
                # the wall step time the straggler detector watches
                with span("runner.step", step=step):
                    self.state, metrics = step_fn(self.state, batch)
                with span("runner.block", step=step):
                    _block(metrics)
                dt = now() - t1
                h_step.record(dt)
                report.step_times.append(dt)
                # --- straggler detection ---
                hist = report.step_times[-20:]
                if len(hist) >= 5:
                    med = float(np.median(hist[:-1]))
                    if dt > self.straggler_factor * med:
                        report.stragglers += 1
                        self._log(report, "straggler", step=step,
                                  dt=dt, median=med)
                step += 1
                report.steps_done += 1
                if self.ckpt_every and step % self.ckpt_every == 0:
                    with span("ckpt.save", step=step, blocking=False):
                        self.ckpt.save(self.state, step, blocking=False)
                    self._log(report, "ckpt", step=step, blocking=False)
            except SimulatedHardwareFailure as e:
                report.failures += 1
                self._log(report, "failure", step=step, cls=e.cls,
                          action=e.action, fatal=e.fatal)
                # validator gate (paper §III-D checks): the failed node
                # re-runs its health checks; failing run_all() excludes
                # it from the restored gang even for a non-fatal class
                healthy = True
                if self.validator is not None:
                    with span("validator.node_healthy", step=step):
                        healthy = bool(self.validator.node_healthy())
                    self._log(report, "validator", step=step,
                              healthy=healthy, excluded=not healthy)
                new_world = self.world
                if (e.fatal or not healthy) and self.world > self.min_world:
                    new_world = self.world - 1
                # disaster recovery: restore the last checkpoint, aimed
                # at the (possibly shrunken) grid the run continues on
                self.ckpt.wait()
                with span("ckpt.restore", step=step):
                    if self.restore_fn is not None:
                        restored = self.restore_fn(self.state, new_world)
                    else:
                        restored = self.ckpt.restore_latest(self.state)
                if restored is None:
                    raise
                self.state, ckstep = restored
                report.lost_steps += max(step - ckstep, 0)
                report.restores += 1
                self._log(report, "restore", step=step, ckpt_step=ckstep,
                          lost_steps=max(step - ckstep, 0))
                step = ckstep
                # elastic: the dead/unhealthy node leaves; shrink the gang
                if new_world != self.world:
                    self.world = new_world
                    report.rescales += 1
                    self._log(report, "rescale", new_world=self.world)
                step_fn = self.make_step(self.world)

        self.ckpt.wait()
        with span("ckpt.save", step=step, blocking=True):
            self.ckpt.save(self.state, step, blocking=True)
        self._log(report, "ckpt", step=step, blocking=True)
        return report


def _block(metrics):
    """Wait for the step's device work, as JAX's ``block_until_ready``:
    read every tensor of the metrics back to the host (on the card a
    read waits for the stream that wrote it; a loss read is enough)."""
    if isinstance(metrics, dict):
        for v in metrics.values():
            _block(v)
    elif isinstance(metrics, (list, tuple)):
        for v in metrics:
            _block(v)
    elif isinstance(metrics, torch.Tensor):
        metrics.detach().cpu()
