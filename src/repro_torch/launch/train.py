"""Training entry point of the port: one device (gspmd), HaiScale DDP
with HFReduce over ranks (ddp), or the pipelined path (pp).

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --smoke --device cpu --steps 5 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 8 --batch 2 --seq 2048
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch gpt2-medium --smoke --device cpu --parallel ddp --pods 2 \\
      --compress int8 --steps 5 --batch 16 --seq 64
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch phi4-mini-3.8b --smoke --device cpu --parallel pp \\
      --pp-stages 2 --pp-schedule 1f1b --pp-microbatches 4 --steps 5 \\
      --batch 16 --seq 64

Runs on the card by default (``--device cuda``) and stops with an error
when there is none; ``--device cpu`` runs the plain PyTorch path.
``--smoke`` runs the reduced config: in float32 on the CPU, as the JAX
launcher's smoke runs do; on the card in its bf16 with heads of at
least 64 (the flash kernels take head dim 64 or 128).  Weights are random,
drawn from ``--seed`` straight into the compute dtype (at full width a
float32 draw would hold 15 GB beside the optimizer state); AdamW keeps
float32 masters of them.  Data is the synthetic LM stream, one global
batch of ``--batch`` rows per step.  One loss line per step (rank 0).

``--parallel ddp`` reads ``RANK`` and ``WORLD_SIZE`` as torchrun sets
them (one process when they are unset), joins a gloo process group
(``MASTER_ADDR`` / ``MASTER_PORT``, or an already initialised one) and
splits the world into ``--pods`` pods (``core.grid.Grid``); each rank
takes its rows of the global batch.  On the card the collectives are
staged through pinned host memory (HFReduce's own path); the ranks may
share one card.  ``--compress``, ``--bucket-mb``, ``--zero1`` and
``--no-overlap`` shape the gradient sync and are refused with
``--parallel gspmd``, as the JAX launcher refuses them.

``--parallel pp`` joins the ranks the same way and runs GPipe or 1F1B
(``--pp-schedule``, ``--pp-microbatches`` a rank's batch is cut into)
over ``--pp-stages`` stages (default, as the JAX launcher's: the largest
count that divides both the model's layers and the world) on the grid
the JAX launcher's ``build_mesh`` builds: stages x 1 pod x world /
stages (``parallel/pp.py``).  ``--compress`` and ``--bucket-mb`` shape
the sync over a stage's ranks; ``--zero1``, ``--no-overlap`` and
``--pods`` apply to ddp only.

Checkpoints, as the JAX launcher writes them: ``--ckpt-dir`` builds an
``elastic.ElasticCheckpointer`` (plan-stamped steps, ``plan.json``
beside each ``index.json``), on plain files or, with ``--ckpt-fs3``, on
an in-process 3FS cluster under the directory; a save every
``--ckpt-every`` steps (off the critical path with ``--ckpt-async``:
the host copy on this thread, the write on a background one) and a
blocking one at the end.  A checkpoint's step is the number of steps
its state has taken, so ``--resume`` restores the latest one and starts
the loader (``data.make_synthetic_loader``, a prefetching thread) at
that step; a checkpoint stamped under another plan is refused unless
``--resume-plan`` reshards it onto this run's.  Under ddp and pp rank 0
of the whole grid writes.

``--trace PATH`` installs a ``telemetry.TraceWriter`` for the run and
writes its Chrome-trace JSON at exit (``train.step``, the checkpoint's
``ckpt.*`` spans; load it in ``chrome://tracing`` or Perfetto); under
ddp and pp rank r > 0 writes ``PATH`` with ``.rank<r>`` before its
suffix.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --smoke --device cpu --steps 4 --ckpt-dir /tmp/ck --ckpt-fs3 \\
      --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --smoke --device cpu --steps 6 --ckpt-dir /tmp/ck --ckpt-fs3 --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch.telemetry import now


def build_plan(args):
    """The ParallelPlan of the parsed flags; refuses the combinations the
    JAX launcher refuses (``repro/launch/train.py:build_plan``)."""
    from repro_torch.parallel.plan import ParallelPlan
    bucket_bytes = args.bucket_mb * (1 << 20) if args.bucket_mb else None
    if args.parallel != "ddp":
        # refuse rather than silently ignore explicit-DDP-only knobs
        for flag, name in ((args.zero1, "--zero1"),
                           (args.no_overlap, "--no-overlap")):
            if flag:
                raise SystemExit(f"{name} applies to --parallel ddp only")
    if args.parallel == "gspmd":
        if args.compress or args.bucket_mb:
            raise SystemExit("--compress/--bucket-mb apply to the "
                             "explicit paths (--parallel ddp/pp) only")
        return ParallelPlan(mode="gspmd", tp=1, fsdp=False, zero1=False,
                            batch_axes=("data",),
                            microbatch=args.microbatch)
    if args.parallel == "ddp":
        return ParallelPlan(mode="ddp", batch_axes=("pod", "data"),
                            compress=args.compress,
                            bucket_bytes=bucket_bytes,
                            overlap=not args.no_overlap and not args.zero1,
                            zero1=args.zero1)
    if args.pods != 1:
        raise SystemExit("--pods applies to --parallel ddp only (the pp "
                         "grid has one pod, as the JAX launcher's mesh)")
    return ParallelPlan(mode="pp", batch_axes=("pod", "data"),
                        compress=args.compress, bucket_bytes=bucket_bytes,
                        pp_schedule=args.pp_schedule,
                        pp_microbatches=args.pp_microbatches)


def _grid(args, dev, n_layers):
    """Join (or start) the process group and build the grid: pods x data
    for ddp, stages x 1 pod x world / stages for pp; returns (grid,
    whether this call started the group)."""
    import torch.distributed as dist

    from repro_torch.core.grid import Grid, free_port
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    started = not dist.is_initialized()
    if started:
        if "MASTER_ADDR" not in os.environ and world == 1:
            init = f"tcp://localhost:{free_port()}"
        else:
            init = "env://"
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
    if (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise SystemExit(f"RANK/WORLD_SIZE {rank}/{world} disagree with the "
                         f"process group ({dist.get_rank()}/"
                         f"{dist.get_world_size()})")
    staging = "host" if dev.type == "cuda" else None
    if args.parallel == "pp":
        stages = args.pp_stages or max(
            d for d in range(1, world + 1)
            if n_layers % d == 0 and world % d == 0)
        if world % stages:
            raise SystemExit(f"--pp-stages {stages} does not divide the "
                             f"world of {world} ranks")
        return Grid(1, world // stages, stages, staging=staging), started
    if world % args.pods:
        raise SystemExit(f"--pods {args.pods} does not divide the world of "
                         f"{world} ranks")
    return Grid(args.pods, world // args.pods, staging=staging), started


def parser():
    """The launcher's flags (those of the JAX launcher, bar the
    deprecated ``--ddp``, plus ``--pods`` and ``--device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (float32 on the "
                         "CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (rows over all ranks)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-async", action="store_true",
                    help="write periodic checkpoints off the critical "
                         "path (host copy, then a background chunk write)")
    ap.add_argument("--ckpt-fs3", action="store_true",
                    help="checkpoint into an in-process 3FS cluster "
                         "(CRAQ-replicated) under --ckpt-dir instead of "
                         "plain files")
    ap.add_argument("--resume-plan", action="store_true",
                    help="allow resuming a checkpoint stamped under a "
                         "different ParallelPlan or grid (cross-plan "
                         "reshard of the flat masters)")
    ap.add_argument("--parallel", choices=("gspmd", "ddp", "pp"),
                    default="gspmd",
                    help="executor: gspmd (one device), ddp (HaiScale "
                         "DDP with HFReduce over RANK / WORLD_SIZE ranks) "
                         "or pp (GPipe / 1F1B over those ranks)")
    ap.add_argument("--pods", type=int, default=1,
                    help="ddp: pods the ranks split into (weak link "
                         "between them)")
    ap.add_argument("--compress", default="",
                    choices=("", "bf16", "fp8", "int8"),
                    help="ddp, pp: cross-pod wire format")
    ap.add_argument("--bucket-mb", type=int, default=0,
                    help="ddp, pp: gradient bucket size (default 25 MB)")
    ap.add_argument("--zero1", action="store_true",
                    help="ddp: shard fp32 masters and moments (ZeRO-1)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="ddp: sync the buckets after the backward")
    ap.add_argument("--pp-stages", type=int, default=0,
                    help="pp: pipeline stages (default: the largest count "
                         "dividing both the layers and the world)")
    ap.add_argument("--pp-schedule", choices=("gpipe", "1f1b"),
                    default="1f1b")
    ap.add_argument("--pp-microbatches", type=int, default=4,
                    help="pp: microbatches a rank's batch is cut into")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace JSON (chrome://tracing / "
                         "Perfetto) of the run's spans to this path")
    return ap


def trace_path(path: str, rank: int) -> str:
    """Where rank ``rank`` writes ``--trace PATH``: PATH itself on rank
    0, PATH with ``.rank<r>`` before its suffix on the others."""
    if rank == 0:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.rank{rank}{ext}"


def main(argv=None):
    args = parser().parse_args(argv)
    plan = build_plan(args)

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg = _config(args, dev)
    grid, started = _grid(args, dev, cfg.n_layers) \
        if plan.mode in ("ddp", "pp") else (None, False)
    writer = None
    if args.trace:
        from repro_torch.telemetry import TraceWriter, install_writer
        writer = TraceWriter()
        install_writer(writer)
    try:
        return _train(args, cfg, plan, dev, grid)
    finally:
        if writer is not None:
            from repro_torch.telemetry import uninstall_writer
            uninstall_writer()
            path = writer.write(trace_path(args.trace,
                                           grid.rank if grid else 0))
            print(f"trace written to {path}", flush=True)
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _checkpointer(args, plan, grid, state, talk):
    """(checkpointer or None, state, step to start at)."""
    if not args.ckpt_dir:
        return None, state, 0
    from repro_torch.elastic import ElasticCheckpointer, PlanMismatchError
    backend = args.ckpt_dir
    if args.ckpt_fs3:
        from repro_torch.ckpt import fs3_backend
        backend = fs3_backend(args.ckpt_dir)
    manager = ElasticCheckpointer(backend, plan, grid)
    if not args.resume:
        return manager, state, 0
    if args.resume_plan:
        restored = manager.restore_for(plan, grid, state["params"])
    else:
        try:
            restored = manager.restore_latest(state)
        except PlanMismatchError as e:
            raise SystemExit(f"{e}") from e
    if restored is None:
        return manager, state, 0
    state, start = restored
    if talk:
        print(f"resumed from step {start}", flush=True)
    return manager, state, start


def _config(args, dev):
    from repro_torch.configs.registry import get_arch, smoke_config
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    if args.smoke and dev.type == "cpu":
        return dataclasses.replace(cfg, compute_dtype="float32")
    if args.smoke:
        # the card's flash kernels take bf16 at head dim 64 or 128
        return dataclasses.replace(cfg, d_head=max(cfg.d_head, 64))
    return cfg


def _train(args, cfg, plan, dev, grid):
    from repro_torch.data import make_synthetic_loader
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import plan as plan_lib

    model = build_model(cfg)
    opt = AdamW(lr=warmup_cosine(args.lr, 5, args.steps),
                param_dtype=cfg.compute_dtype)
    params = model.init(args.seed, device=dev, dtype=cfg.compute_dtype)
    state = plan_lib.init_state(plan, opt, params, grid=grid)
    del params
    step_fn = plan_lib.make_train_step(plan, model, opt, device=dev,
                                       grid=grid)
    talk = grid is None or grid.rank == 0
    manager, state, start = _checkpointer(args, plan, grid, state, talk)

    # host numpy batches from the loader's thread; the step moves them
    # to the device on this one
    loader = make_synthetic_loader(cfg, args.batch, args.seq,
                                   seed=args.seed, start_step=start)
    t0 = now()
    losses = []
    try:
        for step, batch in loader:
            if step >= args.steps:
                break
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if talk and (step % args.log_every == 0
                         or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({(now() - t0) / (step - start + 1):.3f}s/step)",
                      flush=True)
            done = step + 1          # steps the state has taken
            if manager and args.ckpt_every and done < args.steps and \
                    done % args.ckpt_every == 0:
                manager.save(state, done, blocking=not args.ckpt_async)
    finally:
        loader.stop()
        if manager:
            manager.wait()
    if manager:
        manager.save(state, start + len(losses), blocking=True)
    if talk and losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
