"""Training entry point of the port: one device (gspmd) or HaiScale DDP
with HFReduce over ranks (ddp).

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --smoke --device cpu --steps 5 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 8 --batch 2 --seq 2048
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch gpt2-medium --smoke --device cpu --parallel ddp --pods 2 \\
      --compress int8 --steps 5 --batch 16 --seq 64

Runs on the card by default (``--device cuda``) and stops with an error
when there is none; ``--device cpu`` runs the plain PyTorch path.
``--smoke`` runs the reduced config in float32.  Weights are random,
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
``--parallel gspmd``, as the JAX launcher refuses them.  The pipelined
path is ROADMAP A13, checkpoints A8.
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
        if args.compress or args.bucket_mb:
            raise SystemExit("--compress/--bucket-mb apply to the "
                             "explicit path (--parallel ddp) only")
        return ParallelPlan(mode="gspmd", tp=1, fsdp=False, zero1=False,
                            batch_axes=("data",),
                            microbatch=args.microbatch)
    return ParallelPlan(mode="ddp", batch_axes=("pod", "data"),
                        compress=args.compress, bucket_bytes=bucket_bytes,
                        overlap=not args.no_overlap and not args.zero1,
                        zero1=args.zero1)


def _grid(args, dev):
    """Join (or start) the process group and build the pods x data
    grid; returns (grid, whether this call started the group)."""
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
    if world % args.pods:
        raise SystemExit(f"--pods {args.pods} does not divide the world of "
                         f"{world} ranks")
    return Grid(args.pods, world // args.pods,
                stage="host" if dev.type == "cuda" else None), started


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config in float32")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (rows over all ranks)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parallel", choices=("gspmd", "ddp"), default="gspmd",
                    help="executor: gspmd (one device) or ddp (HaiScale "
                         "DDP with HFReduce over RANK / WORLD_SIZE ranks)")
    ap.add_argument("--pods", type=int, default=1,
                    help="ddp: pods the ranks split into (weak link "
                         "between them)")
    ap.add_argument("--compress", default="",
                    choices=("", "bf16", "fp8", "int8"),
                    help="ddp: cross-pod wire format")
    ap.add_argument("--bucket-mb", type=int, default=0,
                    help="ddp: gradient bucket size (default 25 MB)")
    ap.add_argument("--zero1", action="store_true",
                    help="ddp: shard fp32 masters and moments (ZeRO-1)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="ddp: sync the buckets after the backward")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    plan = build_plan(args)

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    grid, started = _grid(args, dev) if plan.mode == "ddp" else (None, False)
    try:
        return _train(args, plan, dev, grid)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, plan, dev, grid):
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import plan as plan_lib

    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg)
    opt = AdamW(lr=warmup_cosine(args.lr, 5, args.steps),
                param_dtype=cfg.compute_dtype)
    params = model.init(args.seed, device=dev, dtype=cfg.compute_dtype)
    state = plan_lib.init_state(plan, opt, params, grid=grid)
    del params
    step_fn = plan_lib.make_train_step(plan, model, opt, device=dev,
                                       grid=grid)
    talk = grid is None or grid.rank == 0

    t0 = now()
    losses = []
    for step in range(args.steps):
        batch = batch_for_model(cfg, "train", step, args.batch, args.seq,
                                seed=args.seed)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if talk:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({(now() - t0) / (step + 1):.3f}s/step)", flush=True)
    if talk:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
