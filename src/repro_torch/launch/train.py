"""Training entry point of the port: one device, the gspmd executor.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --smoke --device cpu --steps 5 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 8 --batch 2 --seq 2048

Runs on the card by default (``--device cuda``) and stops with an error
when there is none; ``--device cpu`` runs the plain PyTorch path.
``--smoke`` runs the reduced config in float32.  Weights are random,
drawn from ``--seed`` straight into the compute dtype (at full width a
float32 draw would hold 15 GB beside the optimizer state); AdamW keeps
float32 masters of them.  Data is the synthetic LM stream, one batch per
step.  One loss line per step.  ``--parallel`` takes only ``gspmd``:
DDP and the pipelined path are ROADMAP A7 and A13, checkpoints A8.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.telemetry import now


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config in float32")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parallel", choices=("gspmd",), default="gspmd",
                    help="executor (only gspmd on one device is ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import plan as plan_lib

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg)
    opt = AdamW(lr=warmup_cosine(args.lr, 5, args.steps),
                param_dtype=cfg.compute_dtype)
    plan = plan_lib.ParallelPlan(mode=args.parallel,
                                 microbatch=args.microbatch)
    params = model.init(args.seed, device=dev, dtype=cfg.compute_dtype)
    state = plan_lib.init_state(plan, opt, params)
    del params
    step_fn = plan_lib.make_train_step(plan, model, opt, device=dev)

    t0 = now()
    losses = []
    for step in range(args.steps):
        batch = batch_for_model(cfg, "train", step, args.batch, args.seq,
                                seed=args.seed)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        print(f"step {step:5d} loss {loss:.4f} "
              f"({(now() - t0) / (step + 1):.3f}s/step)", flush=True)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
