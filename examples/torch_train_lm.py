"""End-to-end training with the PyTorch port: a GPT2-medium-family LM on
synthetic data with the full substrate — the prefetching loader,
periodic chunked checkpoints to a 3FS cluster in a work directory,
resume, and the warmup-cosine LR schedule.  The port's counterpart of
``examples/train_lm.py``.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300   # the card
  PYTHONPATH=src python examples/torch_train_lm.py --steps 40 --small \\
      --device cpu

Runs on the card by default and stops with an error when there is none.
Run it again with the same ``--workdir`` to resume from the latest
checkpoint: a checkpoint's step is the number of steps its state has
taken, and the loader starts there.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.manager import _FS3Backend
from repro_torch.configs.registry import get_arch
from repro_torch.data import make_synthetic_loader
from repro_torch.device import resolve_device
from repro_torch.fs3 import FS3Client, FS3Cluster
from repro_torch.models import build_model
from repro_torch.models.params import count_params
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.parallel import ParallelPlan, init_state, make_train_step
from repro_torch.telemetry import now


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--small", action="store_true",
                    help="shrink the model for a fast demo")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_arch("gpt2-medium")
    if args.small:
        # heads of 64: the card's flash kernels take head dim 64 or 128
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=256, n_heads=4,
                                  n_kv_heads=4, d_head=64, d_ff=1024,
                                  vocab_size=8192)
    if dev.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = build_model(cfg)
    print(f"training {cfg.name}: {count_params(model.param_defs()):,} "
          f"params on {dev}")

    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps),
                param_dtype=cfg.compute_dtype)
    plan = ParallelPlan(mode="gspmd", tp=1, fsdp=False,
                        batch_axes=("data",))
    state = init_state(plan, opt, model.init(0, device=dev,
                                             dtype=cfg.compute_dtype))
    step_fn = make_train_step(plan, model, opt, device=dev)

    workdir = args.workdir or tempfile.mkdtemp(prefix="torch_train_lm_")
    cluster = FS3Cluster(os.path.join(workdir, "fs3"), n_nodes=2,
                         targets_per_node=2, replication=2)
    mgr = CheckpointManager(_FS3Backend(FS3Client(cluster)), period_s=60.0)
    start = 0
    restored = mgr.restore_latest(state)
    if restored:
        state, start = restored
        print(f"resumed from step {start}")

    loader = make_synthetic_loader(cfg, args.batch, args.seq,
                                   start_step=start)
    t0 = now()
    done = start
    try:
        for step, batch in loader:
            if step >= args.steps:
                break
            state, metrics = step_fn(state, batch)
            done = step + 1
            if step % 10 == 0:
                print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                      f"({(now() - t0) / (done - start):.2f}s/step)")
            mgr.maybe_save(state, done)
    finally:
        loader.stop()
        mgr.wait()
    mgr.save(state, done, blocking=True)
    print(f"done at step {done}; checkpoints in {workdir} (3FS-backed, "
          "CRAQ-replicated)")


if __name__ == "__main__":
    main()
