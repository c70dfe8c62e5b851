"""Elastic fault-tolerance drill of the PyTorch port, end to end (the
port's counterpart of ``examples/fault_tolerant_train.py``):

  1. train a 2-stage pipeline across 4 gloo ranks (pipe 2 x pod 1 x
     data 2), with plan-stamped checkpoints written asynchronously into
     an in-process 3FS cluster;
  2. inject a *fatal* hardware failure drawn from the paper's Table-V
     failure model mid-window (the "kill"); every rank runs the node
     validator;
  3. the platform reshards the last checkpoint's flat fp32 masters onto
     ddp + ZeRO-1 over the first 2 ranks (the "rescale"); ranks 2 and 3
     leave the gang;
  4. training resumes on the smaller gang with the same global batch and
     the loss keeps tracking an unbroken pp run.

  PYTHONPATH=src python examples/torch_fault_tolerant_train.py
  PYTHONPATH=src python examples/torch_fault_tolerant_train.py --device cpu

Runs on the card by default (the 4 ranks share it, collectives staged
through pinned host memory) and stops with an error when there is none;
``--device cpu`` runs the plain PyTorch path.  The model is the
phi4-mini smoke config with 2 layers: float32 on the CPU, bf16 with
heads of 64 on the card (the flash kernels' head dims).
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))

STEPS, KILL_AT, CKPT_EVERY = 14, 7, 5
BATCH, SEQ = 16, 32


def setup(device):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(smoke_config("phi4-mini-3.8b"), n_layers=2)
    if str(device) == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    else:
        cfg = dataclasses.replace(cfg, d_head=max(cfg.d_head, 64))
    model = build_model(cfg)
    opt = AdamW(lr=1e-3, param_dtype=cfg.compute_dtype)
    return cfg, model, opt, model.init(0, device=device,
                                       dtype=cfg.compute_dtype)


def drill(grid, device, root):
    """One rank: the unbroken pp run, then the run that fails and
    rescales.  Returns its losses and report (numbers only)."""
    import torch

    from repro_torch.ckpt import fs3_backend
    from repro_torch.core.grid import Grid
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.elastic import ElasticCheckpointer
    from repro_torch.models.params import tree_map
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    from repro_torch.platform import (FailureInjector, FailureModel,
                                      FTRunner, GangExit, Validator)

    # both grids, built by every rank before any rank leaves: healthy =
    # pp over the 4 ranks, degraded = ddp + ZeRO-1 over ranks 0 and 1
    survivors = Grid(1, 2, staging=grid.staging, members=2)
    cfg, model, opt, params = setup(device)
    plan_pp = ParallelPlan(mode="pp", pp_microbatches=2)
    plan_dp = ParallelPlan(mode="ddp", zero1=True, overlap=False)

    def plan_for(world):
        return (plan_pp, grid) if world >= 2 else (plan_dp, survivors)

    def fetch(i):
        return batch_for_model(cfg, "train", i, BATCH, SEQ)

    def fresh():
        return init_state(plan_pp, opt, tree_map(torch.clone, params), grid)

    step_pp = make_train_step(plan_pp, model, opt, device=device, grid=grid)
    ref, state = [], fresh()
    for i in range(STEPS):
        state, m = step_pp(state, fetch(i))
        ref.append(float(m["loss"]))
    del state

    fm = FailureModel(seed=1)
    cls = next(e.cls for e in fm.sample(1250, 48.0) if e.fatal)
    talk = grid.rank == 0
    if talk:
        print(f"node MTBF {fm.mtbf_node_hours():.0f}h; at 1250 nodes one "
              f"failure every {fm.cluster_mtbf_hours(1250):.2f}h "
              f"-> 5-min checkpoints\ninjecting fatal {cls!r} at step "
              f"{KILL_AT}", flush=True)
    losses, cache = [], {}

    def make_step(world):
        if world not in cache:
            p, g = plan_for(world)
            if talk:
                print(f"  [platform] building {p.mode} step for world="
                      f"{world} ({g.ranks} ranks)", flush=True)
            base = step_pp if p is plan_pp else make_train_step(
                p, model, opt, device=device, grid=g)

            def wrapped(state, batch, _base=base):
                state, m = _base(state, batch)
                losses.append(float(m["loss"]))
                return state, m
            cache[world] = wrapped
        return cache[world]

    # async plan-stamped checkpoints into a CRAQ-replicated 3FS cluster
    mgr = ElasticCheckpointer(fs3_backend(root), plan_pp, grid)
    injector = FailureInjector({KILL_AT: cls})

    def restore_fn(template, new_world):
        p, g = plan_for(new_world)
        if not g.member:               # this rank leaves the gang
            raise GangExit(KILL_AT, new_world)
        return mgr.restore_for(p, g, template["params"])  # reshard

    runner = FTRunner(make_step, fetch, mgr, fresh(), world_size=2,
                      min_world=1, ckpt_every=CKPT_EVERY, injector=injector,
                      validator=Validator(gemm_n=256, mem_mb=16,
                                          storage_mb=8, device=device,
                                          grid=grid),
                      restore_fn=restore_fn,
                      on_event=lambda k, kw: talk and print(
                          f"  [event] {k} {kw}", flush=True))
    try:
        report = runner.run(STEPS)
    except GangExit as e:
        return {"rank": grid.rank, "left": str(e)}
    return {"rank": grid.rank, "ref": ref, "losses": losses,
            "world": runner.world,
            "report": {k: getattr(report, k) for k in (
                "steps_done", "failures", "restores", "rescales",
                "lost_steps")},
            "events": [{k: v for k, v in e.items() if k != "t"}
                       for e in report.events]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.testing.multidev import run_ranks
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = "cuda:0"
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(drill, 1, 2, device=str(dev),
                          staging="host" if str(dev) != "cpu" else None,
                          args=(d,), timeout=900, pipe=2)
    for out, _ in ranks[2:]:
        print(f"rank {out['rank']}: {out['left']}")
    r0 = ranks[0][0]
    rep = r0["report"]
    print(f"\nsteps={rep['steps_done']} failures={rep['failures']} "
          f"restores={rep['restores']} rescales={rep['rescales']} "
          f"lost_steps={rep['lost_steps']} world={r0['world']}")
    for e in r0["events"]:
        print("  " + json.dumps(e))
    # post-restore losses replay the lost window on the smaller gang
    cont = r0["losses"][KILL_AT:]
    err = max(abs(a - b) for a, b in zip(
        cont, r0["ref"][KILL_AT - rep["lost_steps"]:]))
    print(f"\nloss: first={r0['losses'][0]:.4f} last={r0['losses'][-1]:.4f}"
          f" (reshard divergence vs unbroken pp run: {err:.2e})")
    assert r0["world"] == 1 and rep["rescales"] == 1
    assert err <= (1e-5 if str(dev) == "cpu" else 1e-2 * abs(cont[0])), err
    assert r0["losses"][-1] < r0["losses"][0]


if __name__ == "__main__":
    main()
