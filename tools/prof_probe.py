"""The profiled serving run with the device's activity alone against
the device's and the host's (development)."""
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402


def both(run, top=12):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry import now
    torch.cuda.synchronize()
    t = now()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        run()
        torch.cuda.synchronize()
        wall_ms = (now() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms, "rows": len(rows),
            "seconds_with_analysis": now() - t}


if __name__ == "__main__":
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build as build_model
    from repro_torch.telemetry import now
    print("card:", cs.card_line(), flush=True)
    build.build_all()
    dev = torch.device("cuda:0")
    cfg, model, params = build_model(cs.ARCH, device=dev, seed=cs.SEED)
    prompts, arrivals = cs.request_set(cfg.vocab_size)
    cs.e2e_run(model, params, [prompts[0][:64], prompts[4][:80]], [0, 0],
               dev, 0, gen=4)
    run = lambda: cs.e2e_run(model, params, prompts, arrivals, dev, 0)  # noqa
    for label, fn in (("device only", cs.profiled), ("host and device", both),
                      ("device only, again", cs.profiled)):
        t = now()
        out = fn(run)
        out = {k: v for k, v in out.items() if k != "top"}
        out.pop("attention", None)
        out.pop("rmsnorm_bwd", None)
        print(json.dumps({"profile": label, "seconds": now() - t, **out}),
              flush=True)
