"""Where the serving phases' seconds go, then the ft phase (development)."""
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402

TIMES = {}


def timed(name, fn):
    def wrapper(*a, **k):
        from repro_torch.telemetry import now
        t = now()
        try:
            return fn(*a, **k)
        finally:
            TIMES[name] = TIMES.get(name, 0.0) + now() - t
    return wrapper


if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    from repro_torch.kernels import build
    from repro_torch.telemetry import now
    print("card:", cs.card_line(), flush=True)
    build.build_all()
    import repro_torch.launch.serve as serve
    serve.build = timed("build", serve.build)
    for n in ("e2e_run", "teacher_forced", "profiled", "logit_rows",
              "moe_layer_check", "ssd_gate_probe", "with_patches"):
        setattr(cs, n, timed(n, getattr(cs, n)))
    dev = torch.device("cuda:0")
    for name, phase in (("phi4 serving", cs.e2e_phase),
                        ("moe serving", cs.moe_serve_phase),
                        ("hybrid serving", cs.hybrid_serve_phase),
                        ("ft", cs.ft_phase)):
        TIMES.clear()
        t = now()
        out = phase(dev)
        fails = out[1] if isinstance(out, tuple) else []
        print(json.dumps({"probe_phase": name, "seconds": now() - t,
                          "parts": TIMES, "failures": fails}), flush=True)
        torch.cuda.empty_cache()
