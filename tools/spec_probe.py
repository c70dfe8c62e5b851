"""The serving phases of ``chip_smoke.py`` alone, with the speculative,
cluster and prefix-store parts timed, after the paged kernel's cases at
the verify window and the self-draft's dense cache (development).

  python3 tools/spec_probe.py      # from the repo root, on the card
"""
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
    dev = torch.device("cuda:0")
    for kw in (dict(T=cs.SPEC_K + 1, bs=16),
               dict(T=1, bs=0, b=8, dense_view=True,
                    cap=cs.SPEC_DRAFT_MAX_LEN)):
        r = cs.check_paged(dev, kv_dtype="bfloat16", **kw)
        print(json.dumps({"paged_case": r}), flush=True)
    for n in ("e2e_run", "teacher_forced", "profiled", "spec_run",
              "stream_gate", "cluster_run", "store_roundtrip",
              "moe_layer_check", "ssd_gate_probe"):
        setattr(cs, n, timed(n, getattr(cs, n)))
    for name, phase in (("phi4 serving", cs.e2e_phase),
                        ("moe serving", cs.moe_serve_phase),
                        ("hybrid serving", cs.hybrid_serve_phase)):
        TIMES.clear()
        t = now()
        out = phase(dev)
        fails = out[1] if isinstance(out, tuple) else out["spec_failures"]
        print(json.dumps({"probe_phase": name, "seconds": now() - t,
                          "parts": TIMES, "failures": fails}), flush=True)
        torch.cuda.empty_cache()
