"""The ft phase of chip_smoke.py alone on the card (development)."""
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    from repro_torch.kernels import build
    from repro_torch.telemetry import now
    print("card:", cs.card_line(), flush=True)
    build.build_all()
    t0 = now()
    out, fails = cs.ft_phase(torch.device("cuda:0"))
    print(json.dumps({"phase_s": now() - t0, "failures": fails}), flush=True)
    sys.exit(1 if fails else 0)
