"""The families phase of ``chip_smoke.py`` alone (xlstm-125m,
whisper-base, internvl2-76b with 2 layers: serving, training, their
gates and planted faults), after the flash kernels' non-causal cases at
whisper-base's shapes, each part timed (development).

  python3 tools/families_probe.py      # from the repo root, on the card
"""
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
    dev = torch.device("cuda:0")
    failures = []
    t = now()
    for sq in (cs.WHISPER_FRAMES, cs.WHISPER_TRAIN[1], 1):
        r = cs.check_flash(dev, sq, b=cs.FAM_REQUESTS,
                           skv=cs.WHISPER_FRAMES, causal=False, h=8, kvh=8,
                           d=64)
        print(json.dumps({"kernel": "flash_attention", **r}), flush=True)
        failures += [f"{r['case']}: {r['max_abs_err']}"] if not r["ok"] \
            else []
        failures += [f"{r['case']}: '{c['fault']}' passed"
                     for c in r["controls"] if not c["caught"]]
    for sq in (cs.WHISPER_FRAMES, cs.WHISPER_TRAIN[1]):
        out = cs.check_flash_bwd(dev, b=cs.WHISPER_TRAIN[0], sq=sq,
                                 skv=cs.WHISPER_FRAMES, h=8, kvh=8, d=64,
                                 causal=False)
        for name, r in out.items():
            print(json.dumps({"kernel": name, **r}), flush=True)
            failures += [f"{name} {r['case']}"] if not (
                r["ok"] and r["chained"]["ok"]) else []
            failures += [f"{name} {r['case']}: '{c['fault']}' passed"
                         for c in r["controls"] if not c["caught"]]
    print(json.dumps({"probe_phase": "non-causal kernel cases",
                      "seconds": now() - t}), flush=True)
    for arch in (cs.XLSTM_ARCH, cs.WHISPER_ARCH, cs.VLM_ARCH):
        t = now()
        rec, f = cs.family_phase(arch, dev)
        failures += f
        print(json.dumps({"probe_phase": arch, "seconds": now() - t,
                          "serve": rec["serve"],
                          "train": {k: rec["train"][k] for k in (
                              "median_step_s", "tokens_per_s",
                              "mfu_vs_bf16_dense_peak", "peak_mem_gb",
                              "launches_per_step", "losses")},
                          "busy": rec["train"]["profile"][
                              "device_busy_share"],
                          "failures": f}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"failures": failures}), flush=True)
    sys.exit(1 if failures else 0)
