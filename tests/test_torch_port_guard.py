"""The PyTorch port's boundaries: it never imports JAX or the JAX
package, its entry points refuse to run without a card unless told to
use the CPU, and weights cross from JAX bitwise."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    """Importing every module of the port in a fresh interpreter leaves
    jax (and the JAX package) out of sys.modules."""
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_guard_scans_the_moe_slice():
    """The import and source scans above reach the MoE family's modules
    (they walk every file of the port)."""
    mods = _port_modules()
    for m in ("repro_torch.models.moe", "repro_torch.kernels.topk_gating",
              "repro_torch.kernels.topk_gating.kernel",
              "repro_torch.kernels.topk_gating.ops",
              "repro_torch.kernels.topk_gating.ref"):
        assert m in mods, m


def test_guard_scans_the_hybrid_slice():
    """The import and source scans reach the hybrid family's modules and
    the SSD chunk-scan kernel's."""
    mods = _port_modules()
    for m in ("repro_torch.models.ssm_common", "repro_torch.models.mamba2",
              "repro_torch.models.zamba", "repro_torch.kernels.ssd_scan",
              "repro_torch.kernels.ssd_scan.kernel",
              "repro_torch.kernels.ssd_scan.ops",
              "repro_torch.kernels.ssd_scan.ref"):
        assert m in mods, m


def test_guard_scans_the_ddp_slice():
    """The import and source scans reach HaiScale DDP's modules, the
    multi-process harness and the int8 quant_comm kernel's."""
    mods = _port_modules()
    for m in ("repro_torch.core", "repro_torch.core.grid",
              "repro_torch.core.compression", "repro_torch.core.hfreduce",
              "repro_torch.core.tree_allreduce",
              "repro_torch.core.bucketing", "repro_torch.core.ddp",
              "repro_torch.testing.multidev",
              "repro_torch.kernels.quant_comm",
              "repro_torch.kernels.quant_comm.kernel",
              "repro_torch.kernels.quant_comm.ops",
              "repro_torch.kernels.quant_comm.ref"):
        assert m in mods, m


def test_port_sources_never_name_the_jax_package():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                     r"(\.|\s))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def test_port_clock_is_telemetry_now():
    """One clock: no raw time.perf_counter / time.time outside
    repro_torch/telemetry (the CI guard's rule)."""
    pat = re.compile(r"time\.(perf_counter|time)")
    bad = [str(f) for f in PORT.rglob("*.py")
           if "telemetry" not in f.parts and pat.search(f.read_text())]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_or_explicit_cpu(no_cuda):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.parallel import ParallelPlan, make_train_step
    from repro_torch.serving import ServingEngine

    model = build_model(smoke_config("phi4-mini-3.8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "phi4-mini-3.8b", "--smoke"])
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, params)
    eng = ServingEngine(model, params, device="cpu", n_blocks=4)
    assert eng.cache.k.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(ParallelPlan(), model, AdamW())
    assert callable(make_train_step(ParallelPlan(), model, AdamW(),
                                    device="cpu"))


def test_unported_families_raise():
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    for arch in ("xlstm-125m", "whisper-base", "internvl2-76b"):
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(smoke_config(arch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "float8_e4m3fn"])
def test_bridge_roundtrip_bitwise(dtype):
    import ml_dtypes
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 7)).astype(np.float32) * 4
    npdt = getattr(ml_dtypes, dtype) if dtype in ("bfloat16",
                                                  "float8_e4m3fn") else dtype
    tree = {"layers": {"w": x.astype(npdt)}, "embed": x[0].astype(npdt)}
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    for a, b in ((tree["layers"]["w"], back["layers"]["w"]),
                 (tree["embed"], back["embed"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_init_tree_sorted_leaves_and_count():
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.params import count_params, tree_leaves
    cfg = smoke_config("phi4-mini-3.8b")
    model = build_model(cfg)
    defs = model.param_defs()
    a = model.init(3, device="cpu")
    b = model.init(3, device="cpu")
    assert list(a) == sorted(a) and list(a["layers"]) == sorted(a["layers"])
    for x, y, d in zip(tree_leaves(a), tree_leaves(b), tree_leaves(defs)):
        assert tuple(x.shape) == d.shape
        assert torch.equal(x, y)
    assert count_params(defs) == sum(x.numel() for x in tree_leaves(a))
