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
    jax (and the JAX package) out of sys.modules, and msgpack and
    ml_dtypes too: the card's machine need not have them."""
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'msgpack', 'ml_dtypes'))\n"
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


def test_guard_scans_the_checkpoint_slice():
    """The import and source scans reach 3FS, the checkpoint manager,
    the elastic checkpointer and the prefetch loader."""
    mods = _port_modules()
    for m in ("repro_torch.fs3", "repro_torch.fs3.storage",
              "repro_torch.fs3.craq", "repro_torch.fs3.codec",
              "repro_torch.fs3.meta", "repro_torch.fs3.client",
              "repro_torch.fs3.kv", "repro_torch.ckpt",
              "repro_torch.ckpt.manager", "repro_torch.elastic",
              "repro_torch.elastic.manifest", "repro_torch.elastic.reshard",
              "repro_torch.elastic.sharded", "repro_torch.data.loader"):
        assert m in mods, m


def test_guard_scans_the_pp_slice():
    """The import and source scans reach the pipelined path and the
    modules it changed: the plan, the grid's pipe axis, the launcher."""
    mods = _port_modules()
    for m in ("repro_torch.parallel.pp", "repro_torch.parallel.plan",
              "repro_torch.core.grid", "repro_torch.launch.train"):
        assert m in mods, m


def test_guard_scans_the_platform_slice():
    """The import and source scans reach HAI-Platform's modules and the
    trace module (no jax, no repro.*); the trace module keeps the one
    clock the rest of the port reads (``telemetry.now``)."""
    mods = _port_modules()
    for m in ("repro_torch.platform", "repro_torch.platform.failures",
              "repro_torch.platform.scheduler",
              "repro_torch.platform.validator",
              "repro_torch.platform.runner", "repro_torch.telemetry",
              "repro_torch.telemetry.trace"):
        assert m in mods, m
    import time

    from repro_torch import telemetry
    from repro_torch.telemetry import trace
    assert telemetry.now is trace.now is time.perf_counter


def test_guard_scans_the_speculative_and_cluster_slice():
    """The import and source scans reach speculation, the cluster, the
    3FS prefix store and serve_lib; a fresh interpreter importing them
    alone loads no jax, repro, msgpack or ml_dtypes."""
    new = ("repro_torch.serving.speculative", "repro_torch.serving.cluster",
           "repro_torch.serving.prefix_store", "repro_torch.serve_lib")
    mods = _port_modules()
    for m in new + ("repro_torch.serving.engine",
                    "repro_torch.serving.paged_cache",
                    "repro_torch.launch.serve"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {new!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'msgpack', 'ml_dtypes'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    pat = re.compile(r"\b(jax|ml_dtypes|msgpack)\b|^\s*(import|from)\s+"
                     r"repro[.\s]", re.M)
    for m in new:
        src = (ROOT / "src" / (m.replace(".", "/") + ".py")).read_text()
        code_lines = "\n".join(
            ln for ln in src.splitlines()
            if ln.lstrip().startswith(("import ", "from ")))
        assert not pat.search(code_lines), m


# the one import of either outside the tests: the bridge's lazy import,
# on the path that hands bf16 / e4m3 tensors to numpy (CPU tests only)
_CARD_ABSENT_OK = {("bridge.py", "ml_dtypes")}


def test_port_never_imports_msgpack_or_ml_dtypes():
    """No module of the port and nothing in chip_smoke.py imports
    msgpack or ml_dtypes (3FS packs with ``fs3/codec.py``, checkpoints
    name dtypes by ``ckpt.manager.DTYPE_NAMES``), bar the named
    exception, which is a lazy import inside a function."""
    pat = re.compile(r"^(\s*)(?:import|from)\s+(msgpack|ml_dtypes)\b", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = {(f.name, m.group(2)): m.group(1)
             for f in files for m in pat.finditer(f.read_text())}
    assert set(found) == _CARD_ABSENT_OK, found
    assert all(indent for indent in found.values()), found


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


def test_every_family_builds_and_the_xlstm_slice_is_scanned():
    """``build_model`` builds all six families of the JAX package on the
    CPU (dense, MoE, hybrid, ssm, audio, vlm), and the import and source
    scans reach ``models/xlstm.py``, whose source names neither jax nor
    the JAX package."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    families = set()
    for arch in ("phi4-mini-3.8b", "qwen2-moe-a2.7b", "zamba2-1.2b",
                 "xlstm-125m", "whisper-base", "internvl2-76b"):
        cfg = smoke_config(arch)
        params = build_model(cfg).init(0, device="cpu")
        assert params["embed"].device.type == "cpu"
        families.add(cfg.family)
    assert families == {"dense", "moe", "hybrid", "ssm", "audio", "vlm"}
    assert "repro_torch.models.xlstm" in _port_modules()
    src = (PORT / "models" / "xlstm.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|repro)\b", src, re.M)


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
