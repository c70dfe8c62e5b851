"""Build the port's CUDA C++ kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled on its own by ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  Libraries land in ``build/kernels/`` at
the repository root (listed in ``.gitignore``), named by a hash of the
source so an edited source never loads a stale library.  ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; ``check``
raises when that is not 0.  A build that fails raises with nvcc's
output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.telemetry import now

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

# kernel name -> its CUDA source, relative to repro_torch/kernels/
SOURCES = {
    "flash_attention": "flash_attention/csrc/flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "paged_chunk_attention":
        "paged_chunk_attention/csrc/paged_chunk_attention.cu",
    "topk_gating": "topk_gating/csrc/topk_gating.cu",
    "ssd_scan": "ssd_scan/csrc/ssd_scan.cu",
    "quant_comm": "quant_comm/csrc/quant_comm.cu",
}
_INCLUDE = _KERNELS / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_libs: dict = {}
build_logs: dict = {}       # kernel name -> nvcc's output (ptxas -v)


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def lib_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    src = _KERNELS / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(_INCLUDE.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel source not yet built, one
    ``nvcc`` process per source, all running together.  Returns
    {name: seconds} for what was compiled; raises on any failure."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = now()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-I", str(_INCLUDE), "-o", str(tmp),
               str(_KERNELS / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    times, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[n] = now() - t0
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
