"""Node validator (paper §VII-B): the weekly health suite that removes
faulty nodes from scheduling before they corrupt a run (port of
``repro/platform/validator.py``).

The six checks of the JAX validator, on torch and an explicit device
(default: the card): device inventory and dtype support, CPU memory
bandwidth, a device-memory pattern written on the device and read back,
a full fp32 GEMM against a float64 oracle (silent-data-corruption
detector), an allreduce over the run's ranks (``core.grid``: host-staged
gloo on the card; one rank without a grid) and storage write / read
bandwidth with an fsync.  Timings read ``telemetry.now``; each check of
``run_all`` runs under a ``validator.<check>`` span.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.telemetry import now, span

# the pattern of the device-memory check: x * this, mod 2**32
_PATTERN_MUL = 2654435761


@dataclasses.dataclass
class CheckResult:
    name: str
    ok: bool
    value: float
    unit: str
    detail: str = ""


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Validator:
    """``device``: where the device checks run (default the card;
    ``"cpu"`` for the plain path).  ``grid``: the run's
    ``core.grid.Grid``; the allreduce check sums over every rank of it,
    and ``node_healthy`` is then the verdict of every rank (each rank
    calls it, as it calls every collective)."""

    def __init__(self, gemm_n: int = 512, mem_mb: int = 64,
                 storage_mb: int = 32, device=None, grid=None):
        self.gemm_n = gemm_n
        self.mem_mb = mem_mb
        self.storage_mb = storage_mb
        self.device = resolve_device(device)
        self.grid = grid

    # -- individual checks --

    def check_devices(self) -> CheckResult:
        dev = self.device
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        ok = n >= 1
        try:              # dtype support (the FP16-era gate)
            x = torch.zeros((2,), dtype=torch.bfloat16, device=dev) + 1
            ok = ok and x.tolist() == [1.0, 1.0]
        except Exception:
            ok = False
        return CheckResult("devices_and_dtypes", ok, n, "devices")

    def check_cpu_memory_bandwidth(self) -> CheckResult:
        n = self.mem_mb * 1024 * 1024 // 8
        a = np.ones(n, np.float64)
        t0 = now()
        for _ in range(3):
            _ = a * 1.0000001
        dt = now() - t0
        gbps = 3 * 2 * n * 8 / dt / 1e9
        return CheckResult("cpu_mem_bandwidth", gbps > 0.5, gbps, "GB/s")

    def check_device_memory(self) -> CheckResult:
        """A uint32 pattern over a large buffer, made on the device and
        read back (paper: every byte).  torch keeps it as int32 bits."""
        n = self.mem_mb * 1024 * 1024 // 4
        x = torch.arange(n, dtype=torch.int64, device=self.device)
        x = (x * _PATTERN_MUL) & 0xFFFFFFFF
        pat = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
        del x
        back = pat.cpu().numpy().view(np.uint32)
        expect = (np.arange(n, dtype=np.uint64) * _PATTERN_MUL) % (1 << 32)
        ok = bool(np.array_equal(back, expect.astype(np.uint32)))
        return CheckResult("device_memory_pattern", ok, n * 4 / 1e6, "MB")

    def check_gemm(self) -> CheckResult:
        """A full fp32 GEMM on the device against a float64 oracle.  The
        check forces full fp32 precision itself: a TF32 GEMM reads ~1e-3
        and would call a healthy card sick."""
        n, dev = self.gemm_n, self.device
        rng = np.random.default_rng(0)
        a = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal((n, n)).astype(np.float32)
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        prec = torch.get_float32_matmul_precision()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.set_float32_matmul_precision("highest")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.matmul(ta, tb)           # warm-up (library handles)
            _sync(dev)
            t0 = now()
            c = torch.matmul(ta, tb)
            _sync(dev)
            dt = now() - t0
        finally:
            torch.set_float32_matmul_precision(prec)
            torch.backends.cuda.matmul.allow_tf32 = tf32
        c = c.cpu().numpy()
        ref = a.astype(np.float64) @ b.astype(np.float64)
        err = float(np.max(np.abs(c - ref)) / (np.abs(ref).max() + 1e-9))
        gflops = 2 * n ** 3 / dt / 1e9
        return CheckResult("gemm_oracle", err < 1e-4, gflops, "GFLOP/s",
                           f"rel_err={err:.2e}")

    def check_allreduce(self) -> CheckResult:
        """A sum over every rank of the run's grid (the paper's NVLink
        test; host-staged gloo on the card), or one rank without one."""
        ranks = self.grid.ranks if self.grid is not None else 1
        x = torch.ones((1024,), dtype=torch.float32, device=self.device)
        try:
            if self.grid is not None:
                from repro_torch.core.grid import all_reduce
                x = all_reduce(x, self.grid.all)
            ok = bool(torch.all(x == float(ranks)))
        except Exception as e:  # pragma: no cover
            return CheckResult("intra_node_allreduce", False, 0, "",
                               detail=str(e))
        return CheckResult("intra_node_allreduce", ok, ranks, "ranks")

    def check_storage(self, root: str | None = None) -> CheckResult:
        data = os.urandom(self.storage_mb * 1024 * 1024)
        with tempfile.NamedTemporaryFile(dir=root, delete=True) as f:
            t0 = now()
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
            t_w = now() - t0
            f.seek(0)
            t0 = now()
            back = f.read()
            t_r = now() - t0
        ok = back == data and t_w > 0
        mbps = self.storage_mb / max(t_w, 1e-9)
        return CheckResult("storage_bandwidth", ok, mbps, "MB/s write",
                           f"read={self.storage_mb / max(t_r, 1e-9):.0f}MB/s")

    # -- suite --

    def run_all(self, storage_root: str | None = None) -> list[CheckResult]:
        checks = [
            (self.check_devices, ()),
            (self.check_cpu_memory_bandwidth, ()),
            (self.check_device_memory, ()),
            (self.check_gemm, ()),
            (self.check_allreduce, ()),
            (self.check_storage, (storage_root,)),
        ]
        out = []
        for fn, args in checks:
            with span(f"validator.{fn.__name__}"):
                out.append(fn(*args))
        return out

    def node_healthy(self, storage_root: str | None = None) -> bool:
        """Every check passes; under a grid, on every rank (the ranks
        agree on one verdict, so they rescale together)."""
        healthy = all(c.ok for c in self.run_all(storage_root))
        if self.grid is not None and self.grid.ranks > 1:
            from repro_torch.core.grid import all_reduce
            sick = torch.tensor([0.0 if healthy else 1.0],
                                device=self.device)
            healthy = float(all_reduce(sick, self.grid.all)[0]) == 0.0
        return healthy
