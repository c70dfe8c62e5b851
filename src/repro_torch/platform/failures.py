"""Hardware-failure model calibrated to the paper's production data
(§VII-C, Appendix Tables VI/VII/VIII).

Fire-Flyer 2 observed, over ~1 year on 10,000 GPUs / 1,250 nodes:
  * 12,970 GPU Xid errors, distributed per Table VI (Xid74 NVLink 42.57 %,
    Xid43 illegal-mem 33.48 %, Xid31 19.18 %, ECC ~2.1 %, ...)
  * CPU memory ECC: 54 events / 6 months  (Table VII)
  * IB link flash cuts: 175 events over ~1 year (Table VIII), random in time

The sampler draws Poisson event streams at those rates scaled to any
(n_nodes, hours) window — this is what the fault-tolerance tests and the
availability benchmark inject.

A copy of ``repro/platform/failures.py`` (numpy only): for the same
seed ``FailureModel(seed).sample(n, hours)`` gives the same events.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

PAPER_GPUS = 10_000
PAPER_NODES = 1_250
PAPER_WINDOW_HOURS = 365 * 24.0

# Table VI (counts over the window, whole cluster)
XID_TABLE = {
    "nvlink_xid74": 5521,
    "sw_xid31": 2487,
    "sw_xid43": 4342,
    "sw_xid13_45": 285,
    "gpu_ecc": 277,            # xid 63/64/94/95
    "uncorrectable": 57,       # xid 44/48/61/62/69/79
    "gsp_xid119": 1,
}
XID_TOTAL = sum(XID_TABLE.values())          # 12,970

# Table VII/VIII
CPU_ECC_PER_6MO = 54
IB_FLASH_CUTS_PER_YEAR = 175

# operator action per failure class (paper Table V)
ACTION = {
    "nvlink_xid74": "stress_test_then_reset",
    "sw_xid31": "user_code_check",
    "sw_xid43": "user_code_check_or_memtest",
    "sw_xid13_45": "user_code_check",
    "gpu_ecc": "gpu_reset_row_remap",
    "uncorrectable": "node_reboot",
    "gsp_xid119": "rma",
    "cpu_ecc": "node_reboot",
    "ib_flash_cut": "requeue_link_watch",
}
# classes that take the whole node out (vs transparent/retryable)
FATAL = {"uncorrectable", "gsp_xid119", "cpu_ecc", "ib_flash_cut",
         "nvlink_xid74", "gpu_ecc"}


class FailureKind(str, enum.Enum):
    XID = "xid"
    CPU_ECC = "cpu_ecc"
    IB_FLASH = "ib_flash_cut"


# The one event-stream taxonomy (DESIGN.md §10): every record the
# platform emits through ``repro_torch.telemetry.EventLog`` uses one of
# these ``kind``s, so the Table-6 failure accounting, the FT runner's
# report, and any persisted JSONL log classify identically.
EVENT_KINDS = ("failure", "validator", "restore", "rescale", "straggler",
               "ckpt")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    t_hours: float
    node: int
    cls: str
    action: str
    fatal: bool

    def to_event(self) -> dict:
        """Fields for ``EventLog.emit("failure", **ev.to_event())`` —
        the sampled Poisson stream and the FT runner's injected
        failures land in the same schema."""
        return {"t_hours": self.t_hours, "node": self.node,
                "cls": self.cls, "action": self.action,
                "fatal": self.fatal}


class FailureModel:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._xid_classes = list(XID_TABLE)
        tot = float(XID_TOTAL)
        self._xid_probs = [XID_TABLE[k] / tot for k in self._xid_classes]

    def rates_per_node_hour(self) -> dict:
        return {
            "xid": XID_TOTAL / PAPER_NODES / PAPER_WINDOW_HOURS,
            "cpu_ecc": (CPU_ECC_PER_6MO * 2) / PAPER_NODES
            / PAPER_WINDOW_HOURS,
            "ib_flash_cut": IB_FLASH_CUTS_PER_YEAR / PAPER_NODES
            / PAPER_WINDOW_HOURS,
        }

    def sample(self, n_nodes: int, hours: float) -> list[FailureEvent]:
        """Poisson event stream over (n_nodes, hours)."""
        rates = self.rates_per_node_hour()
        events: list[FailureEvent] = []
        for kind, rate in rates.items():
            lam = rate * n_nodes * hours
            n = int(self.rng.poisson(lam))
            for _ in range(n):
                t = float(self.rng.uniform(0, hours))
                node = int(self.rng.integers(0, n_nodes))
                if kind == "xid":
                    cls = str(self.rng.choice(self._xid_classes,
                                              p=self._xid_probs))
                else:
                    cls = kind
                events.append(FailureEvent(
                    t, node, cls, ACTION[cls], cls in FATAL))
        events.sort(key=lambda e: e.t_hours)
        return events

    def mtbf_node_hours(self) -> float:
        total_rate = sum(self.rates_per_node_hour().values())
        return 1.0 / total_rate

    def cluster_mtbf_hours(self, n_nodes: int) -> float:
        """Mean time between *any* failure on an n-node job — the number
        that makes 5-minute checkpoints necessary at scale (paper §VII-A)."""
        return self.mtbf_node_hours() / max(n_nodes, 1)


class FailureInjector:
    """Deterministic injection for tests/benchmarks: raise at given steps."""

    def __init__(self, fail_steps: dict[int, str]):
        self.fail_steps = dict(fail_steps)
        self.raised: list[tuple[int, str]] = []

    def check(self, step: int):
        cls = self.fail_steps.pop(step, None)
        if cls is not None:
            self.raised.append((step, cls))
            raise SimulatedHardwareFailure(cls, step)


class SimulatedHardwareFailure(RuntimeError):
    def __init__(self, cls: str, step: int):
        super().__init__(f"simulated {cls} at step {step}")
        self.cls = cls
        self.step = step
        self.action = ACTION.get(cls, "node_reboot")
        self.fatal = cls in FATAL
