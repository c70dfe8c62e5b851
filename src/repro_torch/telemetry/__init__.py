"""Metrics, host-side spans and traces for the PyTorch port.

  * ``registry``: a copy of the JAX package's typed Counter / Gauge /
    Histogram registry (pure Python);
  * ``trace``: nestable host-side ``span``s, Chrome-trace (catapult)
    JSON via ``TraceWriter``, and the structured ``EventLog`` the
    platform's failure taxonomy rides on (port of
    ``repro/telemetry/trace.py``).

``now`` is the port's one clock: every other module of the port reads
time through it.
"""
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            Registry, get_registry)
from repro_torch.telemetry.trace import (EventLog, Span, TraceWriter,
                                         enabled, get_writer,
                                         install_writer, now, set_enabled,
                                         span, uninstall_writer)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry",
    "EventLog", "Span", "TraceWriter", "enabled", "get_writer",
    "install_writer", "now", "set_enabled", "span", "uninstall_writer",
]
