"""Metrics and host-side spans for the PyTorch port.

``registry`` is a copy of the JAX package's typed Counter / Gauge /
Histogram registry (pure Python).  ``span`` times a host-side region
into a ``span.<name>`` histogram of the default registry.

``now`` is the port's one clock: every other module of the port reads
time through it.
"""
from time import perf_counter as now

from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            Registry, get_registry)


class Span:
    """One timed host-side region; records its duration on exit."""

    __slots__ = ("name", "t0", "duration_s")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0
        self.duration_s = 0.0

    def __enter__(self) -> "Span":
        self.t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration_s = now() - self.t0
        get_registry().histogram(f"span.{self.name}").record(self.duration_s)
        return None


def span(name: str) -> Span:
    """``with span("engine.decode_tick"): ...`` — host wall time of the
    region (dispatch time on the card unless the region synchronizes)."""
    return Span(name)


__all__ = ["Counter", "Gauge", "Histogram", "Registry", "Span",
           "get_registry", "now", "span"]
