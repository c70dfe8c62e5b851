"""Typed metrics: Counter / Gauge / Histogram in a named Registry.

The registry is the one sanctioned home for operational counters and
latency distributions (DESIGN.md §10).  It replaces the ad-hoc module
globals that used to hold this state (``CHUNK_SCORE_TRACES`` in
``models/attention.py``, the engine's ``prefill_traces`` /
``decode_traces`` ints) with objects that survive a ``reset()`` — a
reset zeroes *values* in place, so references handed out before the
reset keep working (test isolation without re-plumbing).

Naming scheme: dotted lowercase ``subsystem.metric`` with an ``_s`` /
``_bytes`` unit suffix where one applies (``engine.ttft_s``,
``train.step_s``, ``attention.chunk_score_traces``).

``Histogram`` keeps **exact** samples up to ``max_samples`` (so
``percentile(q)`` matches ``np.percentile`` bit-for-bit on the retained
window) *and* fixed log-spaced bucket counts that never saturate; past
the sample cap, percentiles fall back to bucket interpolation — bounded
relative error of one bucket ratio (default 2**0.25 ≈ 19 %) instead of
unbounded memory.  Host-side latencies arrive at most a few per engine
step, so the exact window covers every realistic test and bench run.

Everything here is dependency-free host-side Python: recording a value
is an int add / list append — no jax, no arrays, nothing that could
change what a jitted function traces.
"""
from __future__ import annotations

import bisect
import math
import threading


class Counter:
    """Monotone event count (``inc``); resets to 0."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        self._value = 0

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (``set``)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def snapshot(self):
        return self._value


class Histogram:
    """Latency/size distribution with exact percentiles up to a cap.

    Log buckets: boundary ``i`` is ``lo * growth**i`` — fixed at
    construction, covering (lo, hi); values outside clamp into the end
    buckets.  ``record`` is O(1) (append + bisect into ~160 boundaries).
    """

    __slots__ = ("name", "max_samples", "_samples", "_bounds", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, *, lo: float = 1e-7, hi: float = 1e4,
                 growth: float = 2 ** 0.25, max_samples: int = 65536):
        self.name = name
        self.max_samples = max_samples
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self._bounds = [lo * growth ** i for i in range(n + 1)]
        self._counts = [0] * (n + 2)      # + underflow / overflow
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if len(self._samples) < self.max_samples:
            self._samples.append(v)
        self._counts[bisect.bisect_right(self._bounds, v)] += 1

    # ------------------------------ stats ------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Exact (numpy 'linear' interpolation over retained samples)
        while under ``max_samples``; log-bucket interpolation beyond."""
        if not self._count:
            return 0.0
        if self._count <= len(self._samples):
            s = sorted(self._samples)
            rank = (q / 100.0) * (len(s) - 1)
            flo = int(math.floor(rank))
            fhi = min(flo + 1, len(s) - 1)
            return s[flo] + (s[fhi] - s[flo]) * (rank - flo)
        # bucket fallback: walk the CDF to the target rank
        target = (q / 100.0) * self._count
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= target:
                if i == 0:
                    return self._min
                if i > len(self._bounds) - 1:
                    return self._max
                return math.sqrt(self._bounds[i - 1] * self._bounds[i])
        return self._max

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        return {f"p{q:g}": self.percentile(q) for q in qs}

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's retained samples into this one —
        how the serving cluster aggregates per-replica latency
        distributions into one cluster-level view.  Exact while every
        source is inside its sample window (65 536 values — true for
        any realistic serve/bench run); a source past its window
        contributes only its retained samples."""
        for v in other._samples:
            self.record(v)

    def reset(self) -> None:
        self._samples.clear()
        self._counts = [0] * len(self._counts)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def snapshot(self):
        if not self._count:
            return {"count": 0}
        return {"count": self._count, "sum": self._sum, "mean": self.mean,
                "min": self._min, "max": self._max, **self.percentiles()}


class Registry:
    """A namespace of typed metrics.

    ``Registry(name)`` is a standalone instance (what per-engine metrics
    use — each ``ServingEngine`` owns its own, so concurrent engines
    never share counters); ``Registry.get(name)`` is the named-singleton
    entry (the process-wide ``"default"`` registry that spans and module
    counters record into).
    """

    _instances: dict[str, "Registry"] = {}
    _instances_lock = threading.Lock()

    def __init__(self, name: str = "default"):
        self.name = name
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    @classmethod
    def get(cls, name: str = "default") -> "Registry":
        with cls._instances_lock:
            if name not in cls._instances:
                cls._instances[name] = cls(name)
            return cls._instances[name]

    @classmethod
    def reset_all(cls) -> None:
        with cls._instances_lock:
            for reg in cls._instances.values():
                reg.reset()

    def _get_or_create(self, name: str, typ, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = typ(name, **kw)
            elif not isinstance(m, typ):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"not {typ.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get_or_create(name, Histogram, **kw)

    def snapshot(self) -> dict:
        """{metric name: value | distribution-summary dict}."""
        with self._lock:
            return {n: m.snapshot() for n, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        """Zero every metric *in place* (held references stay live)."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()


def get_registry(name: str = "default") -> Registry:
    return Registry.get(name)
