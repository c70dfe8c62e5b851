"""Host-side spans, Chrome-trace export and the structured event log
(port of ``repro/telemetry/trace.py``).

``span("name", **attrs)`` wraps a host-side region: a prefill chunk, a
decode tick, a train step, a checkpoint write.  On the card a span
times dispatch to dispatch unless the region synchronises.

Three sinks, all optional:

  * the ``"default"`` registry gets a ``span.<name>`` latency histogram
    per span name (always on while telemetry is enabled);
  * an installed :class:`TraceWriter` also records a Chrome
    trace-event-format "X" (complete) event per span; ``write(path)``
    emits JSON that loads in ``chrome://tracing`` / Perfetto;
  * :class:`EventLog` carries the *discrete* event stream (failure /
    validator / restore / rescale / straggler / ckpt, the paper's
    Table-6 taxonomy) as JSONL and mirrors each record into the
    TraceWriter as an instant event.

``set_enabled(False)`` (or env ``REPRO_TELEMETRY=0``) swaps ``span``
for a shared no-op object: no clock reads, no allocation beyond the
call itself, and a ``duration_s`` of 0.  Code that needs a
*measurement* (checkpoint seconds, validator bandwidth, straggler
detection) therefore reads :func:`now` directly rather than a span's
duration: spans are observability, not control flow.

``now`` is the port's one clock (``perf_counter``); this package is the
one place of the port that reads the time.
"""
from __future__ import annotations

import json
import os
import threading
from time import perf_counter as now

from repro_torch.telemetry.registry import get_registry

_enabled = os.environ.get("REPRO_TELEMETRY", "1") != "0"
_writer: "TraceWriter | None" = None


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def install_writer(writer: "TraceWriter") -> None:
    global _writer
    _writer = writer


def uninstall_writer() -> None:
    global _writer
    _writer = None


def get_writer() -> "TraceWriter | None":
    return _writer


class Span:
    """One timed host-side region; re-entrant via nesting, not reuse."""

    __slots__ = ("name", "attrs", "t0", "duration_s")

    def __init__(self, name: str, attrs: dict | None = None):
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.duration_s = 0.0

    def __enter__(self) -> "Span":
        self.t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = now()
        self.duration_s = t1 - self.t0
        get_registry().histogram(f"span.{self.name}").record(self.duration_s)
        w = _writer
        if w is not None:
            w.add_complete(self.name, self.t0, t1, self.attrs,
                           error=exc_type.__name__ if exc_type else None)
        return None          # never swallow the exception


class _NullSpan:
    """Shared no-op span when telemetry is disabled: no clock reads."""

    __slots__ = ()
    name = ""
    attrs = None
    t0 = 0.0
    duration_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """``with span("engine.decode_tick", active=4): ...``"""
    if not _enabled:
        return _NULL_SPAN
    return Span(name, attrs or None)


class TraceWriter:
    """Chrome trace-event-format (catapult) collector.

    Events use the JSON-object form ``{"traceEvents": [...]}`` with
    microsecond ``ts``/``dur`` relative to the writer's construction.
    Spans land as ``ph: "X"`` (complete) events; :class:`EventLog`
    records as ``ph: "i"`` (instant, thread scope).  Thread identity
    maps to small stable ``tid`` ints in first-seen order (the
    checkpoint writer's background thread gets its own).
    """

    def __init__(self, process_name: str = "repro_torch"):
        self.process_name = process_name
        self.events: list[dict] = []
        self._pid = os.getpid()
        self._tids: dict[int, int] = {}
        self._lock = threading.Lock()
        self._t0 = now()

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            t = self._tids.get(ident)
            if t is None:
                t = self._tids[ident] = len(self._tids)
        return t

    def _ts(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def add_complete(self, name: str, t0: float, t1: float,
                     attrs: dict | None = None, error: str | None = None):
        ev = {"name": name, "ph": "X", "ts": self._ts(t0),
              "dur": (t1 - t0) * 1e6, "pid": self._pid, "tid": self._tid(),
              "cat": "span"}
        if attrs or error:
            ev["args"] = dict(attrs or {})
            if error:
                ev["args"]["error"] = error
        with self._lock:
            self.events.append(ev)

    def add_instant(self, name: str, attrs: dict | None = None):
        ev = {"name": name, "ph": "i", "ts": self._ts(now()), "s": "t",
              "pid": self._pid, "tid": self._tid(), "cat": "event"}
        if attrs:
            ev["args"] = dict(attrs)
        with self._lock:
            self.events.append(ev)

    def to_json(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": self.process_name}}]
        with self._lock:
            return {"traceEvents": meta + list(self.events),
                    "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, default=str)
        return path


class EventLog:
    """Structured discrete-event stream (JSONL on disk).

    One ``emit`` per platform event (failure, validator, restore,
    rescale, straggler, ckpt), so the FT runner's report, its
    ``on_event`` callback and the persisted log all read the *same*
    record.  Records carry ``t`` (seconds since the log's creation)
    plus the caller's fields; ``kind`` is the taxonomy key (paper
    Table 6).
    """

    def __init__(self):
        self.events: list[dict] = []
        self._t0 = now()
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": now() - self._t0, **fields}
        with self._lock:
            self.events.append(rec)
        if _enabled:
            w = _writer
            if w is not None:
                w.add_instant(kind, fields)
        return rec

    def write(self, path: str) -> str:
        with self._lock:
            lines = [json.dumps(e, default=str) for e in self.events]
        with open(path, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        return path
