"""The port's spans, Chrome-trace export and event log
(``repro_torch.telemetry.trace``) against the JAX package's
(``tests/test_telemetry.py``): span nesting and exception safety, the
shared null span with a silent writer, the Chrome-trace schema of the
same spans in both packages, the JSONL round trip, the FT runner's one
emit point; checkpoint seconds measured with telemetry disabled; and
``--trace`` on both port launchers on the CPU."""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.telemetry import (EventLog, Registry,  # noqa: E402
                                   TraceWriter, get_writer, install_writer,
                                   set_enabled, span, uninstall_writer)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Spans and writers are process globals: leave them as found."""
    from repro import telemetry as jt
    yield
    uninstall_writer()
    set_enabled(True)
    jt.uninstall_writer()
    jt.set_enabled(True)


def test_span_nesting_and_exception_safety():
    w = TraceWriter()
    install_writer(w)
    with span("outer", step=1):
        with span("inner"):
            pass
    with pytest.raises(ValueError):
        with span("boom"):
            raise ValueError("x")
    names = [e["name"] for e in w.events]
    assert names == ["inner", "outer", "boom"]   # exit order
    inner, outer, boom = w.events
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"step": 1}
    assert boom["args"]["error"] == "ValueError"
    assert Registry.get().histogram("span.outer").count >= 1


def test_disabled_spans_are_shared_null_and_writer_silent():
    w = TraceWriter()
    install_writer(w)
    set_enabled(False)
    s1, s2 = span("a"), span("b", x=1)
    assert s1 is s2                       # one shared null object
    with s1:
        pass
    assert s1.duration_s == 0.0           # no clock read: no measurement
    assert w.events == []
    EventLog().emit("ckpt", step=1)       # the log records, the writer not
    assert w.events == []
    set_enabled(True)
    assert span("a") is not span("a")


def _program(tel, log_cls, tmp_path, name):
    """The same spans and events through one package's telemetry."""
    w = tel.TraceWriter()
    tel.install_writer(w)
    log = log_cls()
    with tel.span("phase.work", k=2):
        with tel.span("phase.inner"):
            log.emit("failure", node=3, cls="sw_xid43")
    with pytest.raises(KeyError):
        with tel.span("phase.boom", step=4):
            raise KeyError("x")
    tel.uninstall_writer()
    return json.loads(pathlib.Path(
        w.write(str(tmp_path / f"{name}.json"))).read_text())


def test_chrome_trace_schema_matches_jax(tmp_path):
    """The same spans through both ``TraceWriter``s give the same
    document bar the times, the pid and the process name: the same
    keys, phases, names, args, categories and thread ids."""
    from repro import telemetry as jt

    from repro_torch import telemetry as tt
    ours = _program(tt, tt.EventLog, tmp_path, "torch")
    theirs = _program(jt, jt.EventLog, tmp_path, "jax")

    def shape(doc):
        evs = []
        for e in doc["traceEvents"]:
            e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
            if e["ph"] == "M":
                e["args"] = sorted(e["args"])
            evs.append(e)
        return sorted(doc), evs
    assert shape(ours) == shape(theirs)
    evs = ours["traceEvents"]
    assert evs[0]["ph"] == "M" and evs[0]["name"] == "process_name"
    xs = [e for e in evs if e["ph"] == "X"]
    inst = [e for e in evs if e["ph"] == "i"]
    assert [e["name"] for e in xs] == ["phase.inner", "phase.work",
                                       "phase.boom"]
    assert len(inst) == 1 and inst[0]["s"] == "t"
    for e in xs:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["dur"] >= 0 and e["ts"] >= 0
    x = xs[1]
    assert x["ts"] <= inst[0]["ts"] <= x["ts"] + x["dur"]


def test_writer_gives_each_thread_its_tid():
    import threading
    w = TraceWriter()
    install_writer(w)
    with span("main"):
        pass
    t = threading.Thread(target=lambda: span("bg").__enter__().__exit__(
        None, None, None))
    t.start()
    t.join()
    assert [(e["name"], e["tid"]) for e in w.events] == [("main", 0),
                                                         ("bg", 1)]


def test_event_log_jsonl_roundtrip(tmp_path):
    log = EventLog()
    r1 = log.emit("ckpt", step=10, blocking=False)
    r2 = log.emit("straggler", step=11, dt=2.0)
    assert r1["kind"] == "ckpt" and r2["t"] >= r1["t"] >= 0
    path = log.write(str(tmp_path / "events.jsonl"))
    lines = pathlib.Path(path).read_text().splitlines()
    assert [json.loads(ln) for ln in lines] == log.events


def test_ftrunner_routes_every_event_through_one_log(tmp_path):
    """``tests/test_telemetry.py:242`` on the port's runner: the report
    holds the very records of the runner's log, the callback sees each
    emit once, the JSONL stream persists them, and a writer gets each as
    an instant event inside the runner's spans."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.platform.failures import EVENT_KINDS, FailureInjector
    from repro_torch.platform.runner import FTRunner

    def make_step(world):
        def step_fn(state, batch):
            return {"x": state["x"] + world}, {"loss": torch.ones(())}
        return step_fn

    w = TraceWriter()
    install_writer(w)
    seen = []
    runner = FTRunner(
        make_step, lambda step: None,
        CheckpointManager(str(tmp_path / "ckpt")),
        {"x": torch.zeros(())},
        world_size=2, min_world=1, ckpt_every=2,
        injector=FailureInjector({3: "uncorrectable"}),
        on_event=lambda kind, kw: seen.append(kind))
    report = runner.run(6)
    assert report.failures == 1 and report.restores == 1
    assert report.rescales == 1
    assert report.events == runner.event_log.events
    assert all(any(r is e for e in runner.event_log.events)
               for r in report.events)
    kinds = [e["kind"] for e in report.events]
    assert set(kinds) <= set(EVENT_KINDS)
    assert {"ckpt", "failure", "restore", "rescale"} <= set(kinds)
    assert seen == kinds
    path = runner.event_log.write(str(tmp_path / "events.jsonl"))
    lines = pathlib.Path(path).read_text().splitlines()
    assert [json.loads(ln)["kind"] for ln in lines] == kinds
    assert [e["name"] for e in w.events if e["ph"] == "i"] == kinds
    names = {e["name"] for e in w.events if e["ph"] == "X"}
    assert {"runner.fetch", "runner.step", "runner.block", "ckpt.save",
            "ckpt.restore", "ckpt.d2h", "ckpt.write"} <= names


@pytest.mark.parametrize("elastic", [False, True])
def test_checkpoint_seconds_measured_with_telemetry_disabled(tmp_path,
                                                             elastic):
    """Spans are observability: with ``set_enabled(False)`` a save and a
    restore still measure their seconds (``telemetry.now``)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.elastic import ElasticCheckpointer
    from repro_torch.parallel import ParallelPlan
    state = {"params": {"w": torch.arange(1 << 16, dtype=torch.float32)},
             "master": {"w": torch.ones(1 << 16)},
             "m": {"w": torch.zeros(1 << 16)},
             "v": {"w": torch.zeros(1 << 16)},
             "step": torch.zeros((), dtype=torch.int32)}
    set_enabled(False)
    mgr = ElasticCheckpointer(str(tmp_path), ParallelPlan()) if elastic \
        else CheckpointManager(str(tmp_path))
    mgr.save(state, 1, blocking=False)
    mgr.wait()
    back, step = mgr.restore_latest(state)
    assert step == 1 and torch.equal(back["params"]["w"],
                                     state["params"]["w"])
    for k in ("d2h", "write", "restore"):
        assert mgr.seconds[k] > 0, (k, mgr.seconds)


def _chrome(path):
    doc = json.loads(pathlib.Path(path).read_text())
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M"
    xs = [e for e in evs if e["ph"] == "X"]
    for e in xs:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["dur"] >= 0
    return {e["name"] for e in xs}


def test_train_launcher_trace_flag_writes_chrome_json(tmp_path):
    from repro_torch.launch import train
    out = tmp_path / "train_trace.json"
    train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
                "--steps", "2", "--batch", "2", "--seq", "16",
                "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
                "--ckpt-async", "--trace", str(out)])
    names = _chrome(out)
    assert "train.step" in names
    assert {"ckpt.d2h", "ckpt.write"} <= names
    assert get_writer() is None               # launcher uninstalls


def test_serve_launcher_trace_flag_writes_chrome_json(tmp_path):
    from repro_torch.launch import serve
    out = tmp_path / "serve_trace.json"
    serve.main(["--arch", "codeqwen1.5-7b", "--smoke", "--device", "cpu",
                "--decode-impl", "paged", "--batch", "2",
                "--prompt-len", "12", "--gen", "4", "--trace", str(out)])
    names = _chrome(out)
    assert {"engine.decode_tick", "engine.prefill_chunk"} <= names
    assert get_writer() is None
