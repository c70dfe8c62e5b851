"""The port's HAI-Platform (``repro_torch.platform``) against the JAX
package's on the CPU: the scheduler's scenarios of
``tests/test_platform.py`` run through both ``Scheduler``s, the failure
model's samples for seeds 0 and 1, the validator at small sizes (with a
sick GEMM), both ``FTRunner``s on one deterministic toy step with the
same injector and validator stub (counters and event sequences field by
field, times left out), the phi4-mini smoke model interrupted and
resumed under the port's runner.  Both elastic legs across 4 gloo ranks
(``check_elastic_kill_resume``, ``check_elastic_cross_plan``) run in
``tests/test_torch_elastic.py``'s spawn."""
import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.platform import scheduler as ported_sched  # noqa: E402

# ------------------------------ scheduler ----------------------------------


def _snapshot(s):
    """What a scenario leaves behind: placements, states, utilisation."""
    def task(t):
        return {k: getattr(t, k) for k in (
            "task_id", "n_nodes", "priority", "nodes", "state",
            "interruptions", "cross_zone", "remaining_hours")}
    return {"running": {i: task(t) for i, t in sorted(s.running.items())},
            "queued": [task(t) for _, _, t in sorted(
                s._queue, key=lambda e: (e[0], e[1]))],
            "done": [task(t) for t in s.done],
            "nodes": dict(s.cluster.nodes), "time": s.time,
            "utilization": s.utilization()}


def _single_zone(m):
    s = m.Scheduler(m.Cluster(n_nodes=8, zones=2))
    s.submit(m.Task(1, n_nodes=4, priority=1, runtime_hours=1))
    s.schedule()
    return s


def _one_cross_zone(m):
    s = m.Scheduler(m.Cluster(n_nodes=8, zones=2))
    s.submit(m.Task(1, n_nodes=6, priority=1, runtime_hours=2))
    s.submit(m.Task(2, n_nodes=2, priority=1, runtime_hours=2))
    s.schedule()
    s.submit(m.Task(3, n_nodes=2, priority=1, runtime_hours=1,
                    zone_pref=None))
    s.schedule()
    return s


def _preemption(m):
    s = m.Scheduler(m.Cluster(n_nodes=4, zones=2))
    s.submit(m.Task(1, n_nodes=4, priority=0, runtime_hours=10))
    s.schedule()
    s.submit(m.Task(2, n_nodes=4, priority=9, runtime_hours=1))
    s.schedule()
    return s


def _node_failure(m):
    s = m.Scheduler(m.Cluster(n_nodes=6, zones=2))
    s.submit(m.Task(1, n_nodes=2, priority=1, runtime_hours=4))
    s.schedule()
    s.node_failure(s.running[1].nodes[0])
    s.schedule()
    return s


def _utilization(m):
    s = m.Scheduler(m.Cluster(n_nodes=4, zones=2))
    s.submit(m.Task(1, n_nodes=4, priority=1, runtime_hours=2))
    s.advance(1.0)
    s.advance(1.0)
    return s


SCENARIOS = {"single_zone": _single_zone, "one_cross_zone": _one_cross_zone,
             "preemption": _preemption, "node_failure": _node_failure,
             "utilization": _utilization}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_scenarios_match_jax(name):
    """Each scenario of ``tests/test_platform.py:16-62`` through the JAX
    and the port's ``Scheduler``: the same placements, states, queue
    and utilisation, and the JAX test's own assertions hold on the
    port's."""
    from repro.platform import scheduler as jax_sched
    ours = SCENARIOS[name](ported_sched)
    assert _snapshot(ours) == _snapshot(SCENARIOS[name](jax_sched))
    if name == "single_zone":
        t = ours.running[1]
        assert len({ours.cluster.nodes[n]["zone"] for n in t.nodes}) == 1
        assert not t.cross_zone
    elif name == "one_cross_zone":
        assert ours.running[1].cross_zone
        assert sum(t.cross_zone for t in ours.running.values()) == 1
    elif name == "preemption":
        assert 2 in ours.running and 1 not in ours.running
        assert next(t for _, _, t in ours._queue
                    if t.task_id == 1).interruptions == 1
    elif name == "node_failure":
        assert 1 in ours.running
        failed = [n for n, v in ours.cluster.nodes.items()
                  if not v["healthy"]]
        assert failed and failed[0] not in ours.running[1].nodes
    else:
        assert ours.utilization() == pytest.approx(1.0)


def test_slo_router_matches_jax():
    from repro.platform import scheduler as jax_sched
    stats = [{"queue_depth": q, "active_slots": a, "ttft_p95": t,
              "tpot_p95": p} for q, a, t, p in
             [(0, 0, 0.0, 0.0), (2, 1, 2.5, 0.1), (0, 0, 0.0, 0.0),
              (1, 3, 0.4, 0.5)]]
    picks = []
    for m in (jax_sched, ported_sched):
        r = m.SLORouter(m.ServingSLO(ttft_ms=500, tpot_ms=200))
        picks.append([r.pick_prefill(stats) for _ in range(4)]
                     + [r.pick_decode(stats) for _ in range(4)]
                     + [m.slo_score(3, 2, 0.9, 0.3)])
    assert picks[0] == picks[1]


# ----------------------------- failure model -------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_failure_model_samples_equal_jax(seed):
    """The same Poisson streams, rates and MTBF as the JAX model; the
    drills' classes (the first fatal / non-fatal event of
    ``sample(1250, 48.0)``) come out the same."""
    from repro.platform import failures as jf

    from repro_torch.platform import failures as tf
    a, b = jf.FailureModel(seed), tf.FailureModel(seed)
    assert a.rates_per_node_hour() == b.rates_per_node_hour()
    assert a.mtbf_node_hours() == b.mtbf_node_hours()
    assert a.cluster_mtbf_hours(1250) == b.cluster_mtbf_hours(1250)
    for n, hours in ((1250, 48.0), (1250, 24 * 30), (16, 1000.0)):
        ea, eb = a.sample(n, hours), b.sample(n, hours)
        assert [e.to_event() for e in ea] == [e.to_event() for e in eb]
    assert tf.EVENT_KINDS == jf.EVENT_KINDS
    assert tf.ACTION == jf.ACTION and tf.FATAL == jf.FATAL
    r = tf.FailureModel(0).rates_per_node_hour()
    assert r["xid"] == pytest.approx(12970 / 1250 / 8760, rel=1e-6)
    assert tf.FailureModel(0).cluster_mtbf_hours(1250) < 2.0
    for fatal in (True, False):
        pick = [next(e.cls for e in m.FailureModel(seed).sample(1250, 48.0)
                     if e.fatal == fatal) for m in (jf, tf)]
        assert pick[0] == pick[1]


# ------------------------------ validator ----------------------------------


def test_validator_suite_passes_and_a_sick_gemm_fails(tmp_path):
    from repro_torch.platform import Validator
    from repro_torch.platform.validator import CheckResult
    prec = torch.get_float32_matmul_precision()
    v = Validator(gemm_n=96, mem_mb=4, storage_mb=2, device="cpu")
    results = v.run_all(str(tmp_path))
    assert [c.name for c in results] == [
        "devices_and_dtypes", "cpu_mem_bandwidth", "device_memory_pattern",
        "gemm_oracle", "intra_node_allreduce", "storage_bandwidth"]
    assert not [c.name for c in results if not c.ok]
    assert torch.get_float32_matmul_precision() == prec
    assert v.node_healthy(str(tmp_path))
    sick = Validator(gemm_n=64, mem_mb=2, storage_mb=1, device="cpu")
    sick.check_gemm = lambda: CheckResult("gemm_oracle", False, 0.0, "")
    assert not sick.node_healthy(str(tmp_path))


def test_validator_defaults_to_the_card(monkeypatch):
    from repro_torch.platform import Validator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Validator()


# ------------------------------ FT runner ----------------------------------


class _Stub:
    """The validator stub both runners get: a fixed verdict."""

    def __init__(self, healthy):
        self.healthy = healthy

    def node_healthy(self):
        return self.healthy


def _toy(pkg, slow_at=None):
    """(make_step, state) of a deterministic toy step for the JAX
    package (numpy) or the port (torch): x += world; the loss is x's
    mean.  ``slow_at``: every step takes 30 ms and that one 0.6 s (a
    straggler: host noise stays far inside the factor)."""
    import time

    def make_step(world):
        def step_fn(state, batch):
            if slow_at is not None:
                time.sleep(0.6 if batch == slow_at else 0.03)
            x = state["x"] + world
            return {"x": x}, {"loss": x.mean()}
        return step_fn
    if pkg == "jax":
        return make_step, {"x": np.arange(4, dtype=np.float32)}
    return make_step, {"x": torch.arange(4, dtype=torch.float32)}


RUNS = {
    # tests/test_platform.py:130-210 and tests/test_telemetry.py:242
    "recover_and_rescale": dict(world_size=4, min_world=2, ckpt_every=5,
                                fail={6: "uncorrectable",
                                      11: "nvlink_xid74"}, steps=15),
    "resume_after_cpu_ecc": dict(world_size=2, min_world=2, ckpt_every=5,
                                 fail={7: "cpu_ecc"}, steps=10),
    "validator_gates_rescale": dict(world_size=4, min_world=2, ckpt_every=5,
                                    fail={6: "sw_xid31"}, steps=10,
                                    healthy=False),
    "validator_keeps_world": dict(world_size=4, min_world=2, ckpt_every=5,
                                  fail={6: "sw_xid31"}, steps=10,
                                  healthy=True),
    "one_log": dict(world_size=2, min_world=1, ckpt_every=2,
                    fail={3: "uncorrectable"}, steps=6),
    "straggler": dict(world_size=2, min_world=1, ckpt_every=4, fail={},
                      steps=10, slow_at=7),
}


def _run(pkg, spec, root):
    if pkg == "jax":
        from repro.ckpt import CheckpointManager
        from repro.platform import FailureInjector, FTRunner
    else:
        from repro_torch.ckpt import CheckpointManager
        from repro_torch.platform import FailureInjector, FTRunner
    make_step, state = _toy(pkg, spec.get("slow_at"))
    seen = []
    runner = FTRunner(
        make_step, lambda step: step, CheckpointManager(str(root)), state,
        world_size=spec["world_size"], min_world=spec["min_world"],
        ckpt_every=spec["ckpt_every"],
        injector=FailureInjector(dict(spec["fail"])),
        validator=_Stub(spec["healthy"]) if "healthy" in spec else None,
        straggler_factor=4.0 if "slow_at" in spec else 1e9,
        on_event=lambda kind, kw: seen.append(kind))
    report = runner.run(spec["steps"])
    return runner, report, seen


def _fields(report):
    counters = {k: getattr(report, k) for k in (
        "steps_done", "failures", "restores", "rescales", "stragglers",
        "lost_steps")}
    times = {"t", "dt", "median"}
    events = [{k: v for k, v in e.items() if k not in times}
              for e in report.events]
    return counters, len(report.step_times), events


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ft_runner_matches_jax(name, tmp_path):
    """Both runners on the same toy step, injector and validator stub:
    the same counters, step count and events (field by field, times
    left out); the port's final state equals the JAX one's, every event
    reaches its log, the callback and the JSONL stream once."""
    import json
    spec = RUNS[name]
    j_runner, j_report, _ = _run("jax", spec, tmp_path / "jax")
    runner, report, seen = _run("torch", spec, tmp_path / "torch")
    assert _fields(report) == _fields(j_report)
    np.testing.assert_array_equal(runner.state["x"].numpy(),
                                  np.asarray(j_runner.state["x"]))
    assert report.events == runner.event_log.events
    assert all(any(r is e for e in runner.event_log.events)
               for r in report.events)
    kinds = [e["kind"] for e in report.events]
    assert seen == kinds
    path = runner.event_log.write(str(tmp_path / "events.jsonl"))
    with open(path) as f:
        assert [json.loads(ln)["kind"] for ln in f] == kinds
    if name == "recover_and_rescale":
        assert (report.failures, report.restores, report.rescales) == \
            (2, 2, 2)
        assert report.lost_steps <= 2 * 5
    if name == "validator_gates_rescale":
        assert kinds.index("validator") < kinds.index("restore") < \
            kinds.index("rescale")
        assert [e["healthy"] for e in report.events
                if e["kind"] == "validator"] == [False]
    if name == "straggler":
        assert report.stragglers == 1


def test_ft_runner_resume_determinism_phi4(tmp_path):
    """The phi4-mini smoke model (2 layers, fp32) interrupted by a
    ``cpu_ecc`` at step 7 and resumed from its step-5 checkpoint under
    the port's runner ends where an unbroken run does, bitwise
    (``tests/test_platform.py:test_ft_runner_resume_determinism``)."""
    from repro_torch.ckpt import CheckpointManager, named_leaves
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamW
    from repro_torch.parallel import ParallelPlan, make_train_step
    from repro_torch.platform import FailureInjector, FTRunner
    cfg = dc.replace(smoke_config("phi4-mini-3.8b"), n_layers=2,
                     compute_dtype="float32")
    model = build_model(cfg)
    opt = AdamW(lr=1e-3, param_dtype="float32")
    params = model.init(0, device="cpu")
    plan = ParallelPlan(remat="none")
    step = make_train_step(plan, model, opt, device="cpu")

    def fetch(i):
        return batch_for_model(cfg, "train", i, 2, 32)

    def run(root, injector):
        r = FTRunner(lambda world: step, fetch, CheckpointManager(str(root)),
                     opt.init(tree_map(torch.clone, params)),
                     world_size=2, min_world=2, ckpt_every=5,
                     injector=injector)
        return r, r.run(10)

    a, ra = run(tmp_path / "a", None)
    b, rb = run(tmp_path / "b", FailureInjector({7: "cpu_ecc"}))
    assert (ra.failures, rb.failures, rb.restores, rb.lost_steps) == \
        (0, 1, 1, 2)
    assert rb.steps_done == ra.steps_done + 2
    la, lb = named_leaves(a.state), named_leaves(b.state)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), name
