"""The port's plan-stamped checkpoints (``repro_torch.elastic``): the
single-device tests of the JAX package's ``tests/test_elastic.py``
repeated on tensors, JAX-written checkpoints (tree and ``zero1_flat``)
restored bitwise in the port and the port's in JAX with identical
files and ``plan.json``, and one gloo spawn of 4 ranks that saves,
resumes and reshards ZeRO-1 state bitwise on 2 pods x 2 ranks and runs
both elastic legs of the JAX ``testing/multidev.py`` checks
(``check_elastic_kill_resume``, ``check_elastic_cross_plan``) under the
port's ``FTRunner``, with the drill's planted faults."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import named_leaves  # noqa: E402
from repro_torch.elastic import (ElasticCheckpointer,  # noqa: E402
                                 PlanMismatchError, canonical_state,
                                 master_layout, plan_from_dict, plan_to_dict,
                                 plans_equal, reshard, save_sharded)
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.parallel import ParallelPlan, init_state  # noqa: E402

ZERO1 = ParallelPlan(mode="ddp", zero1=True, overlap=False)


@pytest.fixture(scope="module")
def grid1():
    """A one-rank gloo world and its 1 x 1 grid (ZeRO-1 on one device)."""
    import torch.distributed as dist

    from repro_torch.core.grid import Grid, free_port
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        yield Grid(1, 1)
    finally:
        dist.destroy_process_group()


def _params():
    return {"emb": torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7.0,
            "blk": {"w": torch.ones(5) * 0.3,
                    "b": torch.arange(7, dtype=torch.float32) - 3.0}}


def _same(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def _flat(tree):
    return torch.cat([x.reshape(-1).float() for _, x in named_leaves(tree)])


# ---------------------- manifest (single device) ----------------------


def test_plan_manifest_roundtrip():
    for plan in (ParallelPlan(), ZERO1,
                 ParallelPlan(mode="pp", pp_schedule="gpipe",
                              pp_microbatches=8, compress="int8")):
        d = plan_to_dict(plan)
        json.loads(json.dumps(d))          # JSON-serializable
        assert plan_from_dict(d) == plan
        assert plans_equal(plan, d)
    assert not plans_equal(ParallelPlan(), plan_to_dict(ZERO1))


def test_master_layout_offsets_cover_flat():
    params = _params()
    lay = master_layout(params)
    sizes = {p: e - s for p, (s, e) in lay["offsets"].items()}
    assert sum(sizes.values()) == lay["total"] == sum(
        x.numel() for _, x in named_leaves(params))
    ends = sorted(e for _, e in lay["offsets"].values())
    starts = sorted(s for s, _ in lay["offsets"].values())
    assert starts[0] == 0 and ends[-1] == lay["total"]
    assert starts[1:] == ends[:-1]
    covered = sorted(tuple(s) for s in lay["bucket_slices"])
    assert covered[0][0] == 0 and covered[-1][1] == lay["total"]
    # offsets run in the sorted-key order the flat masters use
    assert list(lay["offsets"]) == ["blk/b", "blk/w", "emb"]


def test_sharded_roundtrip_and_plan_stamp(tmp_path):
    opt = AdamW(lr=1e-2, param_dtype="float32")
    plan = ParallelPlan(mode="gspmd")
    state = opt.init(_params())
    mgr = save_sharded(state, plan, step=4, root_or_backend=str(tmp_path))
    man = mgr.load_manifest(4)
    assert man["layout"] == "tree" and man["step"] == 4
    assert plans_equal(plan, man["plan"])
    assert man["mesh"] == {"axes": ["data", "model"], "shape": [1, 1]}
    restored, step = mgr.restore_latest(state)
    assert step == 4 and _same(restored, state)


def test_cross_plan_restore_requires_opt_in(tmp_path, grid1):
    params = _params()
    opt = AdamW(lr=1e-2, param_dtype="float32")
    state = opt.init(params)
    save_sharded(state, ParallelPlan(mode="gspmd"), step=1,
                 root_or_backend=str(tmp_path))
    other = ElasticCheckpointer(str(tmp_path), ZERO1, grid1)
    with pytest.raises(PlanMismatchError):
        other.restore_latest(state)
    # the explicit cross-plan door still opens
    restored, step = other.restore_for(other.plan, grid1, params)
    assert step == 1
    total = sum(x.numel() for _, x in named_leaves(params))
    assert torch.equal(restored["master"][:total], _flat(state["master"]))


def test_reshard_tree_to_zero1_and_back(tmp_path, grid1):
    params = _params()
    opt = AdamW(lr=1e-2, param_dtype="float32")
    plan_t = ParallelPlan(mode="gspmd")
    state = opt.init(params)
    # give the moments non-trivial values so the remap is visible
    state["m"] = {k: (v * 0.5 + 1.0 if torch.is_tensor(v) else
                      {kk: vv * 0.5 + 1.0 for kk, vv in v.items()})
                  for k, v in state["master"].items()}
    mgr = save_sharded(state, plan_t, step=2, root_or_backend=str(tmp_path))
    z, _ = reshard(mgr, ZERO1, grid1, params, step=2)
    assert z["master"].ndim == 1
    # write the zero1 state back out and reshard to a tree again
    mgr2 = ElasticCheckpointer(str(tmp_path / "z"), ZERO1, grid1)
    mgr2.save(z, 3, blocking=True)
    assert mgr2.load_manifest(3)["layout"] == "zero1_flat"
    t, _ = reshard(mgr2, plan_t, None, params, step=3)
    for k in ("master", "m", "v", "params"):
        assert _same(t[k], state[k]), k
    assert int(t["step"]) == int(state["step"])


def test_canonical_state_async_save(tmp_path, grid1):
    """Async sharded save lands the same canonical bytes as blocking."""
    opt = AdamW(lr=1e-2, param_dtype="float32")
    state = init_state(ZERO1, opt, _params(), grid1)
    mgr_a = ElasticCheckpointer(str(tmp_path / "a"), ZERO1, grid1)
    mgr_a.save(state, 7, blocking=False)
    mgr_a.wait()
    mgr_b = ElasticCheckpointer(str(tmp_path / "b"), ZERO1, grid1)
    mgr_b.save(state, 7, blocking=True)
    ca, cb = canonical_state(mgr_a, 7), canonical_state(mgr_b, 7)
    for k in ("master", "m", "v"):
        assert torch.equal(ca["flats"][k], cb["flats"][k])
    # "step" is the optimizer counter in the state (fresh -> 0); the
    # checkpoint step lives in the manifest
    assert ca["step"] == cb["step"] == 0
    assert ca["manifest"]["step"] == cb["manifest"]["step"] == 7


def test_elastic_keeps_manager_gc(tmp_path):
    opt = AdamW(lr=1e-2, param_dtype="float32")
    state = opt.init(_params())
    mgr = ElasticCheckpointer(str(tmp_path), ParallelPlan(), keep=2)
    for s in (1, 2, 3):
        mgr.save(state, s, blocking=True)
    assert sorted(mgr.backend.list_steps()) == [2, 3]
    assert mgr.backend.exists("step_3/plan.json")
    assert not mgr.backend.exists("step_1/index.json")


def test_zero1_restore_refuses_a_missing_shard(tmp_path, grid1):
    opt = AdamW(lr=1e-2, param_dtype="float32")
    state = init_state(ZERO1, opt, _params(), grid1)
    mgr = save_sharded(state, ZERO1, grid1, step=1,
                       root_or_backend=str(tmp_path))
    man = mgr.load_manifest(1)
    man["flat"]["m"]["shards"] = []
    mgr.backend.write("step_1/plan.json", json.dumps(man).encode())
    with pytest.raises(ValueError, match="missing shard"):
        mgr.restore(1, state)


# ------------------------------ against JAX -------------------------------


def _jax_states():
    """(JAX tree state, JAX zero1 state on a one-device mesh, the two
    meshes): bf16 working params, fp32 masters, moments with values."""
    import jax
    import jax.numpy as jnp

    from repro.optim import AdamW as JaxAdamW
    from repro.parallel.plan import ParallelPlan as JaxPlan
    from repro.parallel.plan import init_state as jinit
    rng = np.random.default_rng(3)
    params = {"emb": jnp.asarray(rng.standard_normal((6, 4), np.float32)),
              "layers": {"w": jnp.asarray(rng.standard_normal((2, 4, 3),
                                                              np.float32)),
                         "b": jnp.asarray(rng.standard_normal(5, np.float32))}}
    opt = JaxAdamW(lr=1e-2, param_dtype="bfloat16")
    tree = opt.init(params)
    tree = {**tree, "m": jax.tree_util.tree_map(lambda x: x * 0.5 + 1.0,
                                                tree["master"]),
            "v": jax.tree_util.tree_map(lambda x: x * x, tree["master"]),
            "step": jnp.asarray(3, jnp.int32)}
    zmesh = jax.make_mesh((1, 1), ("pod", "data"))
    z = jinit(JaxPlan(mode="ddp", zero1=True, overlap=False), opt, params,
              zmesh)
    z = {**z, "m": z["master"] * 0.25 - 1.0, "v": z["master"] ** 2 + 0.5,
         "step": jnp.asarray(5, jnp.int32)}
    return tree, z, jax.make_mesh((1, 1), ("data", "model")), zmesh


def _port(tree):
    import jax

    from repro_torch.bridge import tensor_from_numpy
    return jax.tree_util.tree_map(
        lambda x: tensor_from_numpy(np.asarray(jax.device_get(x))), tree)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _bitwise_jax(jtree, ttree):
    import jax

    from repro_torch.bridge import tensor_to_numpy
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [x for _, x in named_leaves(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), tensor_to_numpy(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("layout", ["tree", "zero1_flat"])
def test_checkpoints_cross_between_jax_and_port(tmp_path, grid1, layout):
    """The same state saved by JAX's ``save_sharded`` and the port's
    gives the same files (chunks, ``index.json``, ``plan.json`` field by
    field); each package restores the other's checkpoint bitwise."""
    from repro.elastic import ElasticCheckpointer as JaxCheckpointer
    from repro.elastic import save_sharded as jsave
    from repro.parallel.plan import ParallelPlan as JaxPlan
    jtree, jz, tmesh, zmesh = _jax_states()
    if layout == "tree":
        jstate, jplan, mesh = jtree, JaxPlan(mode="gspmd"), tmesh
        plan, grid = ParallelPlan(mode="gspmd"), None
    else:
        jstate, jplan, mesh = jz, JaxPlan(mode="ddp", zero1=True,
                                          overlap=False), zmesh
        plan, grid = ZERO1, grid1
    tstate = _port(jstate)
    jsave(jstate, jplan, mesh, step=4, root_or_backend=str(tmp_path / "j"))
    save_sharded(tstate, plan, grid, step=4,
                 root_or_backend=str(tmp_path / "t"))
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    jman, tman = (json.loads(f["step_4/plan.json"]) for f in (jf, tf))
    assert jman["layout"] == tman["layout"] == layout
    for field in jman:
        assert jman[field] == tman[field], field
    assert sorted(jman) == sorted(tman) and jf == tf

    zeros = {k: (torch.zeros_like(v) if torch.is_tensor(v) else
                 {n: torch.zeros_like(x) for n, x in named_leaves(v)})
             for k, v in tstate.items()}
    zeros["params"] = _port(jstate["params"])
    got, step = ElasticCheckpointer(str(tmp_path / "j"), plan,
                                    grid).restore_latest(zeros)
    assert step == 4
    _bitwise_jax(jstate, got)
    jgot, step = JaxCheckpointer(str(tmp_path / "t"), jplan,
                                 mesh).restore_latest(jstate)
    assert step == 4
    _bitwise_jax(jgot, tstate)


# ------------------------- 2 pods x 2 ranks (gloo) -------------------------


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """Every rank's ``multidev.check_elastic_all`` result, one spawn of 4
    gloo ranks (pipe 2 x pod 1 x data 2): the ZeRO-1 checkpoints on 2
    pods x 2 ranks, then both elastic legs of the FT drill with its
    planted faults."""
    from repro_torch.testing import multidev as md
    root = tmp_path_factory.mktemp("spawn")
    ranks = md.run_ranks(md.check_elastic_all, 1, 2, "cpu",
                         args=(str(root), md.Drill(remat="none"),
                               (md.RESUME_AT_FAILURE, md.SICK_GEMM,
                                md.SHARDS_SWAPPED)),
                         timeout=300, pipe=2)
    return [out for out, _ in ranks]


def test_zero1_save_resume_and_reshard_across_ranks(spawn):
    """gpt2-medium smoke, ddp + ZeRO-1 on 2 pods x 2 ranks: the resumed
    run (async save at step 2, restart, every rank restoring its own
    shard) equals the straight one bitwise, losses and final shards;
    rank 0's one-process gspmd restore holds every rank's masters; and
    the tree it saved restores back onto each rank's shard bitwise."""
    ranks = [r["zero1"] for r in spawn]
    masters = []
    for r in ranks:
        assert r["restored_step"] == 2 and r["restored_opt_step"] == 2
        np.testing.assert_array_equal(r["restored"], r["at_save"])
        assert r["resumed"] == r["straight"][2:]
        np.testing.assert_array_equal(r["final_resumed"],
                                      r["final_straight"])
        np.testing.assert_array_equal(r["back"], r["at_save"])
        masters.append(r["at_save"][:r["at_save"].size // 3])
    # strong-major shards: rank (pod, j) holds chunk j, sub-chunk pod
    order = [0, 2, 1, 3]
    flat = np.concatenate([masters[i] for i in order])
    tree = ranks[0]["tree_master"]
    np.testing.assert_array_equal(flat[:tree.size], tree)
    assert not np.any(flat[tree.size:])


# ------------- the FT drill's elastic legs across 4 ranks (A14) -------------


def _digest_ok(d, kinds):
    """Every failure / validator / restore / rescale / ckpt record once
    (straggler records read the host clock and are not counted)."""
    assert d["jsonl_matches_report"] and d["n_jsonl"] == d["n_report"]
    assert d["unique"], "duplicate platform event on the JSONL stream"
    assert {k: n for k, n in d["kinds"].items() if k != "straggler"} == \
        kinds
    order = d["order"]
    assert order.index("failure") < order.index("validator") < \
        order.index("restore")
    if "rescale" in kinds:
        assert order.index("restore") < order.index("rescale")


def test_elastic_same_plan_kill_resume_bitwise(spawn):
    """``check_elastic_kill_resume`` on every rank: ddp + ZeRO-1 killed
    at step 7 by a non-fatal class, restored from step 5: the losses
    (replay included) and every leaf of the final state equal the
    unbroken run bitwise; one restore, no rescale, every record once."""
    for r, out in enumerate(o["drill"] for o in spawn):
        s = out["same_plan"]
        assert s["cls"] == "sw_xid43", s["cls"]
        assert s["losses_bitwise"] and s["n_losses"] == [12, 12], r
        assert s["state_bitwise"] and s["state_diff"] == 0.0, r
        assert (s["failures"], s["restores"], s["rescales"],
                s["lost_steps"], s["world"]) == (1, 1, 0, 2, 2)
        assert all(c["ok"] for c in s["validator"].values())
        _digest_ok(s["digest"], {"ckpt": 4, "failure": 1, "validator": 1,
                                 "restore": 1})


def test_elastic_cross_plan_rescale(spawn):
    """``check_elastic_cross_plan``: pp on 4 ranks killed at step 7 by a
    fatal class; the survivors (ranks 0, 1) reshard checkpoint 5 onto
    ddp + ZeRO-1 and their 5 post-restore losses stay within 1e-5 of
    the unbroken pp run (the JAX check's bound); ranks 2, 3 leave after
    the validator's verdict."""
    for r, out in enumerate(o["drill"] for o in spawn):
        c = out["cross_plan"]
        assert c["cls"] == "nvlink_xid74", c["cls"]
        if r >= 2:
            assert c["left_at"] == 7
            assert [k for k in c["events"] if k != "straggler"] == [
                "ckpt", "ckpt", "failure", "validator"]
            continue
        assert len(c["cont_losses"]) == 5
        assert c["post_err"] <= 1e-5, c
        assert (c["failures"], c["restores"], c["rescales"], c["world"],
                c["lost_steps"]) == (1, 1, 1, 1, 2)
        assert all(v["ok"] for v in c["validator"].values())
        _digest_ok(c["digest"], {"ckpt": 4, "failure": 1, "validator": 1,
                                 "restore": 1, "rescale": 1})


def test_elastic_planted_faults_fail_their_gates(spawn):
    """The drill's planted faults each fail the gate that guards them:
    resuming at the failure step breaks the bitwise replay, a sick GEMM
    check turns the non-fatal class into a rescale, and survivors that
    take each other's ZeRO-1 shard leave the unbroken pp run."""
    from repro_torch.testing import multidev as md
    for r, out in enumerate(o["drill"] for o in spawn):
        f = out["faults"]
        resume = f[md.RESUME_AT_FAILURE]
        assert not resume["losses_bitwise"] and not resume["state_bitwise"]
        sick = f[md.SICK_GEMM]
        assert sick["rescales"] == 1 and sick["world"] == 1
        assert sick["validator"]["gemm_oracle"]["ok"] is False
        swapped = f[md.SHARDS_SWAPPED]
        if r < 2:
            assert swapped["post_err"] > 1e-3, swapped["post_err"]
