"""The port's pipelined path (``repro_torch.parallel.pp``,
``ParallelPlan(mode="pp")``, ``launch.train --parallel pp``) against the
JAX package on the CPU.

One spawn of 8 gloo ranks (``run_ranks(check_pp, 2, 2, pipe=2)``)
builds both grids of the JAX package's pipeline checks over the same
ranks and runs:

- ``check_pp_train``'s trajectory on a pipe 2 x pod 2 x data 2 grid:
  the phi4-mini smoke setting with 2 layers in fp32 (``small_dense``,
  AdamW lr 1e-2) on numpy-drawn weights bridged from the JAX tree, 5
  steps of 16 x 32, gpipe and 1f1b at 2 and 4 microbatches.  The JAX
  pp check does not run under the installed jax, so the reference is
  the one-device JAX step on the same weights and batches, which does:
  the loss within 1e-4 and the masters within 5e-3 (the JAX check's
  bounds);
- ``check_pipeline`` on a pipe 4 x data 2 grid: 8 tanh layers through
  the differentiable GPipe forward against the sequential JAX
  computation, forward within 1e-5, gradients within 1e-4;
- a same-plan resume through the launcher's checkpoint: 2 + 2 steps
  equal 4 straight steps bitwise, losses and the saved state.

The other tests need no spawn: the JAX ``tests/test_plan.py`` bubble
and liveness tests mirrored, ``split_stages``, the grid's rank order and
groups against the JAX mesh ("pipe", "pod", "data"), the model
refusals and the launcher's pp flags."""
import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_pair import compiled, jax_mesh, numpy_params  # noqa: E402

SCHEDULES = [f"{s}_m{m}" for s in ("gpipe", "1f1b") for m in (2, 4)]


def _jax_small_dense():
    from repro.configs.registry import smoke_config
    from repro.models import build_model
    cfg = dc.replace(smoke_config("phi4-mini-3.8b"), n_layers=2,
                     compute_dtype="float32")
    return cfg, build_model(cfg)


@pytest.fixture(scope="module")
def params():
    return numpy_params(_jax_small_dense()[1].param_defs())


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    """Every rank's ``check_pp`` result and the checkpoint root."""
    from repro_torch.testing.multidev import check_pp, run_ranks
    root = tmp_path_factory.mktemp("pp")
    ranks = run_ranks(check_pp, 2, 2, "cpu", args=(params, str(root)),
                      timeout=300, pipe=2)
    return [r for r, _ in ranks], root


@pytest.fixture(scope="module")
def jax_trajectory(params):
    """The one-device JAX step's 5 losses and final fp32 masters."""
    from repro import train_lib
    from repro.configs.base import ParallelConfig
    from repro.optim import AdamW
    from repro_torch.data.synthetic import batch_for_model
    cfg, model = _jax_small_dense()
    opt = AdamW(lr=1e-2, param_dtype="float32")
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, params))
    batches = [{k: jnp.asarray(v) for k, v in
                batch_for_model(cfg, "train", i, 16, 32).items()}
               for i in range(5)]
    step = compiled(train_lib.make_train_step(
        model, opt, ParallelConfig(tp=1, fsdp=False, batch_axes=()),
        jax_mesh()), state, batches[0])
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, [np.asarray(x) for x in
                    jax.tree_util.tree_leaves(state["master"])]


# --------------------------- the spawned checks ----------------------------


def test_grid_coordinates_and_rows(runs):
    """Rank r sits at the JAX mesh's (pipe, pod, data) index of device r
    and takes that device's rows: the batch split over ("pod", "data"),
    the same rows on every stage."""
    port, _ = runs
    for r, out in enumerate(port):
        stage, pod, data = np.unravel_index(r, (2, 2, 2))
        assert out["coords"] == (stage, pod, data)
        shard = pod * 2 + data
        assert out["rows"] == (4 * shard, 4 * shard + 4)


@pytest.mark.parametrize("case", SCHEDULES)
def test_pp_train_tracks_one_device_jax(runs, jax_trajectory, case):
    port, _ = runs
    ref_losses, ref_master = jax_trajectory
    got = port[0]["train"][case]
    assert max(abs(a - b) for a, b in zip(got["losses"], ref_losses)) \
        < 1e-4, (got["losses"], ref_losses)
    assert len(got["master"]) == len(ref_master)
    for a, b in zip(got["master"], ref_master):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3)
    for r in port[1:]:
        assert r["train"][case]["losses"] == got["losses"]


def test_gpipe_and_1f1b_agree_bitwise(runs):
    """Every microbatch's work and the order of accumulation are the
    same under both schedules."""
    port, _ = runs
    train = port[0]["train"]
    for m in (2, 4):
        g, f = train[f"gpipe_m{m}"], train[f"1f1b_m{m}"]
        assert g["losses"] == f["losses"]
        for a, b in zip(g["master"], f["master"]):
            np.testing.assert_array_equal(a, b)


def test_pipelined_forward_matches_sequential(runs):
    port, _ = runs
    rng = np.random.default_rng(3)
    L, d, b = 8, 16, 8
    w = jnp.asarray(rng.standard_normal((L, d, d)) * 0.3, jnp.float32)
    x = jnp.asarray(rng.standard_normal((b, d)), jnp.float32)

    def seq(w):
        h = x
        for i in range(L):
            h = jnp.tanh(h @ w[i])
        return h

    y = np.asarray(seq(w))
    g = np.asarray(jax.grad(lambda w: jnp.sum(seq(w) ** 2))(w))
    for out in port:
        assert np.max(np.abs(out["pipeline"]["y"] - y)) < 1e-5
        assert np.max(np.abs(out["pipeline"]["grad"] - g)) < 1e-4


def test_pp_resume_through_the_launcher_is_bitwise(runs):
    """4 straight steps == a resume from their step-2 checkpoint and 2
    more steps: the losses and every tensor of the final checkpoints,
    which rank 0 alone wrote, stamped with the pp mesh."""
    from repro_torch.ckpt.manager import CheckpointManager, read_named
    from repro_torch.elastic import manifest
    port, root = runs
    res = port[0]["resume"]
    assert len(res["straight"]) == 4
    assert res["resumed"] == res["straight"][2:]
    for r in port[1:]:
        assert r["resume"] == res
    a, _ = read_named(CheckpointManager(str(root / "straight")).backend, 4)
    b, _ = read_named(CheckpointManager(str(root / "resumed")).backend, 4)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    man = manifest.loads((root / "resumed" / "step_4" /
                          manifest.MANIFEST_NAME).read_bytes())
    assert man["mesh"] == {"axes": ["pipe", "pod", "data"],
                           "shape": [2, 1, 4]}
    assert man["plan"]["mode"] == "pp" and man["layout"] == "tree"


# ------------------------------- no spawn ----------------------------------


def test_bubble_fraction_both_schedules():
    """Mirror of tests/test_plan.py::test_bubble_fraction_both_schedules,
    against the JAX function too."""
    from repro.parallel import pp as jpp
    from repro_torch.parallel.pp import bubble_fraction
    for schedule in ("gpipe", "1f1b"):
        assert bubble_fraction(1, 8, schedule) == 0.0
        assert bubble_fraction(4, 4, schedule) == pytest.approx(3 / 7)
        assert bubble_fraction(10, 40, schedule) == pytest.approx(9 / 49)
        fracs = [bubble_fraction(4, m, schedule) for m in (1, 2, 4, 8, 16)]
        assert fracs == sorted(fracs, reverse=True)
        for P, m in ((2, 8), (3, 5), (8, 1)):
            assert bubble_fraction(P, m, schedule) == \
                jpp.bubble_fraction(P, m, schedule)
    with pytest.raises(ValueError):
        bubble_fraction(4, 4, "zb-h1")


def test_peak_live_activations():
    """Mirror of tests/test_plan.py::test_peak_live_activations."""
    from repro.parallel import pp as jpp
    from repro_torch.parallel.pp import peak_live_activations
    assert peak_live_activations(4, 16, "gpipe") == 16
    assert peak_live_activations(4, 16, "1f1b") == 7
    assert peak_live_activations(4, 3, "1f1b") == 3
    for m in (1, 4, 64):
        assert peak_live_activations(8, m, "1f1b") == min(m, 15)
        assert (peak_live_activations(8, m, "1f1b")
                <= peak_live_activations(8, m, "gpipe"))
        for s in ("gpipe", "1f1b"):
            assert peak_live_activations(3, m, s) == \
                jpp.peak_live_activations(3, m, s)
    with pytest.raises(ValueError):
        peak_live_activations(4, 4, "zb-h1")


def test_split_stages_matches_jax():
    from repro.parallel import pp as jpp
    from repro_torch.parallel.pp import split_stages
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    tree = {"w": x, "b": {"c": x[:, 0]}}
    got = split_stages({"w": torch.from_numpy(x),
                        "b": {"c": torch.from_numpy(x[:, 0])}}, 4)
    want = jpp.split_stages(tree, 4)
    assert tuple(got["w"].shape) == (4, 2, 3, 2)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))
    with pytest.raises(ValueError):
        split_stages({"w": torch.from_numpy(x)}, 3)


def _fake_grid(monkeypatch, rank, pods, data, pipe):
    """Grid(pods, data, pipe) as rank ``rank`` would build it, with
    ``torch.distributed`` faked: a group is the list of its ranks, and
    every group the rank creates is recorded in order."""
    import torch.distributed as dist

    from repro_torch.core import grid as grid_mod
    made = []

    def new_group(ranks, backend=None):
        made.append(list(ranks))
        return tuple(ranks)
    world = pods * data * pipe
    for name, fn in (("is_initialized", lambda: True),
                     ("get_world_size", lambda group=None: world),
                     ("get_rank", lambda group=None: rank),
                     ("new_group", new_group)):
        monkeypatch.setattr(dist, name, fn)
    monkeypatch.setattr(grid_mod, "_STAGING", {})
    return grid_mod.Grid(pods, data, pipe), made


def test_grid_groups_follow_the_jax_mesh(monkeypatch):
    """Each rank's groups are the JAX mesh ("pipe", "pod", "data")'s
    axes through its device (ids in mesh order, as ``jax.make_mesh``
    lays out the CPU devices): strong = "data", weak = "pod", world =
    ("pod", "data") within the stage, pipe = "pipe"; every rank makes
    the same groups in the same order.  With one stage the groups are
    the (pod, data) grid's, made in its order, and ``all`` is ``world``."""
    mesh = np.arange(8).reshape(2, 2, 2)
    orders = set()
    for r in range(8):
        g, made = _fake_grid(monkeypatch, r, 2, 2, 2)
        p, i, j = np.unravel_index(r, mesh.shape)
        assert (g.stage, g.pod, g.data_index) == (p, i, j)
        assert list(g.strong) == list(mesh[p, i, :])
        assert list(g.weak) == list(mesh[p, :, j])
        assert list(g.world) == list(mesh[p].reshape(-1))
        assert list(g.pipe) == list(mesh[:, i, j])
        assert list(g.all) == list(range(8))
        assert (g.size, g.ranks, g.stages) == (4, 8, 2)
        orders.add(tuple(map(tuple, made)))
    assert len(orders) == 1
    g, made = _fake_grid(monkeypatch, 5, 2, 4, 1)
    assert made[:7] == [list(range(8)), [0, 1, 2, 3], [4, 5, 6, 7],
                        [0, 4], [1, 5], [2, 6], [3, 7]]
    assert g.all is g.world and list(g.pipe) == [5]
    assert (g.pod, g.data_index, g.stage) == (1, 1, 0)


def test_pp_refuses_moe_and_other_families():
    """``_check_pp_model``'s refusals: dense decoder-only LMs only, so
    MoE, the hybrid, the VLM (a ``DecoderLM`` with patches: JAX's
    ``is_vlm`` refusal), Whisper and xLSTM are refused."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.parallel import ParallelPlan
    from repro_torch.parallel.pp import PPStep
    plan = ParallelPlan(mode="pp")
    for arch in ("qwen2-moe-a2.7b", "zamba2-1.2b", "internvl2-76b",
                 "whisper-base", "xlstm-125m"):
        with pytest.raises(ValueError, match="dense decoder-only"):
            PPStep(build_model(smoke_config(arch)), AdamW(), None, plan,
                   device="cpu")
    with pytest.raises(ValueError, match="want 'pp'"):
        PPStep(build_model(smoke_config("phi4-mini-3.8b")), AdamW(), None,
               ParallelPlan(mode="ddp"), device="cpu")
