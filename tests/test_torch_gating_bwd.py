"""The top-k gating backward's lane-group design on the CPU: chip_smoke.py's
plain emulation of the CUDA kernel (``gating_bwd_lane_groups``: the
kernel's lane layout and summation order) against the port's plain
backward and against the TPU kernel itself (Pallas, interpret mode); its
planted design fault, which the card run holds the kernel against; and
the backward's grid (``kernels.topk_gating.kernel.gating_plan(...,
backward=True)``) with its launch descriptor.  The kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py).  Inputs are drawn
with numpy.

Tolerance: the card's gate for the backward, dlogits within (atol 1e-6,
rtol 1e-5) of the plain backward (``chip_smoke.TOL["topk_gating_bwd"]``,
held through ``chip_smoke.compare``): the same fp32 arithmetic with sums
in another order."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _inputs(T, E, k, renorm, seed):
    """fp32 logits (row 0 all equal, row 1 one logit far above the rest,
    so later picks have p = 0), the plain forward's experts (T, k) int32
    and dw (T, k) fp32."""
    from repro_torch.kernels.topk_gating import topk_gating_fwd_ref
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((T, E))).astype(np.float32)
    x[0] = 0.7
    x[1] = -200.0
    x[1, E // 3] = 0.0
    dw = rng.standard_normal((T, k)).astype(np.float32)
    tx = torch.from_numpy(x)
    return tx, topk_gating_fwd_ref(tx, k, renorm)[1], torch.from_numpy(dw)


def _pallas_bwd(x, e, dw, k, renorm):
    from repro.kernels.topk_gating.kernel import topk_gating_bwd
    out = topk_gating_bwd(jnp.asarray(x.numpy()), jnp.asarray(e.numpy()),
                          jnp.asarray(dw.numpy()), k=k, renorm=renorm,
                          interpret=True)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("T,E,k", [(64, 60, 4), (32, 128, 8), (32, 64, 6)])
def test_gating_bwd_lane_groups_match_plain_and_pallas(smoke, T, E, k,
                                                       renorm):
    """Under 32 lanes a row (the backward's plan) and 16 (the kernel
    takes any of the forward's layouts), the emulated kernel's dlogits lie
    within the card's gate of the plain backward and of the TPU kernel
    (interpret mode) on the same logits, experts and dw; the planted
    design fault "a pick's dw taken from the neighbouring lane" fails
    that gate."""
    from repro_torch.kernels.topk_gating import topk_gating_bwd_ref
    from repro_torch.kernels.topk_gating.kernel import gating_plan
    x, e, dw = _inputs(T, E, k, renorm, seed=T + E + k)
    plain = topk_gating_bwd_ref(x, e, dw, k, renorm)
    pallas = _pallas_bwd(x, e, dw, k, renorm)
    assert smoke.compare("topk_gating_bwd", plain, pallas)[2]
    for plan in (gating_plan(T, E, backward=True), gating_plan(T, E, 1)):
        got = smoke.gating_bwd_lane_groups(x, e, dw, k, renorm, plan)
        assert got.dtype == torch.float32 and got.shape == (T, E)
        for want in (plain, pallas):
            assert smoke.compare("topk_gating_bwd", got, want)[2]
        bad = smoke.gating_bwd_lane_groups(x, e, dw, k, renorm, plan,
                                           smoke.GATE_BWD_LANE_FAULT)
        assert not smoke.compare("topk_gating_bwd", bad, plain)[2]
    assert gating_plan(T, E, 1).lanes == 16


def test_gating_bwd_lane_groups_take_any_expert_index(smoke):
    """Experts outside [0, E) contribute nothing and a repeated expert
    gets both picks' dwr, as the TPU kernel's one-hot gather and scatter
    give them; bf16 logits give bf16 dlogits within one bf16 step of the
    fp32 result."""
    from repro_torch.kernels.topk_gating.kernel import gating_plan
    T, E, k = 32, 60, 4
    x, e, dw = _inputs(T, E, k, True, seed=3)
    e = e.clone()
    e[3, 1], e[5, 2], e[7, 3] = -1, E, 1000
    e[9, 1] = e[9, 0]
    plan = gating_plan(T, E, backward=True)
    got = smoke.gating_bwd_lane_groups(x, e, dw, k, True, plan)
    assert smoke.compare("topk_gating_bwd", got, _pallas_bwd(
        x, e, dw, k, True))[2]
    half = smoke.gating_bwd_lane_groups(x.bfloat16(), e, dw, k, True, plan)
    assert half.dtype == torch.bfloat16
    full = smoke.gating_bwd_lane_groups(x.bfloat16().float(), e, dw, k, True,
                                        plan)
    assert smoke.compare("topk_gating_bwd_bf16", half, full.bfloat16())[2]


@pytest.mark.parametrize("T,E", [(8, 60), (4096, 60), (4096, 64),
                                 (4096, 128), (77, 3), (1, 128)])
def test_gating_bwd_plan_gives_every_pick_a_lane(T, E):
    """The backward's plan: 32 lanes a row at every T and SM count (pick
    j of k <= 16 lives in lane j), the fewer of the kernel's slot counts
    that covers E, FWD_THREADS-thread blocks covering every row; the
    launch descriptor carries it in the C struct's field order and is
    built once a shape."""
    from repro_torch.kernels.topk_gating import kernel as K
    plan = K.gating_plan(T, E, backward=True)
    for sms in (1, 132):
        assert K.gating_plan(T, E, sms, backward=True) == plan
    assert plan.lanes == K.BWD_LANES == 32 >= K.MAX_K
    assert plan.slots == next(s for s in K.FWD_SLOTS[32] if 32 * s >= E)
    assert plan.rows_per_block * plan.lanes == K.FWD_THREADS
    assert plan.blocks == -(-T // plan.rows_per_block)
    k = min(E, 4)
    addr, cfg = K._bwd_config(T, E, k, True, 1)
    assert K._bwd_config(T, E, k, True, 1)[0] == addr
    assert [f for f, _ in K._Config._fields_] == [
        "rows", "E", "k", "renorm", "dtype", "lanes", "slots", "blocks"]
    assert (cfg.rows, cfg.E, cfg.k, cfg.renorm, cfg.dtype) == (T, E, k, 1, 1)
    assert (cfg.lanes, cfg.slots, cfg.blocks) == (
        plan.lanes, plan.slots, plan.blocks)
    with pytest.raises(ValueError):
        K.gating_plan(T, 129, backward=True)
