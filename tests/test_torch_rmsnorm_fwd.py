"""The rmsnorm forward and the top-k gating forward on the CPU: the
port's plain rmsnorm forward against the TPU kernel itself (Pallas,
interpret mode); the two kernels' grids (``kernels.rmsnorm.kernel.
fwd_plan``, ``kernels.topk_gating.kernel.gating_plan``); and the plain
emulations of their designs in chip_smoke.py (``rmsnorm_blocks``,
``gating_lane_groups``), which the card run holds the kernels against as
planted faults.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Inputs are drawn with
numpy."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _draw(shape, seed, scale=1.0, shift=0.0):
    a = shift + scale * np.random.default_rng(seed).standard_normal(shape)
    return a.astype(np.float32)


# ------------------------------- rmsnorm -----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_forward_matches_pallas_kernel(dtype):
    """rmsnorm_fwd_ref (y and rstd) and the op on CPU tensors against the
    TPU kernel rmsnorm_fwd (Pallas, interpret mode, save_residuals) with
    five row blocks of 64, on the same x and w.  fp32: within 1e-5.
    bf16: both compute in fp32 from the same bf16 x and round y to bf16
    once, so y lies within one bf16 ulp (2^-7 relative at most); rstd
    within 1e-5 relative."""
    from repro.kernels.rmsnorm.kernel import rmsnorm_fwd as jfwd
    from repro_torch.bridge import tensor_from_numpy
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_fwd_ref
    n, d = 320, 96
    jt = getattr(jnp, dtype)
    x = jnp.asarray(_draw((n, d), 1), jt)
    w = jnp.asarray(_draw(d, 2, 0.1, 1.0), jt)
    jy, jr = jfwd(x, w, eps=1e-6, block_rows=64, interpret=True,
                  save_residuals=True)
    want_y = np.asarray(jy.astype(jnp.float32))
    want_r = np.asarray(jr)[:, 0]
    tx, tw = (tensor_from_numpy(np.asarray(jax.device_get(a)))
              for a in (x, w))
    y, rstd = rmsnorm_fwd_ref(tx, tw)
    assert y.dtype == tx.dtype and rstd.dtype == torch.float32
    np.testing.assert_allclose(rstd.numpy(), want_r, atol=0, rtol=TOL)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), want_y, atol=TOL, rtol=TOL)
    else:
        np.testing.assert_allclose(y.float().numpy(), want_y, atol=1e-6,
                                   rtol=2.0 ** -7)
    assert torch.equal(rmsnorm(tx, tw), y)


@pytest.mark.parametrize("n,d,elem_bytes,width", [
    (8, 3072, 2, 16),           # a decode tick: one block a row
    (4096, 3072, 2, 16),        # phi4's training step
    (4096, 4096, 2, 16),        # zamba2's gated norm over d_inner
    (4097, 2048, 2, 16),        # ragged: one block a row more than the rest
    (300, 2048, 4, 16),         # fp32
    (4096, 3072, 4, 16),        # fp32, 4 slices a thread
    (4096, 3072, 2, 2),         # rows 3075 elements apart: 2-byte loads
    (4096, 2500, 2, 8),         # d not a multiple of 8
    (64, 1000, 2, 16),          # 4 warps a row
    (64, 128, 2, 16),           # a short row: one warp, one slice a thread
    (8, 16384, 2, 16),          # the widest row: 8 slices a thread
    (0, 3072, 2, 16)])          # no rows: no blocks
def test_fwd_plan_puts_every_row_in_one_block(n, d, elem_bytes, width):
    """Every row lies in exactly one block, blocks take contiguous rows
    in order, none is empty, their sizes differ by at most one; there
    are min(n, 4 an SM, 2 at 4 slices a thread or 2-byte loads, 1 at 8
    slices) blocks.  Warps
    and slices follow from d alone, as the first (Triton) kernel laid a
    row out: 8 warps where next_pow2(d) >= 2048, else 4, and
    next_pow2(d) / (32 * warps) 16-byte slices a thread, so the block's
    slices cover the row; a row shorter than that, one slice a thread
    over a power of two of warps.  The plan is cached."""
    from repro_torch.kernels.rmsnorm.kernel import (FWD_MAX_SLICES,
                                                    FWD_WIDE_WARPS,
                                                    fwd_blocks_per_sm,
                                                    fwd_plan)
    vec = 16 // elem_bytes
    vecs = -(-d // vec)
    block = 1 << (d - 1).bit_length()
    for sms in (1, 132):
        plan = fwd_plan(n, d, elem_bytes, sms, width)
        assert fwd_plan(n, d, elem_bytes, sms, width) is plan
        assert plan.blocks == len(plan.rows) == min(
            n, fwd_blocks_per_sm(plan.slices, width) * sms)
        hits = np.zeros(n, np.int64)
        stop = 0
        for lo, hi in plan.rows:
            assert lo == stop and hi > lo
            hits[lo:hi] += 1
            stop = hi
        np.testing.assert_array_equal(hits, 1)
        sizes = [hi - lo for lo, hi in plan.rows]
        assert not sizes or max(sizes) - min(sizes) <= 1
        assert plan.width == width
        warps = 8 if block >= 2048 else 4
        if block >= vec * 32 * warps:
            assert (plan.warps, plan.slices) == (
                warps, block // (vec * 32 * warps))
        else:
            assert plan.slices == 1 and plan.warps & (plan.warps - 1) == 0
            assert 32 * plan.warps >= vecs > 16 * plan.warps or \
                plan.warps == 1
        assert 32 * plan.warps * plan.slices >= vecs
    with pytest.raises(ValueError):
        fwd_plan(8, FWD_MAX_SLICES * 32 * FWD_WIDE_WARPS * vec + 1,
                 elem_bytes)
    with pytest.raises(ValueError):
        fwd_plan(8, d, 4, 132, 2)


def _rows(n, d, seed):
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd_ref
    x, w = _draw((n, d), seed), _draw(d, seed + 1, 0.1, 1.0)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    return x, w, rmsnorm_fwd_ref(x, w)


@pytest.mark.parametrize("n,d,sms", [(300, 96, 5), (8, 3072, 132),
                                     (37, 2500, 2)])
def test_rmsnorm_blocks_matches_plain(smoke, n, d, sms):
    """y and rstd as the kernel computes them under its plan (rows in
    their blocks, each thread's slices) equal the plain forward's within
    fp32 rounding."""
    from repro_torch.kernels.rmsnorm.kernel import fwd_plan
    x, w, (y, rstd) = _rows(n, d, seed=3)
    gy, grstd = smoke.rmsnorm_blocks(x, w, fwd_plan(n, d, 4, sms))
    np.testing.assert_allclose(grstd.numpy(), rstd.numpy(), atol=0,
                               rtol=TOL)
    np.testing.assert_allclose(gy.numpy(), y.numpy(), atol=TOL, rtol=TOL)


def test_chip_smoke_rmsnorm_fwd_faults_drop_exactly_their_work(smoke):
    """chip_smoke.py's planted design faults of the forward kernel, each
    beyond the card's tolerance and only where it lies: "one warp's
    partial left out of the block's sum of squares" gives the plain
    result once warp 0's columns of x are 0 (their squares are all it
    drops) and moves every row otherwise; "a persistent block's rstd
    carried from its previous row" leaves each block's first row as
    plain and moves every other row's rstd to its predecessor's."""
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd_ref
    from repro_torch.kernels.rmsnorm.kernel import fwd_plan
    n, d = 300, 768
    x, w, (y, rstd) = _rows(n, d, seed=5)
    plan = fwd_plan(n, d, 4, 5)           # 4 warps a row, 20 blocks of 15
    assert plan.warps == 4 and plan.blocks == 20
    warp0 = (torch.arange(d) // 4) % (32 * plan.warps) < 32
    by, brstd = smoke.rmsnorm_blocks(x, w, plan,
                                     fault=smoke.RMS_WARP_FAULT)
    assert not smoke.compare("rmsnorm", by, y)[2]
    assert bool(((brstd - rstd).abs() > TOL * rstd).all())
    x0 = x * ~warp0
    y0, rstd0 = rmsnorm_fwd_ref(x0, w)
    fy0, frstd0 = smoke.rmsnorm_blocks(x0, w, plan,
                                       fault=smoke.RMS_WARP_FAULT)
    np.testing.assert_allclose(frstd0.numpy(), rstd0.numpy(), atol=0,
                               rtol=TOL)
    np.testing.assert_allclose(fy0.numpy(), y0.numpy(), atol=TOL, rtol=TOL)
    cy, crstd = smoke.rmsnorm_blocks(x, w, plan,
                                     fault=smoke.RMS_CARRY_FAULT)
    assert not smoke.compare("rmsnorm", cy, y)[2]
    first = torch.zeros(n, dtype=torch.bool)
    first[[lo for lo, _ in plan.rows]] = True
    moved = (crstd - rstd).abs() > TOL * rstd
    assert bool((moved == ~first).all())
    assert torch.equal(crstd[1:][~first[1:]], rstd[:-1][~first[1:]])


# ------------------------------ top-k gating ---------------------------------


@pytest.mark.parametrize("T,E", [(8, 60), (1024, 60), (4096, 60),
                                 (4096, 64), (4096, 128), (100, 16), (77, 3),
                                 (0, 60)])
def test_gating_plan_puts_every_row_in_one_lane_group(T, E):
    """Under the kernel's mapping (row = block * rows_per_block + thread
    // lanes, lane thread % lanes, 256 threads a block) every row below T
    lies in exactly one lane group, whose lanes 0..lanes-1 sit in one
    block and one warp; the group's slots hold each expert below E
    exactly once (lane j: j, j + lanes, ...) and at most 8 logits a lane;
    32 lanes a row up to 8 rows an SM, else 16, with the fewer of the
    kernel's slot counts that covers E.  The plan is cached."""
    from repro_torch.kernels.topk_gating.kernel import (FWD_SLOTS,
                                                        FWD_THREADS,
                                                        FWD_WIDE_ROWS_PER_SM,
                                                        gating_plan)
    for sms in (1, 132):
        plan = gating_plan(T, E, sms)
        assert gating_plan(T, E, sms) is plan
        assert plan.lanes == (32 if T <= FWD_WIDE_ROWS_PER_SM * sms else 16)
        assert plan.slots == next(s for s in FWD_SLOTS[plan.lanes]
                                  if plan.lanes * s >= E)
        assert plan.slots <= 8
        assert plan.rows_per_block == FWD_THREADS // plan.lanes
        assert plan.blocks == -(-T // plan.rows_per_block)
        block, thread = np.divmod(np.arange(plan.blocks * FWD_THREADS),
                                  FWD_THREADS)
        row = block * plan.rows_per_block + thread // plan.lanes
        for r in range(T):
            mine = row == r
            assert sorted(thread[mine] % plan.lanes) == \
                list(range(plan.lanes))
            assert len(set(block[mine])) == 1
            assert len(set(thread[mine] // 32)) == 1
        held = [j + plan.lanes * s for j in range(plan.lanes)
                for s in range(plan.slots)]
        np.testing.assert_array_equal(np.sort([e for e in held if e < E]),
                                      np.arange(E))
    for bad in (0, 129):
        with pytest.raises(ValueError):
            gating_plan(T, bad)


def _gating_rows(T, E, seed):
    """fp32 logits: row 0 all equal; row 1 one logit at 0 and the rest
    at -200, so every p but one underflows to 0 and later rounds pick
    among zeros; row 2 its two largest values equal."""
    x = _draw((T, E), seed, 2.0)
    x[0] = 0.7
    x[1] = -200.0
    x[1, E // 2] = 0.0
    x[2, [E - 1, 0]] = 9.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("T,E,k,renorm", [(64, 60, 4, True),
                                          (64, 3, 3, True),
                                          (64, 100, 16, True),
                                          (64, 64, 6, False)])
def test_gating_lane_groups_match_plain(smoke, T, E, k, renorm):
    """The forward's lane groups (a row's max, sum and argmax rounds over
    its lanes' slots) give the plain forward's experts exactly and its
    weights within 1e-6: ties go to the lower index, and a slot past E
    never wins, not even where every remaining p is 0."""
    from repro_torch.kernels.topk_gating import topk_gating_fwd_ref
    from repro_torch.kernels.topk_gating.kernel import gating_plan
    x = _gating_rows(T, E, seed=4)
    rw, re = topk_gating_fwd_ref(x, k, renorm)
    for sms in (1, 132):              # 16 and 32 lanes a row
        w, e = smoke.gating_lane_groups(x, k, renorm, gating_plan(T, E, sms))
        assert torch.equal(e, re) and int(e.max()) < E
        np.testing.assert_allclose(w.numpy(), rw.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(e[0].numpy(), np.arange(k))
    assert int(e[1, 0]) == E // 2
    np.testing.assert_array_equal(e[1, 1:].numpy(),
                                  [i for i in range(E) if i != E // 2][:k - 1])


def test_chip_smoke_gating_lane_fault_drops_exactly_its_work(smoke):
    """"the row's last lane ignored": the plain forward over the experts
    that lane does not hold, mapped back; it fails the card's gate
    (experts identical, weights within 1e-6) on rows whose plain top-k
    holds one of its experts, and on no other row."""
    from repro_torch.kernels.topk_gating import topk_gating_fwd_ref
    from repro_torch.kernels.topk_gating.kernel import gating_plan
    T, E, k = 256, 60, 4
    x = _gating_rows(T, E, seed=6)
    plan = gating_plan(T, E, 1)                 # 16 lanes: 15, 31, 47
    w, e = smoke.gating_lane_groups(x, k, True, plan, smoke.GATE_LANE_FAULT)
    keep = torch.tensor([i for i in range(E)
                         if i % plan.lanes != plan.lanes - 1])
    kw, ke = topk_gating_fwd_ref(x[:, keep].contiguous(), k)
    assert torch.equal(e, keep[ke.long()].to(torch.int32))
    np.testing.assert_allclose(w.numpy(), kw.numpy(), atol=1e-6, rtol=0)
    rw, re = topk_gating_fwd_ref(x, k)
    hit = (re % plan.lanes == plan.lanes - 1).any(dim=-1)
    bad = (e != re).any(dim=-1) | ((w - rw).abs() > 1e-6).any(dim=-1)
    assert bool(hit.any()) and torch.equal(bad, hit)
