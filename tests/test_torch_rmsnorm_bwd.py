"""The fused rmsnorm backward's host side on the CPU: its grid
(``kernels.rmsnorm.kernel.bwd_plan``) and the plain emulations of its
blocked arithmetic in chip_smoke.py (``dx_ring``, ``dw_blocked``), which
the card run holds the kernel against as planted faults.  The kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Inputs are drawn with numpy; fp32, tolerance 1e-5."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _inputs(n, d, seed=3):
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd_ref
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0, shift=0.0):
        a = shift + scale * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32))
    x, dy, w = draw((n, d)), draw((n, d)), draw(d, 0.1, 1.0)
    return x, w, dy, rmsnorm_fwd_ref(x, w)[1]


@pytest.mark.parametrize("n,d,elem_bytes", [
    (4096, 3072, 2),        # phi4's training step
    (4097, 2048, 2),        # ragged: one block a row more than the rest
    (8, 3072, 2),           # a decode tick: n < G, one row a block
    (300, 3072, 4),         # fp32, two slices a thread
    (0, 4096, 2),           # no rows: no blocks
    (140000, 256, 2),       # many rows a block: rstd read in chunks
    (5, 16384, 2)])         # the widest row: four slices, two stages
def test_bwd_plan_puts_every_row_in_one_block(n, d, elem_bytes):
    """Every row lies in exactly one block, blocks are contiguous and in
    order, none is empty, their sizes differ by at most one; the threads'
    16-byte slices cover a row; the number of blocks follows from (n, d)
    and the SM count alone: min(n, blocks at any larger n)."""
    from repro_torch.kernels.rmsnorm.kernel import (MAX_STAGES,
                                                    MAX_THREADS, bwd_plan)
    for sms in (1, 132):
        plan = bwd_plan(n, d, elem_bytes, sms)
        assert plan == bwd_plan(n, d, elem_bytes, sms)
        assert plan.blocks == len(plan.rows) <= n
        assert plan.blocks == min(n, bwd_plan(10 ** 6, d, elem_bytes,
                                              sms).blocks)
        assert plan.blocks in (0, min(n, sms), min(n, 2 * sms))
        hits = np.zeros(n, np.int64)
        stop = 0
        for lo, hi in plan.rows:
            assert lo == stop and hi > lo
            hits[lo:hi] += 1
            stop = hi
        np.testing.assert_array_equal(hits, 1)
        sizes = [hi - lo for lo, hi in plan.rows]
        assert not sizes or max(sizes) - min(sizes) <= 1
        vec = 16 // elem_bytes
        assert plan.threads % 32 == 0 and plan.threads <= MAX_THREADS
        assert plan.threads * plan.slices * vec >= d
        assert 2 <= plan.stages <= MAX_STAGES
    with pytest.raises(ValueError):
        bwd_plan(8, 4 * MAX_THREADS * 16 // elem_bytes + 1, elem_bytes)


@pytest.mark.parametrize("n,d,sms", [(300, 96, 132), (1000, 64, 3),
                                     (37, 40, 8), (5, 128, 132)])
def test_blocked_backward_matches_plain(smoke, n, d, sms):
    """dw as the kernel adds it (one partial per plan block, the
    partials in the combine's fixed order) equals rmsnorm_bwd_dw_ref
    within fp32 rounding, and dx row by row in the plan's blocks equals
    rmsnorm_bwd_dx_ref."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref)
    from repro_torch.kernels.rmsnorm.kernel import bwd_plan
    x, w, dy, rstd = _inputs(n, d)
    rows = bwd_plan(n, d, 4, sms).rows
    want = rmsnorm_bwd_dw_ref(x, dy, rstd).numpy()
    np.testing.assert_allclose(smoke.dw_blocked(x, dy, rstd, rows).numpy(),
                               want, atol=TOL * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(
        smoke.dx_ring(x, w, dy, rstd, rows).numpy(),
        rmsnorm_bwd_dx_ref(x, w, dy, rstd).numpy(), atol=TOL, rtol=TOL)


def test_chip_smoke_rmsnorm_bwd_faults_drop_exactly_their_work(smoke):
    """chip_smoke.py's planted faults of the fused backward: with no
    fault each helper gives the plain result; "dx's dot taken from the
    previous row of the block's ring" and "one block's dw partial left
    out of the fixed-order sum" each differ from it by more than 100x
    the tolerance, and only where they should: dx only off the rows
    whose dot changed, dw by exactly the left-out block's partial."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref)
    from repro_torch.kernels.rmsnorm.kernel import bwd_plan
    n, d = 300, 96
    x, w, dy, rstd = _inputs(n, d, seed=5)
    rows = bwd_plan(n, d, 4, 50).rows        # 100 blocks of 3 rows
    dx_want = rmsnorm_bwd_dx_ref(x, w, dy, rstd)
    dw_want = rmsnorm_bwd_dw_ref(x, dy, rstd)
    np.testing.assert_allclose(smoke.dx_ring(x, w, dy, rstd, rows).numpy(),
                               dx_want.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(smoke.dw_blocked(x, dy, rstd, rows).numpy(),
                               dw_want.numpy(),
                               atol=TOL * float(dw_want.abs().max()), rtol=0)
    bad = smoke.dx_ring(x, w, dy, rstd, rows, smoke.DX_RING_FAULT)
    off = (bad - dx_want).abs().amax(dim=1)
    assert float(off.max()) > 100 * TOL
    assert all(float(off[lo:hi].min()) > 0 for lo, hi in rows)
    bad = smoke.dw_blocked(x, dy, rstd, rows, smoke.DW_PART_FAULT)
    assert float((bad - dw_want).abs().max()) > 100 * TOL
    lo, hi = rows[len(rows) // 2]
    left_out = rmsnorm_bwd_dw_ref(x[lo:hi], dy[lo:hi], rstd[lo:hi])
    np.testing.assert_allclose((bad + left_out).numpy(), dw_want.numpy(),
                               atol=TOL * float(dw_want.abs().max()), rtol=0)
