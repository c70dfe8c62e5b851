"""The Hopper SSD kernels' blocked arithmetic on the CPU, against the JAX
package's Pallas kernels in interpret mode.

chip_smoke.py writes the kernels' decomposition out in plain torch
(``ssd_blocked_fwd`` / ``ssd_blocked_bwd``): each chunk's local state
(forward) or state gradient (backward) from its weighted rows, the fold
across the chunks in chunk order (reverse for the backward), dB and dC
per group of heads added in group order, and every fp32 operand of a
tensor-core product split into hi + lo bf16 with fp32 sums.  Here it
runs at small sizes (chunks of 32 over four, and of 40, a multiple of
neither 64 nor 16; three heads in groups of two; slow decay, a drawn in
[-2/c, 0]) on numpy-drawn inputs rounded to bf16, as the kernels take
them, and is held to the card's gates: max |difference| over max |JAX|
within 1e-2 for the bf16 outputs (y, dx, dB, dC) and 1e-4 for the fp32
ones (h_final, h_prev, da).  Its two planted faults, the fold one chunk
late and the lo half dropped, must fail them.  The kernels run only on
the card (tests/test_torch_cuda.py, chip_smoke.py), where these
emulations are their planted faults.  Also the kernels' grid
(``kernel.scan_plan``), pure Python."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_pair import compiled  # noqa: E402

# the card's gates (chip_smoke.py:SSD_REL_TOL)
TOL = {"bf16": 1e-2, "fp32": 1e-4}
FWD_OUT = {"y": "bf16", "h_final": "fp32", "h_prev": "fp32"}
BWD_OUT = {"dx": "bf16", "da": "fp32", "dB": "bf16", "dC": "bf16"}
# b, l, h, p, n, chunk, heads a group
CASES = {"c32": (1, 128, 3, 16, 8, 32, 2),
         "c40": (2, 120, 3, 16, 8, 40, 2)}


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _bf16(a):
    """numpy fp32 -> the nearest bf16 values, still fp32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


_JAX = {}


def _case(name):
    """Inputs (bf16-exact where the kernels take bf16) and the JAX Pallas
    forward (with its saved h_prev) and backward, interpret mode."""
    if name in _JAX:
        return _JAX[name]
    from repro.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd
    b, l, h, p, n, c, _ = CASES[name]
    rng = np.random.default_rng(11)
    x = _bf16(rng.standard_normal((b, l, h, p)).astype(np.float32))
    a = (-rng.random((b, l, h)) * (2.0 / c)).astype(np.float32)
    B = _bf16((rng.standard_normal((b, l, n)) / n ** 0.5).astype(np.float32))
    C = _bf16((rng.standard_normal((b, l, n)) / n ** 0.5).astype(np.float32))
    dy = _bf16(rng.standard_normal((b, l, h, p)).astype(np.float32))
    dhf = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def both(x, a, B, C, dy, dhf):
        y, hf, hp = ssd_scan_fwd(x, a, B, C, chunk=c, interpret=True,
                                 save_residuals=True)
        return (y, hf, hp), ssd_scan_bwd(x, a, B, C, hp, dy, dhf, chunk=c,
                                         interpret=True)
    args = (x, a, B, C, dy, dhf)
    fwd, bwd = jax.device_get(compiled(both, *args)(*args))
    _JAX[name] = {"inputs": args, "fwd": dict(zip(FWD_OUT, fwd)),
                  "bwd": dict(zip(BWD_OUT, bwd))}
    return _JAX[name]


def _torch_inputs(args):
    x, a, B, C, dy, dhf = (torch.from_numpy(np.array(t)) for t in args)
    return (x.bfloat16(), a, B.bfloat16(), C.bfloat16(), dy.bfloat16(), dhf)


def _used(got, want, kind):
    """max |got - want| / max |want| as a share of the tolerance."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max()) / TOL[kind]


def _emulate(smoke, name, fault=None):
    """The blocked forward and backward of case ``name`` (the backward
    from JAX's h_prev, as the card holds the kernel) -> ({output: share
    of its tolerance}, {output: share})."""
    J = _case(name)
    x, a, B, C, dy, dhf = _torch_inputs(J["inputs"])
    c, group = CASES[name][5], CASES[name][6]
    fwd = dict(zip(FWD_OUT, smoke.ssd_blocked_fwd(x, a, B, C, c, fault)))
    hprev = torch.from_numpy(np.array(J["fwd"]["h_prev"]))
    bwd = dict(zip(BWD_OUT, smoke.ssd_blocked_bwd(x, a, B, C, hprev, dy, dhf,
                                                  c, group, fault)))
    return ({k: _used(v, J["fwd"][k], FWD_OUT[k]) for k, v in fwd.items()},
            {k: _used(v, J["bwd"][k], BWD_OUT[k]) for k, v in bwd.items()})


@pytest.mark.parametrize("name", list(CASES))
def test_blocked_forward_matches_jax(smoke, name):
    """y, h_final and h_prev of the blocked forward within the card's
    gates of the JAX Pallas forward; the bf16 dtypes as the kernel's."""
    fwd, _ = _emulate(smoke, name)
    assert max(fwd.values()) <= 1, fwd


@pytest.mark.parametrize("name", list(CASES))
def test_blocked_backward_matches_jax(smoke, name):
    """dx, da, dB and dC of the blocked backward (dB, dC by group of two
    heads of three) within the card's gates of the JAX Pallas backward."""
    _, bwd = _emulate(smoke, name)
    assert max(bwd.values()) <= 1, bwd


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("fault", ["fold", "lo"])
def test_planted_faults_fail_the_gates(smoke, name, fault):
    """The fold one chunk late, and every fp32 operand rounded to bf16
    (its lo half dropped), each fail the forward's gates and the
    backward's."""
    f = {"fold": smoke.SSD_FOLD_FAULT, "lo": smoke.SSD_LO_FAULT}[fault]
    fwd, bwd = _emulate(smoke, name, f)
    assert max(fwd.values()) > 1, fwd
    assert max(bwd.values()) > 1, bwd


@pytest.mark.parametrize("b,l,h,chunk,sms,group", [
    (2, 2048, 64, 256, 132, 4),     # zamba2 training: 256 blocks
    (1, 1024, 64, 256, 132, 1),     # a whole-prompt prefill: 4 chunks
    (1, 200, 8, 200, 132, 1),
    (1, 96, 3, 32, 132, 1),
    (64, 4096, 64, 256, 132, 4)])
def test_scan_plan_from_shapes(b, l, h, chunk, sms, group):
    """The plan's group is the largest (<= MAX_GROUP) that keeps at least
    WAVES_NUM / WAVES_DEN blocks an SM, else 1; its groups cover the
    heads, blocks and state blocks follow from the shapes; the same
    shapes give the same plan; shapes the kernels do not take raise."""
    from repro_torch.kernels.ssd_scan.kernel import (MAX_GROUP, WAVES_DEN,
                                                     WAVES_NUM, scan_plan)
    plan = scan_plan(b, l, h, chunk, sms)
    assert plan == scan_plan(b, l, h, chunk, sms)
    assert plan.group == group
    nc = l // chunk
    assert plan.groups == -(-h // plan.group)
    assert (plan.groups - 1) * plan.group < h <= plan.groups * plan.group
    assert plan.blocks == b * nc * plan.groups
    assert plan.state_blocks == b * nc * h
    assert plan.tiles == -(-chunk // 64)
    if plan.group > 1:
        assert WAVES_DEN * plan.blocks >= WAVES_NUM * sms
    if plan.group < MAX_GROUP:
        bigger = -(-h // (plan.group + 1))
        assert WAVES_DEN * b * nc * bigger < WAVES_NUM * sms
    for bad in ((b, l + 1, h, chunk), (b, l, h, 257), (0, l, h, chunk)):
        with pytest.raises(ValueError):
            scan_plan(*bad, sms)
