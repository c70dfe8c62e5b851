"""The port's kernels, forward and backward, against their plain
PyTorch versions on the card (bf16; tolerances as in chip_smoke.py),
and two train steps of a small model through the kernels.  Every test
here needs a CUDA device and skips without one; on the card:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

No JAX: the machine with the card need not have it."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rmsnorm_kernel_matches_plain_on_card(cuda):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    x = torch.randn(37, 3072, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(3072, device=cuda, dtype=torch.bfloat16)
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_ref(x, w), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,kv_len,d", [(200, 200, 200, 128),
                                             (64, 300, 250, 128),
                                             (100, 100, 90, 64)])
def test_flash_kernel_matches_plain_on_card(cuda, sq, skv, kv_len, d):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    bf = torch.bfloat16
    q = torch.randn(2, 6, sq, d, device=cuda, dtype=bf)
    k = torch.randn(2, 2, skv, d, device=cuda, dtype=bf)
    v = torch.randn(2, 2, skv, d, device=cuda, dtype=bf)
    got = flash_attention(q, k, v, kv_len=kv_len)
    ref = attention_ref(q, k, v, kv_len=kv_len)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,d", [("bfloat16", 128),
                                        ("float8_e4m3", 128), ("int8", 128),
                                        ("bfloat16", 64)])
def test_paged_kernel_matches_plain_on_card(cuda, kv_dtype, d):
    from repro_torch.kernels.paged_chunk_attention import (
        paged_chunk_attention, paged_chunk_attention_ref)
    from repro_torch.models.attention import KV_DTYPES, quantize_kv
    b, T, h, kvh, nb, bs, nbmax = 3, 5, 6, 2, 40, 16, 8
    q = torch.randn(b, T, h, d, device=cuda, dtype=torch.bfloat16)
    kp, ks = quantize_kv(torch.randn(nb, bs, kvh, d, device=cuda),
                         KV_DTYPES[kv_dtype])
    vp, vs = quantize_kv(torch.randn(nb, bs, kvh, d, device=cuda),
                         KV_DTYPES[kv_dtype])
    bt = torch.randperm(nb, device=cuda)[:b * nbmax].reshape(b, nbmax).int()
    pos = torch.stack([torch.arange(T) + s for s in (0, 37, 120)]).int()
    pos[1, -2:] = -1
    pos = pos.to(cuda)
    got = paged_chunk_attention(q, kp, vp, bt, pos, ks, vs)
    ref = paged_chunk_attention_ref(q, kp, vp, bt, pos, ks, vs)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.all(got[1, -2:] == 0)


@pytest.mark.cuda
def test_flash_kernel_logsumexp_on_card(cuda):
    """The optional per-row logsumexp (the residual the training slice's
    backward will need) against the masked scores' logsumexp."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    bf = torch.bfloat16
    sq, skv, h, kvh, d = 70, 130, 6, 2, 128
    q = torch.randn(1, h, sq, d, device=cuda, dtype=bf)
    k = torch.randn(1, kvh, skv, d, device=cuda, dtype=bf)
    _, lse = flash_attention_fwd(q, k, k, save_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(h // kvh, 1)) * d ** -0.5
    qpos = (skv - sq) + torch.arange(sq, device=cuda)
    keep = torch.arange(skv, device=cuda)[None, :] <= qpos[:, None]
    ref = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, ref, atol=2e-2, rtol=2e-3)


@pytest.mark.cuda
def test_rmsnorm_backward_kernels_match_plain_on_card(cuda):
    """dx and dw kernels against their plain functions, and the RMSNorm
    Function's gradients through the kernels against autograd of the
    plain forward."""
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd_dw_ref,
                                             rmsnorm_bwd_dx_ref,
                                             rmsnorm_fwd_ref, rmsnorm_ref)
    from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_bwd_dw,
                                                    rmsnorm_bwd_dx,
                                                    rmsnorm_fwd)
    bf = torch.bfloat16
    x = torch.randn(300, 3072, device=cuda, dtype=bf)
    w = (1 + 0.1 * torch.randn(3072, device=cuda)).to(bf)
    dy = torch.randn(300, 3072, device=cuda, dtype=bf)
    y, rstd = rmsnorm_fwd(x, w, save_rstd=True)
    y_ref, rstd_ref = rmsnorm_fwd_ref(x, w)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(rstd, rstd_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rmsnorm_bwd_dx(x, w, dy, rstd).float(),
                               rmsnorm_bwd_dx_ref(x, w, dy, rstd),
                               atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(rmsnorm_bwd_dw(x, dy, rstd),
                               rmsnorm_bwd_dw_ref(x, dy, rstd),
                               atol=1e-3, rtol=1e-4)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(rmsnorm(xs, ws), (xs, ws), dy)
    ref = torch.autograd.grad(rmsnorm_ref(xs, ws), (xs, ws), dy)
    assert got[0].dtype == bf and got[1].dtype == bf
    torch.testing.assert_close(got[0].float(), ref[0].float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(got[1].float(), ref[1].float(), atol=0.5,
                               rtol=2e-2)


def _flash_bwd_inputs(cuda, b, sq, skv, h, kvh, d, q_offset, kv_len):
    """q, k, v, do in the model's (b, s, h, d) memory, the plain
    forward's lse and delta = rowsum(o * do), and the mask keywords."""
    from repro_torch.kernels.flash_attention import attention_fwd_ref
    bf = torch.bfloat16

    def t(s, heads):
        return torch.randn(b, s, heads, d, device=cuda,
                           dtype=bf).transpose(1, 2)
    q, k, v, do = t(sq, h), t(skv, kvh), t(skv, kvh), t(sq, h)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1).contiguous()
    return (q, k, v, do, lse, delta), kw


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,q_offset,kv_len,d,h,kvh", [
    (200, 200, 0, 200, 128, 6, 2), (64, 300, 236, 250, 128, 6, 2),
    (100, 100, 0, 90, 64, 6, 2), (129, 129, 0, 129, 64, 4, 1),
    (1000, 1000, 0, 1000, 128, 3, 3), (129, 200, 71, 200, 128, 3, 1),
    (200, 1000, 700, 777, 64, 8, 2)])
def test_flash_backward_kernels_match_plain_on_card(cuda, sq, skv, q_offset,
                                                    kv_len, d, h, kvh):
    """dK/dV and dQ kernels against attention_bwd_ref on the same inputs,
    in the model's (b, s, h, d) memory layout, b = 2: lengths that are
    not multiples of the kernels' 64 / 128-row tiles, GQA groups of 1, 3
    and 4, q_offset > 0, and kv_len < skv with whole key tiles past
    kv_len, whose dK and dV must be exactly 0."""
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)
    args, kw = _flash_bwd_inputs(cuda, 2, sq, skv, h, kvh, d, q_offset,
                                 kv_len)
    dk, dv = flash_attention_bwd_dkv(*args, **kw)
    dq = flash_attention_bwd_dq(*args, **kw)
    for got, ref in zip((dq, dk, dv), attention_bwd_ref(*args, **kw)):
        torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=2e-2)
    assert (dk[:, :, kv_len:] == 0).all() and (dv[:, :, kv_len:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_kernels_are_deterministic_on_card(cuda, d):
    """Two launches on the same inputs give bitwise equal dQ, dK and dV:
    the kernels sum in a fixed order, with no atomics."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)
    args, kw = _flash_bwd_inputs(cuda, 2, 640, 640, 12, 4, d, 0, 640)
    first = flash_attention_bwd_dkv(*args, **kw) + (
        flash_attention_bwd_dq(*args, **kw),)
    second = flash_attention_bwd_dkv(*args, **kw) + (
        flash_attention_bwd_dq(*args, **kw),)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _gating_logits(T, E, device, tie_rows=0, seed=0):
    """fp32 router logits; the first ``tie_rows`` rows are all equal
    (ties everywhere), the next one all zero."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(T, E, device=device, generator=g) * 2
    if tie_rows:
        x[:tie_rows] = 0.5
        x[tie_rows] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k,renorm,ties", [(37, 60, 4, True, 0),
                                               (300, 128, 8, True, 0),
                                               (300, 128, 8, False, 0),
                                               (40, 60, 4, True, 3)])
def test_topk_gating_kernels_match_plain_on_card(cuda, T, E, k, renorm,
                                                  ties):
    """Forward kernel: experts identical to the plain versions', weights
    within 1e-6; tie rows pick experts 0..k-1.  Backward kernel: dlogits
    within (1e-6, 1e-5) of the plain backward and of autograd through
    the plain forward; the Function launches both kernels."""
    from repro_torch.kernels.topk_gating import (LAUNCHES, LAUNCHES_BWD,
                                                 topk_gating,
                                                 topk_gating_bwd_ref,
                                                 topk_gating_fwd_ref,
                                                 topk_gating_ref)
    from repro_torch.kernels.topk_gating.kernel import (topk_gating_bwd,
                                                        topk_gating_fwd)
    x = _gating_logits(T, E, cuda, tie_rows=ties)
    w, e = topk_gating_fwd(x, k, renorm)
    for rw, re in (topk_gating_fwd_ref(x, k, renorm),
                   topk_gating_ref(x, k, renorm)):
        assert torch.equal(e, re)
        torch.testing.assert_close(w, rw, atol=1e-6, rtol=0)
    if ties:
        want = torch.arange(k, device=cuda, dtype=torch.int32)
        assert torch.equal(e[:ties + 1], want.expand(ties + 1, k))
    dw = torch.randn(T, k, device=cuda)
    got = topk_gating_bwd(x, e, dw, k, renorm)
    torch.testing.assert_close(got, topk_gating_bwd_ref(x, e, dw, k, renorm),
                               atol=1e-6, rtol=1e-5)
    xr = x.clone().requires_grad_()
    auto = torch.autograd.grad(topk_gating_ref(xr, k, renorm)[0], xr, dw)[0]
    torch.testing.assert_close(got, auto, atol=1e-6, rtol=1e-5)
    n_fwd, n_bwd = LAUNCHES.value, LAUNCHES_BWD.value
    fn = torch.autograd.grad(topk_gating(xr, k=k, renorm=renorm)[0], xr,
                             dw)[0]
    assert (LAUNCHES.value, LAUNCHES_BWD.value) == (n_fwd + 1, n_bwd + 1)
    assert torch.equal(fn, got)
    if renorm:                                  # bf16 logits: same picks
        xb = x.bfloat16()
        wb, eb = topk_gating_fwd(xb, k)
        rwb, reb = topk_gating_fwd_ref(xb, k)
        assert torch.equal(eb, reb)
        torch.testing.assert_close(wb, rwb, atol=1e-6, rtol=0)
        gb = topk_gating_bwd(xb, eb, dw, k)
        assert gb.dtype == torch.bfloat16
        torch.testing.assert_close(gb.float(), topk_gating_bwd_ref(
            xb, eb, dw, k).float(), atol=1e-2, rtol=1e-2)


def _ssd_inputs(b, l, h, c, dtype, device, p=64, n=64):
    """a in [-2/c, 0]: the carried state keeps at least e^-2 of itself
    across a chunk, so the carry and dh_final count."""
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(b, l, h, p, device=device, generator=g).to(dtype)
    a = -torch.rand(b, l, h, device=device, generator=g) * (2.0 / c)
    B = (torch.randn(b, l, n, device=device, generator=g) / n ** 0.5).to(
        dtype)
    C = (torch.randn(b, l, n, device=device, generator=g) / n ** 0.5).to(
        dtype)
    dy = torch.randn(b, l, h, p, device=device, generator=g).to(dtype)
    dhf = torch.randn(b, h, p, n, device=device, generator=g)
    return x, a, B, C, dy, dhf


def _rel_close(got, want, tol):
    err = (got.float() - want.float()).abs().max()
    assert err <= tol * want.float().abs().max(), (float(err), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,c,dtype", [
    (2, 512, 8, 256, "bfloat16"), (1, 200, 8, 200, "bfloat16"),
    (1, 300, 4, 100, "float32"), (1, 96, 3, 32, "float32")])
def test_ssd_scan_kernels_match_plain_on_card(cuda, b, l, h, c, dtype):
    """Forward kernel: y, h_final and h_prev against the plain forward;
    backward kernel: dx, da, dB, dC against the plain reverse-recurrence
    backward on the same h_prev, dy and dh_final.  Max |difference| over
    max |plain| within 1e-2 for bf16 outputs and 1e-4 for fp32 ones (as
    chip_smoke.py holds them); the same backward twice is bitwise the
    same (no atomics)."""
    from repro_torch.kernels.ssd_scan import ssd_bwd_ref, ssd_fwd_ref
    from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_bwd,
                                                     ssd_scan_fwd)
    dt = getattr(torch, dtype)
    x, a, B, C, dy, dhf = _ssd_inputs(b, l, h, c, dt, cuda)
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
    y, hf, hp = ssd_scan_fwd(x, a, B, C, chunk=c, save_hprev=True)
    ry, rh, rhp = ssd_fwd_ref(x, a, B, C, c)
    for got, want in ((y, ry), (hf, rh), (hp, rhp)):
        if want.abs().max() > 0:
            _rel_close(got, want, tol[got.dtype])
    grads = ssd_scan_bwd(x, a, B, C, rhp, dy, dhf, chunk=c)
    for got, want in zip(grads, ssd_bwd_ref(x, a, B, C, rhp, dy, dhf, c)):
        assert got.dtype == want.dtype
        _rel_close(got, want, tol[got.dtype])
    for g1, g2 in zip(grads, ssd_scan_bwd(x, a, B, C, rhp, dy, dhf,
                                          chunk=c)):
        assert torch.equal(g1, g2)


@pytest.mark.cuda
def test_ssd_scan_function_launches_both_kernels(cuda):
    """ops.ssd_scan on a 300-token sequence (padded to 512 by the
    wrapper) launches the forward kernel, and its gradient the backward
    kernel, once each; y, h_final and the gradients agree with autograd
    of the O(l^2) closed form (no chunks, no padding)."""
    from repro_torch.kernels.ssd_scan import (LAUNCHES, LAUNCHES_BWD,
                                              ssd_quadratic_ref, ssd_scan)
    x, a, B, C, dy, dhf = _ssd_inputs(1, 300, 4, 256, torch.float32, cuda)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, a, B, C)]
        y, hf = fn(*leaves)
        loss = (y * dy).sum() + (hf * dhf).sum()
        return (y, hf, *torch.autograd.grad(loss, leaves))

    def closed(x, a, B, C):
        s = torch.cumsum(a, 1)
        return ssd_quadratic_ref(x, a, B, C), torch.einsum(
            "bsh,bshp,bsn->bhpn", torch.exp(s[:, -1:] - s), x, B)
    n_fwd, n_bwd = LAUNCHES.value, LAUNCHES_BWD.value
    got = run(lambda *t: ssd_scan(*t, chunk=256))
    assert (LAUNCHES.value, LAUNCHES_BWD.value) == (n_fwd + 1, n_bwd + 1)
    for g, w in zip(got, run(closed)):
        _rel_close(g.detach(), w.detach(), 1e-4)


@pytest.mark.cuda
def test_two_train_steps_through_the_kernels(cuda):
    """A 2-layer phi4-mini smoke model in bf16 takes two AdamW steps
    through every kernel of the training path; its first loss agrees
    with the plain path's."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.parallel import ParallelPlan, init_state, \
        make_train_step
    cfg = dataclasses.replace(smoke_config("phi4-mini-3.8b"), n_layers=2,
                              d_head=64, compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(0, device=cuda, dtype="bfloat16")
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             batch_for_model(cfg, "train", 0, 2, 128).items()}
    plain = build_model(dataclasses.replace(cfg, attn_impl="ref",
                                            norm_impl="ref"))
    losses = []
    for m in (model, plain):
        loss, _ = m.loss(params, batch)
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) <= 1e-2 * abs(losses[1])
    opt = AdamW(lr=warmup_cosine(1e-3, 1, 4))
    plan = ParallelPlan(mode="gspmd")
    state = init_state(plan, opt, params)
    step = make_train_step(plan, model, opt)
    reset_launch_counts()
    for i in range(2):
        state, metrics = step(state, batch_for_model(cfg, "train", i, 2,
                                                     128))
        assert torch.isfinite(metrics["loss"])
    counts = launch_counts()
    for name in ("rmsnorm", "rmsnorm_bwd_dx", "rmsnorm_bwd_dw",
                 "flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert counts[name] > 0, (name, counts)
    assert int(state["step"]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_comm_kernels_match_plain_on_card(cuda, dtype):
    """quantize and dequantize (to fp32 and bf16) bitwise equal to their
    plain versions, on gradient-like values with a zero block and on
    values at k + 0.5 code boundaries; each launch is counted."""
    from repro_torch.kernels.quant_comm import (LAUNCHES_DEQUANT,
                                                LAUNCHES_QUANT, dequantize,
                                                dequantize_ref, quantize,
                                                quantize_ref)
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 256 * 513
    x = torch.randn(n, device=cuda, generator=g) * torch.exp(
        torch.randn(n, device=cuda, generator=g))
    x[256:512] = 0
    s = torch.exp(torch.randn(n // 256, 1, device=cuda, generator=g)) / 127
    k = torch.randint(-127, 127, (n // 256, 256), device=cuda, generator=g)
    edge = ((k + 0.5) * s).reshape(-1)
    edge.view(-1, 256)[:, -1] = (127 * s[:, 0])
    for v in (x, edge):
        v = v.to(getattr(torch, dtype))
        q0, d0 = LAUNCHES_QUANT.value, LAUNCHES_DEQUANT.value
        q, sc = quantize(v)
        rq, rs = quantize_ref(v)
        assert torch.equal(q, rq) and torch.equal(sc, rs)
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(dequantize(q, sc, out_dtype=out),
                               dequantize_ref(q, sc, out))
        assert LAUNCHES_QUANT.value == q0 + 1
        assert LAUNCHES_DEQUANT.value == d0 + 2


@pytest.mark.cuda
def test_ddp_collectives_staged_on_card_match_cpu(cuda):
    """Every ``core`` collective on CUDA tensors through host staging (8
    ranks sharing the card, 2 pods x 4 data) gives the CPU ranks' result:
    bitwise, but for int8 (the sum of 8 dequantized chunks in another
    order: fp32 rounding) and the fp8 overflow (NaN on the card)."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.testing.multidev import check_collectives, run_ranks
    build.build_all(["quant_comm"])
    cpu = run_ranks(check_collectives, 2, 4, "cpu")[0][0]
    gpu, counts = run_ranks(check_collectives, 2, 4, "cuda:0",
                            stage="host")[0]
    for k, v in cpu.items():
        if k == "fp8_after":
            continue
        tol = 1e-5 * np.abs(v).max() if k == "int8" else 0
        np.testing.assert_allclose(gpu[k], v, rtol=0, atol=tol, err_msg=k)
    assert counts["quantize"] > 0 and counts["dequantize"] > 0
