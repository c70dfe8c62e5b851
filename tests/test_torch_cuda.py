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


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,q_offset,kv_len,d", [
    (200, 200, 0, 200, 128), (64, 300, 236, 250, 128),
    (100, 100, 0, 90, 64)])
def test_flash_backward_kernels_match_plain_on_card(cuda, sq, skv, q_offset,
                                                    kv_len, d):
    """dK/dV and dQ kernels against attention_bwd_ref on the same inputs,
    in the model's (b, s, h, d) memory layout."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_fwd_ref)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)
    bf = torch.bfloat16

    def t(s, heads):
        return torch.randn(2, s, heads, d, device=cuda,
                           dtype=bf).transpose(1, 2)
    q, k, v, do = t(sq, 6), t(skv, 2), t(skv, 2), t(sq, 6)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1).contiguous()
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    for got, ref in zip((dq, dk, dv), attention_bwd_ref(q, k, v, do, lse,
                                                        delta, **kw)):
        torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=2e-2)


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
