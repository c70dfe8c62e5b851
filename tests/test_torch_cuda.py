"""The port's kernels against their plain PyTorch versions on the card
(bf16; tolerances as in chip_smoke.py).  Every test here needs a CUDA
device and skips without one; on the card:

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
