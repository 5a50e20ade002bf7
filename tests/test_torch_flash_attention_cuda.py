"""The CUDA flash_attention kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _qkv(b, sq, sk, h, kvh, hd, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, kvh, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, kvh, hd), generator=g, device=dev).to(dtype)
    return q, k, v


# the reference's test shapes, the llama3.2-1b prefill shape, the
# internvl2-2b, qwen2-moe-a2.7b and arctic-480b prefill shapes (GQA 16/8,
# MHA 16/16 and a group of 7, 56/8, at hd 128), and one ragged S (1, 65,
# 333: not a multiple of 16 or 64) with GQA and MHA at every head dim
KERNEL_SHAPES = [
    (2, 128, 2, 2, 64), (1, 256, 4, 4, 128), (2, 64, 2, 2, 32),
    (1, 128, 1, 1, 64), (2, 333, 8, 2, 64), (1, 300, 4, 2, 16),
    (1, 4096, 32, 8, 64), (1, 4096, 16, 8, 128), (1, 4096, 16, 16, 128),
    (1, 4096, 56, 8, 128)] + [
    (b, s, h, kvh, hd) for hd in (16, 32, 64, 128)
    for b, s, h, kvh in ((2, 1, 4, 2), (1, 65, 4, 4), (1, 333, 6, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kvh,hd", KERNEL_SHAPES)
def test_kernel_matches_plain(cuda, b, s, h, kvh, hd, causal, dtype):
    q, k, v = _qkv(b, s, s, h, kvh, hd, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_kernel_is_deterministic(cuda, hd, dtype):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v = _qkv(2, 333, 333, 8, 2, hd, dtype, cuda, seed=5)
    a = flash_attention(q, k, v)
    b = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_kernel_rejects_misaligned_input(cuda):
    buf = torch.zeros(1 * 8 * 2 * 32 + 1, device=cuda)
    q = buf[1:].view(1, 8, 2, 32)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, q, q)


def test_model_prefill_launches_the_kernel(cuda):
    """attention_block's chunked branch goes through the kernel on the
    card, once per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    cfg = get_arch("llama3.2-1b").smoke()
    m = build_model(cfg, dtype=torch.float32, device=cuda)
    m.init_weights(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 2304), device=cuda)
    before = flash_attention.launches
    logits = make_prefill_step(m)({"tokens": toks})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    assert torch.isfinite(logits).all()
