"""The CUDA rwkv6_scan kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(b, t, h, hd, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (0.5 * torch.randn((b, t, h, hd), generator=g, device=dev)
               for _ in range(3))
    w = 0.3 + 0.69 * torch.rand((b, t, h, hd), generator=g, device=dev)
    u = 0.1 * torch.randn((h, hd), generator=g, device=dev)
    return [x.to(dtype) for x in (r, k, v, w)] + [u]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd", [
    (2, 64, 2, 16), (1, 128, 4, 32), (2, 32, 1, 64), (1, 77, 2, 128),
    (2, 333, 3, 64)])
def test_kernel_matches_plain(cuda, b, t, h, hd, dtype):
    args = _inputs(b, t, h, hd, dtype, cuda)
    before = rwkv6_scan.launches
    got = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, t, h, hd)
    want = rwkv6_scan_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_model_prefill_launches_the_kernel(cuda):
    """rwkv_time_mix without a state goes through the kernel on the card,
    once per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    cfg = get_arch("rwkv6-7b").smoke()
    m = build_model(cfg, device=cuda)
    m.init_weights(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    before = rwkv6_scan.launches
    logits = make_prefill_step(m)({"tokens": toks})
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + cfg.n_layers
    assert torch.isfinite(logits).all()


def test_float64_raises_on_the_card(cuda):
    """The plain version takes float64 (the CPU tests' rounding-free
    witness); the kernel does not, and says so."""
    r, k, v, w, u = _inputs(1, 8, 2, 16, torch.float64, cuda)
    with pytest.raises(TypeError, match="kernel takes"):
        rwkv6_scan(r, k, v, w, u)
