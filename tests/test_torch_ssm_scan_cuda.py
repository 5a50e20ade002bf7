"""The CUDA ssm_scan kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(b, t, d, n, dtype, dev, seed=0):
    """As the reference test draws them: dt ~ U(0.001, 0.1), A = -U(0.5, 2)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((b, t, d), generator=g, device=dev)
    dt = 0.001 + 0.099 * torch.rand((b, t, d), generator=g, device=dev)
    a = -(0.5 + 1.5 * torch.rand((d, n), generator=g, device=dev))
    bm, cm = (torch.randn((b, t, n), generator=g, device=dev)
              for _ in range(2))
    return u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,n", [
    (2, 64, 32, 8), (1, 128, 64, 16), (2, 32, 16, 4),      # the test shapes
    (1, 4096, 16384, 16),                                  # jamba prefill
    (2, 333, 1000, 16), (1, 77, 45, 32), (3, 19, 130, 64)])  # ragged
def test_kernel_matches_plain(cuda, b, t, d, n, dtype):
    args = _inputs(b, t, d, n, dtype, cuda)
    before = ssm_scan.launches
    got = ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, t, d)
    want = ssm_scan_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_model_prefill_launches_the_kernel(cuda):
    """mamba_block without a state goes through the kernel on the card,
    once per Mamba sub-layer (7 in jamba's smoke block)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    cfg = get_arch("jamba-1.5-large-398b").smoke()
    m = build_model(cfg, dtype=torch.float32, device=cuda)
    m.init_weights(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    before = ssm_scan.launches
    logits = make_prefill_step(m)({"tokens": toks})
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + cfg.attn_every - 1
    assert torch.isfinite(logits).all()


def test_float64_raises_on_the_card(cuda):
    """The plain version takes float64 (the CPU tests' rounding-free
    witness); the kernel does not, and says so."""
    u, dt, a, bm, cm = _inputs(1, 8, 16, 8, torch.float64, cuda)
    with pytest.raises(TypeError, match="kernel takes"):
        ssm_scan(u, dt, a.float(), bm, cm)
