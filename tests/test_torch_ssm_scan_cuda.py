"""The CUDA ssm_scan kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
from repro_torch.kernels.ssm_scan.ops import STATE_DIMS, _forward

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(b, t, d, n, dtype, dev, seed=0, regime="test"):
    """"test": as the reference test draws them, dt ~ U(0.001, 0.1), A =
    -U(0.5, 2); "model": dt = softplus(N(0, 1)), A = -(1..N), as
    init_mamba gives; "long": dt 0.001, A -0.5 (a ~2,000-step memory)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((b, t, d), generator=g, device=dev)
    bm, cm = (torch.randn((b, t, n), generator=g, device=dev)
              for _ in range(2))
    if regime == "test":
        dt = 0.001 + 0.099 * torch.rand((b, t, d), generator=g, device=dev)
        a = -(0.5 + 1.5 * torch.rand((d, n), generator=g, device=dev))
    elif regime == "model":
        dt = torch.nn.functional.softplus(
            torch.randn((b, t, d), generator=g, device=dev))
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).repeat(d, 1)
    else:
        dt = torch.full((b, t, d), 0.001, device=dev)
        a = torch.full((d, n), -0.5, device=dev)
    return u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype)


def _hold(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,n", [
    (2, 64, 32, 8), (1, 128, 64, 16), (2, 32, 16, 4),      # the test shapes
    (1, 4096, 16384, 16),                                  # jamba prefill
    (2, 333, 1000, 16), (1, 77, 45, 32), (3, 19, 130, 64),  # ragged
    # every N with T off the 32- and 64-step chunks and D off the block's
    # channels; odd D (element copies instead of 16-byte pieces)
    (2, 100, 130, 4), (3, 65, 250, 8), (2, 129, 1003, 16), (1, 200, 72, 32),
    (2, 63, 48, 64)])
def test_kernel_matches_plain(cuda, b, t, d, n, dtype):
    args = _inputs(b, t, d, n, dtype, cuda)
    before = ssm_scan.launches
    got = ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, t, d)
    _hold(got, ssm_scan_plain(*args), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["model", "long"])
def test_kernel_in_dt_regimes(cuda, regime, dtype):
    """The model's regime against the plain version; the long-memory one
    against the float64 plain version, since there the fp32 recurrence
    itself moves (tests/test_torch_ssm_scan.py pins by how much)."""
    args = _inputs(2, 4096, 512, 16, dtype, cuda, regime=regime)
    got = ssm_scan(*args)
    want = (ssm_scan_plain(*(x.double() if x.dim() == 3 else x
                             for x in args))
            if regime == "long" else ssm_scan_plain(*args))
    _hold(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_pointers(cuda, dtype):
    """u, dt, B, C one element past a 16-byte boundary: element copies
    instead of 16-byte pieces, same result."""
    args = _inputs(2, 150, 64, 16, dtype, cuda)
    moved = []
    for x in args:
        if x.dim() == 3:
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
            buf.copy_(x.reshape(-1))
            x = buf.view(x.shape)
        moved.append(x)
    assert moved[0].data_ptr() % 16 != 0
    _hold(ssm_scan(*moved), ssm_scan_plain(*args), TOL[dtype])


@pytest.mark.parametrize("n", STATE_DIMS)
@pytest.mark.parametrize("b,t,d", [(2, 150, 130), (1, 4096, 512),
                                   (2, 64, 37), (1, 65, 9)])
def test_saving_forward(cuda, b, t, d, n):
    """The fp32 forward a gradient takes: its y equals the no-grad
    forward's bit for bit, and its checkpoints (h after every 64 steps
    but the last) match the plain version's stepping."""
    args = _inputs(b, t, d, n, torch.float32, cuda, regime="model")
    y, states = _forward(*args, save=True)
    assert torch.equal(y, ssm_scan(*args))
    _, want = ssm_scan_plain(*args, states=True)
    assert states.shape == want.shape == (b, -(-t // 64) - 1, d, n)
    _hold(states, want, TOL[torch.float32])


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
