"""The CUDA rwkv6_scan kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain
from repro_torch.kernels.rwkv6_scan.ops import CHUNK, HEAD_DIMS

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(b, t, h, hd, dtype, dev, seed=0, regime="uniform"):
    """w in one of four regimes: the reference tests' U(0.3, 0.99); the
    model's (w_bias -6: ~0.9975); 10% exact zeros and 10% fp32 denormals
    among U(0, 1); no decay."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, t, h, hd)
    r, k, v = (0.5 * torch.randn(shape, generator=g, device=dev)
               for _ in range(3))
    if regime == "uniform":
        w = 0.3 + 0.69 * torch.rand(shape, generator=g, device=dev)
    elif regime == "model":
        w = torch.exp(-torch.exp(
            -6.0 + 0.5 * torch.randn(shape, generator=g, device=dev)))
    elif regime == "zeros_denormals":
        w = torch.rand(shape, generator=g, device=dev)
        pick = torch.rand(shape, generator=g, device=dev)
        w = torch.where(pick < 0.1, 0.0, w)
        w = torch.where((pick >= 0.1) & (pick < 0.2), 1e-39, w)
    else:
        w = torch.ones(shape, device=dev)
    u = 0.1 * torch.randn((h, hd), generator=g, device=dev)
    return [x.to(dtype) for x in (r, k, v, w)] + [u]


def _hold(got, args, dtype, exact: bool):
    """got against the plain version on the same inputs: in float64 when
    `exact` (near w = 1 the fp32 recurrence itself leaves the exact answer
    by more than 5e-5, tests/test_torch_rwkv6_scan.py)."""
    r, k, v, w, u = args
    want = (rwkv6_scan_plain(r.double(), k.double(), v.double(), w.double(),
                             u)
            if exact else rwkv6_scan_plain(*args))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd", [
    (2, 64, 2, 16), (1, 128, 4, 32), (2, 32, 1, 64), (1, 77, 2, 128),
    (2, 333, 3, 64), (2, 1, 3, 64), (2, CHUNK - 1, 3, 32),
    (1, CHUNK, 2, 128), (2, CHUNK + 1, 3, 16), (1, 4096, 64, 64)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["uniform", "model", "zeros_denormals",
                                    "one"])
@pytest.mark.parametrize("b,t,h,hd", [
    (1, 4096, 64, 64), (2, 333, 3, 128), (1, CHUNK + 1, 2, 16)])
def test_kernel_matches_plain_in_w_regimes(cuda, b, t, h, hd, regime,
                                           dtype):
    """Each regime of w, held against the float64 plain version where w is
    near 1; w = 0 and denormal w give finite, exact-zero decays."""
    args = _inputs(b, t, h, hd, dtype, cuda, seed=3, regime=regime)
    got = rwkv6_scan(*args)
    torch.cuda.synchronize()
    _hold(got, args, dtype, exact=regime in ("model", "one"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_is_deterministic(cuda, hd, dtype):
    """No atomics and a fixed order of sums: two calls agree bit for bit."""
    args = _inputs(2, 333, 3, hd, dtype, cuda, seed=4, regime="model")
    a = rwkv6_scan(*args)
    b = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_workspace_holds_every_chunk_state_but_the_first(cuda):
    """The library states the workspace it needs, and its chunk length is
    the CHUNK the CPU tests mirror."""
    from repro_torch.kernels.rwkv6_scan.ops import _library
    lib = _library()
    for t, states in ((1, 0), (CHUNK, 0), (CHUNK + 1, 1), (4096, 63)):
        assert lib.rwkv6_scan_workspace_floats(2, t, 3, 16) == \
            2 * 3 * states * 16 * 16


def test_model_prefill_launches_the_kernel(cuda):
    """rwkv_time_mix without a state goes through the kernel on the card,
    once per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    cfg = get_arch("rwkv6-7b").smoke()
    m = build_model(cfg, dtype=torch.float32, device=cuda)
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
