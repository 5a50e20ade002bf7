"""ssm_scan's backward kernels on the card, against the float64 plain
backward, from the saving forward's checkpoints and without them; their
determinism; the hybrid model's gradient through them.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda
tests/test_torch_ssm_scan_bwd_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_bwd,
                                          ssm_scan_bwd_plain)
from repro_torch.kernels.ssm_scan.ops import STATE_DIMS, _forward

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# max |kernel - plain| over max |plain|, per gradient: the forward card
# test's 5e-5 (tests/test_torch_ssm_scan_cuda.py), against float64; in
# "long" fp32's rounding of each decay compounds over the ~2,000-step
# memory and the fp32 plain backward itself leaves float64 by up to 7.2e-5
# (tests/test_torch_ssm_scan_bwd.py): there the kernel is held to the fp32
# plain version at 5e-5 and to float64 at the pinned 1e-4
TOL = 5e-5
FP64_TOL = {"test": TOL, "model": TOL, "long": 1e-4}
NAMES = ("du", "ddt", "da", "db", "dc")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(b, t, d, n, dev, seed=0, regime="test"):
    """fp32 (u, dt, a, b, c, dy); dt and A as
    tests/test_torch_ssm_scan_cuda.py draws them in each regime."""
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
    dy = torch.randn((b, t, d), generator=g, device=dev)
    return u, dt, a, bm, cm, dy


def _rel(got, want) -> float:
    scale = float(want.abs().max())
    return float((got.double() - want.double()).abs().max()) / (scale or 1.0)


@pytest.mark.parametrize("regime", ["test", "model", "long"])
@pytest.mark.parametrize("b,t,d,n", [
    (1, 4096, 16384, 16),                                  # jamba
    (2, 333, 1000, 16), (1, 77, 45, 32), (3, 19, 130, 64),
    (2, 150, 37, 4), (1, 64, 64, 8), (2, 1, 9, 16)])
def test_kernel_matches_plain(cuda, b, t, d, n, regime):
    u, dt, a, bm, cm, dy = _inputs(b, t, d, n, cuda, seed=t + n,
                                   regime=regime)
    before = ssm_scan_bwd.launches
    got = ssm_scan_bwd(u, dt, a, bm, cm, dy)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before + 1
    want = ssm_scan_bwd_plain(u.double(), dt.double(), a, bm.double(),
                              cm.double(), dy.double())
    plain = (ssm_scan_bwd_plain(u, dt, a, bm, cm, dy) if regime == "long"
             else None)
    for i, (name, g, x) in enumerate(zip(NAMES, got, want)):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert _rel(g, x) <= FP64_TOL[regime], f"{name}: {_rel(g, x):.3g}"
        if plain is not None:
            assert _rel(g, plain[i]) <= TOL, name


@pytest.mark.parametrize("n", STATE_DIMS)
@pytest.mark.parametrize("t", [1, 63, 64, 65, 150])
def test_kernel_ragged_from_the_forward_states(cuda, t, n):
    """T on and off the 64-step chunks and the 32-step halves, D off every
    block's channels, B 2: the backward from the saving forward's
    checkpoints against the float64 plain backward, and bit for bit the
    backward that steps them itself (states=None)."""
    u, dt, a, bm, cm, dy = args = _inputs(2, t, 133, n, cuda, seed=t + n,
                                          regime="model")
    f0 = ssm_scan.launches
    _, states = _forward(u, dt, a, bm, cm, save=True)
    assert ssm_scan.launches == f0 + 1
    got = ssm_scan_bwd(*args, states=states)
    again = ssm_scan_bwd(*args)                  # runs the saving forward
    torch.cuda.synchronize()
    assert ssm_scan.launches == f0 + 2
    want = ssm_scan_bwd_plain(u.double(), dt.double(), a, bm.double(),
                              cm.double(), dy.double())
    for name, g, h, x in zip(NAMES, got, again, want):
        assert torch.equal(g, h), name
        assert _rel(g, x) <= TOL, f"{name}: {_rel(g, x):.3g}"


def test_backward_checks_states_on_the_card(cuda):
    """The checkpoints must be the forward's: fp32, (B, ceil(T / 64) - 1,
    D, N), contiguous, on the inputs' device."""
    u, dt, a, bm, cm, dy = args = _inputs(1, 150, 40, 16, cuda)
    _, states = _forward(u, dt, a, bm, cm, save=True)
    for bad in (states[:, :1].contiguous(), states.double(), states.cpu()):
        with pytest.raises(ValueError, match="checkpoints"):
            ssm_scan_bwd(*args, states=bad)


@pytest.mark.parametrize("n", STATE_DIMS)
def test_kernel_is_deterministic(cuda, n):
    """No atomics and a fixed order of sums: two calls agree bit for bit."""
    args = _inputs(2, 333, 1000, n, cuda, seed=n, regime="model")
    states = _forward(*args[:5], save=True)[1]
    a = ssm_scan_bwd(*args, states=states)
    b = ssm_scan_bwd(*args, states=states)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bf16_backward_raises_on_the_card(cuda):
    """The backward kernels take fp32; bf16 with grad raises TypeError and
    names the queued bf16 backward, never a silent plain route."""
    u, dt, a, bm, cm, _ = _inputs(1, 70, 32, 16, cuda)
    xs = [x.to(torch.bfloat16).requires_grad_(True) for x in (u, dt)]
    with pytest.raises(TypeError, match="bf16 backward"):
        ssm_scan(*xs, a, bm.to(torch.bfloat16), cm.to(torch.bfloat16))
    with torch.no_grad():                 # the forward still takes bf16
        y = ssm_scan(*xs, a, bm.to(torch.bfloat16), cm.to(torch.bfloat16))
        assert y.dtype == torch.bfloat16


def test_model_loss_backward_launches_the_kernel(cuda):
    """A smoke jamba loss.backward() on the card: with remat each Mamba
    sub-layer's forward launches twice and its backward once; every Mamba
    weight gets a nonzero gradient."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("jamba-1.5-large-398b").smoke()
    m = build_model(cfg, dtype=torch.float32, device=cuda, remat=True)
    m.init_weights(torch.Generator(device=cuda).manual_seed(0))
    m.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 131), device=cuda)
    n_mamba = sum(1 for n, _ in m.named_parameters() if n.endswith(".A_log"))
    f0, b0 = ssm_scan.launches, ssm_scan_bwd.launches
    loss = m.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert ssm_scan.launches == f0 + 2 * n_mamba
    assert ssm_scan_bwd.launches == b0 + n_mamba
    for name, p in m.named_parameters():
        if ".mamba." in name and not name.endswith(".D"):
            assert p.grad is not None and float(p.grad.abs().max()) > 0, name
