"""rwkv6_scan's backward kernel on the card, against the float64 plain
backward; its determinism; the model's training path through it.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda
tests/test_torch_rwkv6_scan_bwd_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels.rwkv6_scan import (rwkv6_scan, rwkv6_scan_bwd,
                                            rwkv6_scan_bwd_plain)
from repro_torch.kernels.rwkv6_scan.ops import CHUNK, HEAD_DIMS, _forward

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# max |kernel - plain(float64)| over max |plain(float64)|, per gradient:
# the forward card test's 5e-5 (tests/test_torch_rwkv6_scan_cuda.py),
# taken over each gradient's scale (sums that cancel leave elements near
# 0 whose rounding is the terms')
TOL = 5e-5
W_REGIMES = ("uniform", "model", "zeros_denormals", "one")
NAMES = ("dr", "dk", "dv", "dw", "du")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(b, t, h, hd, dev, seed=0, regime="uniform"):
    """fp32 (r, k, v, w, u, dy); w as tests/test_torch_rwkv6_scan_cuda.py
    draws it in each regime."""
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
    dy = torch.randn(shape, generator=g, device=dev)
    return r, k, v, w, u, dy


def _rel(got, want) -> float:
    scale = float(want.abs().max())
    return float((got.double() - want).abs().max()) / (scale or 1.0)


def _kernel_grads(r, k, v, w, u, dy):
    _, states = _forward(r, k, v, w, u)
    return rwkv6_scan_bwd(r, k, v, w, u, dy, states)


@pytest.mark.parametrize("regime", W_REGIMES)
@pytest.mark.parametrize("b,t,h,hd", [
    (1, 4096, 64, 64), (2, 333, 3, 128), (1, CHUNK + 1, 2, 16),
    (2, 1, 3, 32), (1, CHUNK, 2, 64), (2, 200, 2, 32)])
def test_kernel_matches_float64_plain(cuda, b, t, h, hd, regime):
    r, k, v, w, u, dy = _inputs(b, t, h, hd, cuda, seed=t + hd,
                                regime=regime)
    before = rwkv6_scan_bwd.launches
    got = _kernel_grads(r, k, v, w, u, dy)
    torch.cuda.synchronize()
    assert rwkv6_scan_bwd.launches == before + 1
    want = rwkv6_scan_bwd_plain(r.double(), k.double(), v.double(),
                                w.double(), u, dy.double())
    for name, g, x in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert _rel(g, x) <= TOL, f"{name}: {_rel(g, x):.3g}"


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_is_deterministic(cuda, hd):
    """No atomics and a fixed order of sums: two calls agree bit for bit."""
    args = _inputs(2, 333, 3, hd, cuda, seed=4, regime="model")
    a = _kernel_grads(*args)
    b = _kernel_grads(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_workspace_is_the_g_states_and_du_partials(cuda):
    """G at every chunk's end but the last, (B, H, ceil(T/C) - 1, hd, hd),
    and du's partials, (B, H, ceil(T/C), hd): no dv workspace."""
    from repro_torch.kernels.rwkv6_scan.ops import _library
    lib = _library()
    for hd in HEAD_DIMS:
        for t in (1, CHUNK, 100, 4096):
            n = -(-t // CHUNK)
            assert lib.rwkv6_scan_bwd_workspace_floats(2, t, 3, hd) == \
                2 * 3 * (n - 1) * hd * hd + 2 * 3 * n * hd


def test_backward_needs_the_chunk_states(cuda):
    r, k, v, w, u, dy = _inputs(1, 130, 2, 16, cuda)
    with pytest.raises(ValueError, match="chunk states"):
        rwkv6_scan_bwd(r, k, v, w, u, dy, None)


def test_bf16_backward_raises_on_the_card(cuda):
    """The backward kernel takes fp32; bf16 with grad raises TypeError and
    names the queued bf16 backward, never a silent plain route."""
    r, k, v, w, u, _ = _inputs(1, 70, 2, 16, cuda)
    xs = [x.to(torch.bfloat16).requires_grad_(True) for x in (r, k, v, w)]
    with pytest.raises(TypeError, match="bf16 backward"):
        rwkv6_scan(*xs, u)
    with torch.no_grad():                 # the forward still takes bf16
        assert rwkv6_scan(*xs, u).dtype == torch.bfloat16


def test_model_loss_backward_launches_the_kernel(cuda):
    """A smoke rwkv6 loss.backward() on the card: with remat each layer's
    forward launches twice and its backward once; every time-mix weight
    gets a nonzero gradient, u and w_bias included."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("rwkv6-7b").smoke()
    m = build_model(cfg, dtype=torch.float32, device=cuda, remat=True)
    m.init_weights(torch.Generator(device=cuda).manual_seed(0))
    m.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 131), device=cuda)
    f0, b0 = rwkv6_scan.launches, rwkv6_scan_bwd.launches
    loss = m.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert rwkv6_scan.launches == f0 + 2 * cfg.n_layers
    assert rwkv6_scan_bwd.launches == b0 + cfg.n_layers
    for name, p in m.named_parameters():
        if ".rwkv." in name:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert any(float(p.grad.abs().max()) > 0 for n, p in m.named_parameters()
               if n.endswith(".u"))
