"""flash_attention's backward kernel (and the forward's log-sum-exp) on
the card, against the plain versions; the scans' bf16 grad guard.

Needs an NVIDIA GPU with nvcc (the kernels are built at first use);
skipped elsewhere.  On the card: ``python -m pytest -q -m cuda
tests/test_torch_flash_attention_bwd_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain)
from repro_torch.kernels.flash_attention.ops import _forward, _plain_forward

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# max |kernel - plain(float64)| over the largest of the three gradients'
# max |plain(float64)| (at S 1, dq is exactly 0 and only its rounding is
# left): fp32 accumulation over up to S terms; bf16 also rounds each
# output to 8 bits
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(b, sq, sk, h, kvh, hd, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, kvh, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, kvh, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    return q, k, v, do


def _rel_err(got, want, scale=None) -> float:
    scale = float(want.abs().max()) if scale is None else scale
    return float((got.double() - want).abs().max()) / scale


# (B, Sq, Sk, H, KVH, hd, causal): MHA, GQA and a group of 7; ragged S
# (1, 65, 333, 1000, 2049: off the 64-row tiles); Sq != Sk unmasked
SHAPES = [
    (2, 128, 128, 2, 2, 64, True), (1, 256, 256, 4, 4, 128, True),
    (2, 333, 333, 8, 2, 64, True), (1, 1000, 1000, 4, 2, 64, True),
    (1, 1000, 1000, 4, 2, 64, False), (1, 2049, 2049, 2, 1, 64, True),
    (2, 200, 77, 4, 2, 32, False), (1, 65, 300, 4, 4, 128, False),
    (1, 512, 512, 14, 2, 128, True)] + [
    (b, s, s, h, kvh, hd, causal) for hd in (16, 32, 64, 128)
    for b, s, h, kvh in ((2, 1, 4, 2), (1, 65, 4, 4))
    for causal in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kvh,hd,causal", SHAPES)
def test_backward_matches_plain(cuda, b, sq, sk, h, kvh, hd, causal, dtype):
    q, k, v, do = _inputs(b, sq, sk, h, kvh, hd, dtype, cuda, seed=sq + hd)
    o, lse = _forward(q, k, v, causal, with_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, o, do)), lse.double(), causal=causal)
    scale = max(float(w.abs().max()) for w in want)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        err = _rel_err(g, w, scale)
        assert err <= TOL[dtype], f"{what}: {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_backward_long_group_sums_match_plain(cuda, hd, dtype):
    """dK and dV of one KV head summed over a group of 8 query heads at S
    4096 (up to 32,768 rows a key under the causal mask, on the tensor
    cores): each query tile's products are summed on their own before the
    running sum, so the sum's rounding stays within the tolerance."""
    b, sq, sk, h, kvh = 1, 4096, 4096, 8, 1
    q, k, v, do = _inputs(b, sq, sk, h, kvh, hd, dtype, cuda, seed=hd)
    o, lse = _forward(q, k, v, True, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, o, do)), lse.double(), causal=True)
    scale = max(float(w.abs().max()) for w in want)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all()
        err = _rel_err(g, w, scale)
        assert err <= TOL[dtype], f"{what}: {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_lse_matches_plain_and_leaves_the_output(cuda, causal,
                                                         dtype):
    q, k, v, _ = _inputs(2, 333, 333, 8, 2, 64, dtype, cuda, seed=1)
    o, lse = _forward(q, k, v, causal, with_lse=True)
    o_plain_kernel, none = _forward(q, k, v, causal, with_lse=False)
    assert none is None and torch.equal(o, o_plain_kernel)
    _, want = _plain_forward(q, k, v, causal)
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(),
                               rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_backward_is_deterministic(cuda, hd, dtype):
    """No atomics: dk and dv (summed over a KV head's group) and dq are
    the same bits from two launches."""
    q, k, v, do = _inputs(2, 333, 333, 8, 2, hd, dtype, cuda, seed=5)
    o, lse = _forward(q, k, v, True, with_lse=True)
    a = flash_attention_bwd(q, k, v, o, do, lse)
    b = flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_autograd_launches_both_kernels(cuda):
    """Under autograd the forward launches with lse and the backward
    kernel once; no_grad keeps the forward alone."""
    q, k, v, do = _inputs(1, 300, 300, 4, 2, 64, torch.float32, cuda)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qq, kk, vv)
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_attention.launches == f0 + 1
    assert flash_attention_bwd.launches == b0 + 1
    want = flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, out.detach(), do)),
        _plain_forward(q.double(), k.double(), v.double(), True)[1])
    for t, w in zip((qq, kk, vv), want):
        assert _rel_err(t.grad, w) <= TOL[torch.float32]
    with torch.no_grad():
        flash_attention(qq, kk, vv)
    assert flash_attention_bwd.launches == b0 + 1


def test_model_train_step_runs_the_kernels(cuda):
    """A smoke llama step at S 2304 (the kernel's branch): with remat each
    layer's forward launches twice and its backward once; every q/k/v
    weight gets a nonzero gradient."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch("llama3.2-1b").smoke()
    m = build_model(cfg, dtype=torch.float32, device=cuda, remat=True)
    m.init_weights(torch.Generator(device=cuda).manual_seed(0))
    m.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (1, 2305), device=cuda)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    m.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]}).backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == f0 + 2 * cfg.n_layers
    assert flash_attention_bwd.launches == b0 + cfg.n_layers
    for i in range(cfg.n_layers):
        for proj in ("q", "k", "v"):
            w = getattr(m.layers[i].attn, proj).w
            assert w.grad is not None and float(w.grad.abs().max()) > 0


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_scan_kernels_refuse_grad_mode(cuda, arch):
    """The scans' backward kernels take fp32 only: a scan whose bf16 inputs
    require grad raises TypeError naming the queued bf16 backward, and
    never returns a detached output or takes the plain version; under
    no_grad the bf16 forward runs.  The model upcasts before its scan, so
    its fp32 loss trains through the kernels (the scans' own card tests
    count those launches)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models import build_model
    cfg = get_arch(arch).smoke()
    g = torch.Generator(device=cuda).manual_seed(0)
    bf = dict(device=cuda, dtype=torch.bfloat16)
    if arch == "rwkv6-7b":
        h, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        xs = [torch.rand((1, 65, h, hd), generator=g, **bf)
              .requires_grad_(True) for _ in range(4)]
        u = torch.randn((h, hd), generator=g, device=cuda)
        call = lambda: rwkv6_scan(*xs, u)           # noqa: E731
    else:
        d, n = 2 * cfg.d_model, cfg.d_state
        u, dt = (torch.rand((1, 65, d), generator=g, **bf)
                 .requires_grad_(True) for _ in range(2))
        a = -torch.rand((d, n), generator=g, device=cuda)
        b, c = (torch.randn((1, 65, n), generator=g, **bf) for _ in range(2))
        call = lambda: ssm_scan(u, dt, a, b, c)     # noqa: E731
    with pytest.raises(TypeError, match="bf16 backward"):
        call()
    with torch.no_grad():
        assert call().dtype == torch.bfloat16
    m = build_model(cfg, dtype=torch.float32, device=cuda)
    m.init_weights(torch.Generator(device=cuda).manual_seed(0))
    m.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (1, 65), device=cuda)
    loss = m.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    loss.backward()
    assert torch.isfinite(loss)
