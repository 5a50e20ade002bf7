"""rwkv6_scan's plain PyTorch version against the reference kernel
(interpret mode) and its oracle, at the reference's own kernel tolerances
(5e-5 fp32, 5e-2 bf16, tests/test_kernels.py); and the model's wkv6_scan,
with a carried state, against the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro.models import ssm as JS
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan, rwkv6_scan_cost,
                                            rwkv6_scan_plain)
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 5e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
# tests/test_kernels.py::test_rwkv6_scan's shapes
SHAPES = [(2, 64, 2, 16, 16), (1, 128, 4, 32, 64), (2, 32, 1, 64, 32)]


def _inputs(b, t, h, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.3, 0.99, (b, t, h, hd)).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,hd,bt", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(b, t, h, hd, bt, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    r, k, v, w, u = _inputs(b, t, h, hd, seed=t + hd)
    jr, jk, jv, jw = (jnp.asarray(x, jdt) for x in (r, k, v, w))
    ju = jnp.asarray(u)
    kern = j_scan(jr, jk, jv, jw, ju, block_t=bt, interpret=True)

    def fl(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, t, hd)

    uf = jnp.broadcast_to(ju[None], (b, h, hd)).reshape(b * h, 1, hd)
    ref = rwkv6_scan_ref(fl(jr), fl(jk), fl(jv), fl(jw), uf) \
        .reshape(b, h, t, hd).transpose(0, 2, 1, 3)
    tr, tk, tv, tw = (torch.tensor(x).to(tdt) for x in (r, k, v, w))
    tu = torch.tensor(u)
    out = rwkv6_scan_plain(tr, tk, tv, tw, tu)
    assert out.dtype == tdt and out.shape == (b, t, h, hd)
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)
    before = rwkv6_scan.launches
    assert torch.equal(rwkv6_scan(tr, tk, tv, tw, tu), out)
    assert rwkv6_scan.launches == before


@pytest.mark.parametrize("t", [1, 37])
def test_wkv6_scan_with_a_carried_state_matches_reference(t):
    b, h, hd = 2, 3, 16
    r, k, v, w, u = _inputs(b, t, h, hd, seed=5)
    s0 = np.random.default_rng(6).standard_normal(
        (b, h, hd, hd)).astype(np.float32)
    jy, js = JS.wkv6_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                          jnp.asarray(s0))
    ty, ts = TS.wkv6_scan(*(torch.tensor(x) for x in (r, k, v, w, u)),
                          torch.tensor(s0))
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=5e-5,
                               atol=5e-5)


def test_zero_state_scan_equals_the_kernel_function():
    """wkv6_scan from a zero state computes what the kernel computes (the
    model's forward takes the kernel, decode takes wkv6_scan)."""
    r, k, v, w, u = (torch.tensor(x) for x in _inputs(1, 50, 2, 32, seed=7))
    y, _ = TS.wkv6_scan(r, k, v, w, u)
    np.testing.assert_allclose(y.numpy(),
                               rwkv6_scan_plain(r, k, v, w, u).numpy(),
                               rtol=5e-5, atol=5e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, w, u = (torch.tensor(x) for x in _inputs(1, 4, 2, 16, seed=8))
    with pytest.raises(ValueError, match="u must be"):
        rwkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(TypeError, match="float32"):
        rwkv6_scan(r, k, v, w, u.double())
    with pytest.raises(TypeError):
        rwkv6_scan(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_scan(*(x[..., :8].contiguous() for x in (r, k, v, w)),
                   u[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)


def test_cost():
    ops, nbytes = rwkv6_scan_cost(1, 4096, 64, 64, 4)
    assert ops == 4096 * 64 * (5 * 64 * 64 + 5 * 64)         # ~5.45 GFLOP
    assert nbytes == 5 * 4096 * 64 * 64 * 4 + 64 * 64 * 4    # ~0.34 GB
