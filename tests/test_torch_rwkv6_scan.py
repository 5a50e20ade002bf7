"""rwkv6_scan's plain PyTorch version against the reference kernel
(interpret mode) and its oracle, at the reference's own kernel tolerances
(5e-5 fp32, 5e-2 bf16, tests/test_kernels.py); and the model's wkv6_scan,
with a carried state, against the reference's.

The CUDA kernel is a chunked scan; :func:`_chunked` repeats its
decomposition in torch ops (the same chunk and sub-chunk, the same running
products of w in the same order, chunks joined through the same incoming
states), so
its arithmetic is held here to the reference and, in four regimes of w,
to the float64 recurrence."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro.models import ssm as JS
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan, rwkv6_scan_cost,
                                            rwkv6_scan_plain)
from repro_torch.kernels.rwkv6_scan.ops import CHUNK, SUB_CHUNK
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


def _chunked(r, k, v, w, u, c=CHUNK, sub=SUB_CHUNK):
    """rwkv6_scan.cu's decomposition in fp32 torch ops: y in r's dtype.

    State pass, per chunk: kR_s = k_s R with R = 1, R *= w_s walked from
    s = c-1 down to 0 (R ends as P); S0' = P S0 + (kR)^T v with S0 held
    as a compensated (Kahan) pair, the scaling's exact rounding error
    kept, and (kR)^T v joined `sub` steps at a time.

    Output pass, per chunk, in sub-chunks of `sub` steps: inside each, q =
    r_t walked from s = t-1 down to the sub-chunk's start gives A_ts =
    q . k_s, then q *= w_s (q ends as r_t E^a_t); A_tt = sum r_t u k_t.
    For s in an earlier sub-chunk b, A_ts = q_t . (k_s R^b_s), R^b the
    running product to b's end, with q_t scaled by M_b (the product over
    sub-chunk b) after block column b, b from the last but one down to 0;
    then q_t = r_t E_t, and y = (r E) S0 + A v."""
    b, t, h, hd = r.shape
    nc, nb = -(-t // c), c // sub

    def chunks(x):                          # (B, H, nc, c, hd), zero-padded
        x = torch.nn.functional.pad(x.float().permute(0, 2, 1, 3),
                                    (0, 0, 0, nc * c - t))
        return x.reshape(b, h, nc, c, hd)
    rc, kc, vc, wc = (chunks(x) for x in (r, k, v, w))
    kr = torch.empty_like(kc)
    p = torch.ones_like(kc[..., 0, :])
    for s in range(c - 1, -1, -1):
        kr[..., s, :] = kc[..., s, :] * p
        p = p * wc[..., s, :]
    s0 = [torch.zeros((b, h, hd, hd))]
    st, e = s0[0], torch.zeros_like(s0[0])          # S = st - e (Kahan)
    for i in range(nc - 1):
        pi = p[:, :, i, :, None].expand_as(st)
        hi = pi * st
        err = (pi.double() * st.double() - hi.double()).float()   # exact
        e, st = (pi.double() * e.double() - err.double()).float(), hi
        for j in range(0, c, sub):      # (kR)^T v, `sub` steps at a time
            d = (kr[:, :, i, j:j + sub].transpose(-1, -2)
                 @ vc[:, :, i, j:j + sub])
            y = d - e
            tv = st + y
            e, st = (tv - st) - y, tv
        s0.append(st - e)

    def subs(x):                            # (B, H, nc, nb, sub, hd)
        return x.reshape(b, h, nc, nb, sub, hd)
    a = torch.zeros((b, h, nc, c, c))
    ad = torch.zeros((b, h, nc, nb, sub, sub))      # the diagonal blocks
    q, ks, ws_ = subs(rc).clone(), subs(kc), subs(wc)
    for s in range(sub - 2, -1, -1):        # rows t > s of each sub-chunk
        ad[..., s + 1:, s] = (q[..., s + 1:, :] * ks[..., s, None, :]).sum(-1)
        q[..., s + 1:, :] = q[..., s + 1:, :] * ws_[..., s, None, :]
    kh = torch.empty_like(ks)
    m = torch.ones_like(ks[..., 0, :])
    for s in range(sub - 1, -1, -1):
        kh[..., s, :] = ks[..., s, :] * m
        m = m * ws_[..., s, :]
    for j in range(nb):
        blk = slice(j * sub, (j + 1) * sub)
        a[..., blk, blk] = ad[..., j, :, :]
    q, kh = q.reshape(b, h, nc, c, hd), kh.reshape(b, h, nc, c, hd)
    for j in range(nb - 2, -1, -1):
        rows, cols = slice((j + 1) * sub, c), slice(j * sub, (j + 1) * sub)
        a[..., rows, cols] = q[..., rows, :] @ kh[..., cols, :].transpose(-1,
                                                                          -2)
        q[..., rows, :] = q[..., rows, :] * m[..., j, None, :]
    diag = torch.arange(c)
    a[..., diag, diag] = (rc * u[None, :, None, None, :] * kc).sum(-1)
    y = q @ torch.stack(s0, dim=2) + a @ vc
    return (y.reshape(b, h, nc * c, hd)[:, :, :t].permute(0, 2, 1, 3)
            .to(r.dtype))


# regimes of w: the reference tests' U(0.3, 0.99); the model's (w_bias -6:
# w ~ 0.9975); exact zeros and fp32 denormals; no decay
W_REGIMES = ("uniform", "model", "zeros_denormals", "one")


def _regime_inputs(b, t, h, hd, regime, seed):
    r, k, v, _, u = _inputs(b, t, h, hd, seed)
    rng = np.random.default_rng(seed + 1)
    shape = (b, t, h, hd)
    if regime == "uniform":
        w = rng.uniform(0.3, 0.99, shape)
    elif regime == "model":
        w = np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))
    elif regime == "zeros_denormals":
        w, pick = rng.uniform(0.0, 1.0, shape), rng.uniform(size=shape)
        w[pick < 0.1] = 0.0
        w[(pick >= 0.1) & (pick < 0.2)] = 1e-39          # fp32 denormal
    else:
        w = np.ones(shape)
    return r, k, v, w.astype(np.float32), u


def _excess(got, want, tol=5e-5) -> float:
    """max |got - want| / (tol + tol |want|): <= 1 passes the tolerance."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (tol + tol * w.abs())).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,hd,bt", SHAPES)
def test_chunked_emulation_matches_reference_kernel_and_oracle(b, t, h, hd,
                                                               bt, dtype):
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
    out = _chunked(*(torch.tensor(x).to(tdt) for x in (r, k, v, w)),
                   torch.tensor(u))
    assert out.dtype == tdt and out.shape == (b, t, h, hd)
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("t", [1, CHUNK - 1, CHUNK, CHUNK + 1, 333])
@pytest.mark.parametrize("regime", W_REGIMES)
def test_chunked_emulation_matches_float64_recurrence(regime, t):
    """The chunked fp32 arithmetic against the float64 recurrence at 5e-5:
    a product that underflows (w = 0, denormal w) gives exact zeros, no
    NaN, and no regime needs a wider tolerance."""
    r, k, v, w, u = (torch.tensor(x) for x in
                     _regime_inputs(1, t, 2, 32, regime, seed=t))
    want = rwkv6_scan_plain(r.double(), k.double(), v.double(), w.double(),
                            u)
    got = _chunked(r, k, v, w, u)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _excess(got, want) <= 1.0


def test_fp32_recurrence_without_decay_leaves_float64():
    """With w = 1 the state only grows, and stepping it in fp32 rounds T
    times: at T 1024 (B 1, H 2, hd 64; the smallest power of two where it
    shows: 1.08x the 5e-5 tolerance, 0.44x at T 512, 1.75x at T 2048) the
    fp32 plain version leaves the float64 recurrence, while the chunked
    form, which rounds the state once per chunk, stays inside (0.40x).
    So near w = 1 the card tests hold the kernel against the float64
    plain version."""
    r, k, v, w, u = (torch.tensor(x) for x in
                     _regime_inputs(1, 1024, 2, 64, "one", seed=0))
    want = rwkv6_scan_plain(r.double(), k.double(), v.double(), w.double(),
                            u)
    assert _excess(rwkv6_scan_plain(r, k, v, w, u), want) > 1.0
    assert _excess(_chunked(r, k, v, w, u), want) <= 1.0
