"""rwkv6_scan's gradient: the plain backward against autograd through the
plain forward in float64 and against ``jax.grad`` of the reference's
oracle in fp32; a torch-op copy of the CUDA backward kernel's
decomposition held to both; the autograd Function on the CPU.

The CUDA backward (``wkv_bwd_state``, ``wkv_bwd`` and ``wkv_bwd_du`` in
``rwkv6_scan.cu``) writes G = dL/dS at every chunk's end in a reverse
state pass, then walks every chunk at once from the forward's chunk
states and those.  :func:`_kernel_order` repeats it in torch ops: both
sets of chunk states as the state passes make them (compensated), S
stepped forward per sub-chunk by fmaf, G walked back from its chunk end
in plain fp32, the row sums as per-thread fmaf chains joined by the xor
shuffles' tree, dv summed over row pairs, then the block's pairs, then the
row tiles in order, du over a chunk's steps, then over chunks, then over
b.  Its constants are read from the source."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan import (Rwkv6ScanFn, rwkv6_scan,
                                            rwkv6_scan_bwd,
                                            rwkv6_scan_bwd_cost,
                                            rwkv6_scan_bwd_plain,
                                            rwkv6_scan_plain)
from repro_torch.kernels.rwkv6_scan.ops import CHUNK, SOURCE, SUB_CHUNK

torch.set_num_threads(1)

_SRC = SOURCE.read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


C = _const("C")
BWD_ROWS, BWD_LANES, BWD_HIST = (_const("BWD_ROWS"), _const("BWD_LANES"),
                                 _const("BWD_HIST"))

# the reference kernel tests' tolerances (tests/test_kernels.py)
TOL = 5e-5
# tests/test_kernels.py::test_rwkv6_scan's shapes (B, T, H, hd)
SHAPES = [(2, 64, 2, 16), (1, 128, 4, 32), (2, 32, 1, 64)]
W_REGIMES = ("uniform", "model", "zeros_denormals", "one")
NAMES = ("dr", "dk", "dv", "dw", "du")


def _inputs(b, t, h, hd, seed, regime="uniform"):
    """numpy fp32 (r, k, v, w, u, dy): r, k, v ~ 0.5 N(0, 1), u ~ 0.1
    N(0, 1), dy ~ N(0, 1); w in one of four regimes: the reference tests'
    U(0.3, 0.99), the model's (w_bias -6: ~0.9975), 10% exact zeros and
    10% fp32 denormals among U(0, 1), no decay."""
    rng = np.random.default_rng(seed)
    shape = (b, t, h, hd)
    r, k, v = (rng.standard_normal(shape) * 0.5 for _ in range(3))
    u = rng.standard_normal((h, hd)) * 0.1
    dy = rng.standard_normal(shape)
    if regime == "uniform":
        w = rng.uniform(0.3, 0.99, shape)
    elif regime == "model":
        w = np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))
    elif regime == "zeros_denormals":
        w, pick = rng.uniform(0.0, 1.0, shape), rng.uniform(size=shape)
        w[pick < 0.1] = 0.0
        w[(pick >= 0.1) & (pick < 0.2)] = 1e-39
    else:
        w = np.ones(shape)
    return [x.astype(np.float32) for x in (r, k, v, w, u, dy)]


def _torch(arrs, dtype=torch.float32):
    r, k, v, w, u, dy = (torch.tensor(x) for x in arrs)
    return [x.to(dtype) for x in (r, k, v, w)] + [u, dy.to(dtype)]


def _autograd(r, k, v, w, u, dy):
    """Autograd through the plain forward (its dtype); an input the output
    does not reach (w at T 1) gets zeros."""
    xs = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
    with torch.enable_grad():
        y = rwkv6_scan_plain(*xs)
        grads = torch.autograd.grad(y, xs, dy, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(xs, grads)]


def _jax_grads(r, k, v, w, u, dy):
    """jax.grad (a vjp) of rwkv6_scan_ref on numpy fp32 inputs."""
    b, t, h, hd = r.shape

    def f(r, k, v, w, u):
        def fl(x):
            return x.transpose(0, 2, 1, 3).reshape(b * h, t, hd)
        uf = jnp.broadcast_to(u[None], (b, h, hd)).reshape(b * h, 1, hd)
        y = rwkv6_scan_ref(fl(r), fl(k), fl(v), fl(w), uf)
        return y.reshape(b, h, t, hd).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (r, k, v, w, u)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _rel(got, want) -> float:
    """max |got - want| over max |want|: how the card tests hold each
    gradient (elementwise tolerances do not fit sums that cancel)."""
    g, w = got.double(), want.double()
    scale = float(w.abs().max())
    return float((g - w).abs().max()) / (scale if scale > 0 else 1.0)


def _fma(x, y, z):
    """fp32 fmaf: the product is exact in float64, then one rounding there
    and one to fp32 (a double rounding that differs from fmaf only on
    exact ties of the float64 sum)."""
    return (x.double() * y.double() + z.double()).float()


def _chunks(x, nc, c=CHUNK):
    """(B, T, H, hd) -> fp32 (B, H, nc, c, hd), zero past T as the
    kernels' staging fills it."""
    b, t, h, hd = x.shape
    x = torch.nn.functional.pad(x.float().permute(0, 2, 1, 3),
                                (0, 0, 0, nc * c - t))
    return x.reshape(b, h, nc, c, hd)


def _chunk_states(a, x, w, reverse=False, c=CHUNK, sub=SUB_CHUNK):
    """The chunk states one of the two state walks writes, fp32, (B, H,
    hd, hd) each, one per chunk (tests/test_torch_rwkv6_scan.py::_chunked
    for the forward's): the state kept as a compensated pair, the running
    products of w, (a P)^T x joined `sub` steps at a time.

    Forward (wkv_state; a = k, x = v): S0 of each chunk, zero for the
    first; the products R_s of w after s to the chunk's end.  Reverse
    (wkv_bwd_state; a = r, x = dy): G_end, dL/dS at each chunk's end, zero
    for the last, walked from the last chunk; the products E_t of w before
    t from the chunk's start."""
    b, t, h, hd = a.shape
    nc = -(-t // c)
    ac, xc, wc = (_chunks(y, nc, c) for y in (a, x, w))
    ap = torch.empty_like(ac)
    p = torch.ones_like(ac[..., 0, :])
    for s in (range(c) if reverse else range(c - 1, -1, -1)):
        ap[..., s, :] = ac[..., s, :] * p
        p = p * wc[..., s, :]
    st = torch.zeros((b, h, hd, hd))
    e = torch.zeros_like(st)
    out = [st.clone()]
    for i in (range(nc - 1, 0, -1) if reverse else range(nc - 1)):
        pi = p[:, :, i, :, None].expand_as(st)
        hi = pi * st
        err = (pi.double() * st.double() - hi.double()).float()
        e, st = (pi.double() * e.double() - err.double()).float(), hi
        for j in range(0, c, sub):
            d = (ap[:, :, i, j:j + sub].transpose(-1, -2)
                 @ xc[:, :, i, j:j + sub])
            y = d - e
            tv = st + y
            e, st = (tv - st) - y, tv
        out.append(st - e)
    return out[::-1] if reverse else out


def _g_ends_float64(r, w, dy):
    """G_end of every chunk but the last, dL/dS at the chunk's end, from
    the float64 plain backward's reverse recurrence (G = diag(w) G + r^T
    dy from zero at T)."""
    b, t, h, hd = r.shape
    rf, wf, df = (x.double() for x in (r, w, dy))
    g = torch.zeros((b, h, hd, hd), dtype=torch.float64)
    out = {}
    for i in range(t - 1, 0, -1):
        g = wf[:, i, :, :, None] * g + rf[:, i, :, :, None] \
            * df[:, i, :, None, :]
        if i % CHUNK == 0:
            out[i // CHUNK - 1] = g
    return [out[c] for c in range(len(out))]


def _lane_sum(terms_a, terms_b, cpt):
    """Each thread's fmaf chain over its cpt columns, then the sum over a
    row's 16 lanes as xor shuffles 8, 4, 2, 1 take it (the kernel's joint
    tree for dk, dw, dr adds the same pairs); (..., hd) -> (...)."""
    a = terms_a.reshape(*terms_a.shape[:-1], BWD_LANES, cpt)
    bb = terms_b.reshape(*terms_b.shape[:-1], BWD_LANES, cpt)
    acc = torch.zeros(a.shape[:-1])
    for c in range(cpt):
        acc = _fma(a[..., c], bb[..., c], acc)
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def _kernel_order(r, k, v, w, u, dy):
    """What wkv_bwd_state, wkv_bwd and wkv_bwd_du compute, in their order,
    in fp32 torch ops: (dr, dk, dv, dw, du).  Every chunk at once, as the
    chunk pass's grid runs them: S from the forward's chunk state and G
    from its G_end, sub-chunks of BWD_HIST / cpt steps from the last, S
    stepped forward by fmaf to each and walked back with G in plain fp32;
    dv summed over row pairs, the block's pairs, then the row tiles in
    order; du over a chunk's steps from the last, then over chunks, then
    over batch rows."""
    b, t, h, hd = r.shape
    cpt = hd // BWD_LANES
    sb, tiles, pairs = BWD_HIST // cpt, hd // BWD_ROWS, BWD_ROWS // 2
    nc = -(-t // C)
    s0 = torch.stack(_chunk_states(k, v, w), dim=2)      # (B, H, nc, hd, hd)
    g = torch.stack(_chunk_states(r, dy, w, reverse=True), dim=2)
    rf, kf, vf, wf, df = (_chunks(x, nc) for x in (r, k, v, w, dy))
    uf = u.float()[None, :, None, :, None]               # (1, H, 1, hd, 1)
    dyv = _lane_sum(df, vf, cpt)                          # (B, H, nc, C)

    def step(s, i):
        return _fma(wf[..., i, :, None], s,
                    kf[..., i, :, None] * vf[..., i, None, :])

    dr, dk, dw = (torch.zeros((b, h, nc, C, hd)) for _ in range(3))
    dvt = torch.zeros((tiles, b, h, nc, C, hd))
    dup = torch.zeros((b, h, nc, hd))
    for m in range(C // sb - 1, -1, -1):
        s = s0
        for i in range(m * sb):
            s = step(s, i)
        hist = []
        for q in range(sb):
            hist.append(s)
            if q + 1 < sb:
                s = step(s, m * sb + q)
        for q in range(sb - 1, -1, -1):
            i = m * sb + q
            ri, ki, wi = (x[..., i, :, None] for x in (rf, kf, wf))
            vv, dd = vf[..., i, None, :], df[..., i, None, :]
            gt = _fma(uf * ri, dd, g)
            dk[..., i, :] = _lane_sum(gt, vv.expand_as(gt), cpt)
            dw[..., i, :] = _lane_sum(g, hist[q], cpt)
            a_dr = _lane_sum(dd.expand_as(g), hist[q], cpt)
            dr[..., i, :] = _fma(uf[..., 0] * ki[..., 0],
                                 dyv[..., i, None], a_dr)
            dup = _fma(ri[..., 0] * ki[..., 0], dyv[..., i, None], dup)
            dvv = (gt * ki).reshape(b, h, nc, tiles, pairs, 2, hd)
            dvv = dvv[..., 0, :] + dvv[..., 1, :]
            acc = torch.zeros((b, h, nc, tiles, hd))
            for pp in range(pairs):
                acc = acc + dvv[..., pp, :]
            dvt[..., i, :] = acc.permute(3, 0, 1, 2, 4)
            g = _fma(wi, g, ri * dd)
    dv = torch.zeros((b, h, nc, C, hd))
    for tl in range(tiles):
        dv = dv + dvt[tl]
    du = torch.zeros((h, hd))
    for bb in range(b):
        s = torch.zeros((h, hd))
        for ci in range(nc):
            s = s + dup[bb, :, ci]
        du = du + s
    back = [x.reshape(b, h, nc * C, hd)[:, :, :t].permute(0, 2, 1, 3)
            .to(r.dtype) for x in (dr, dk, dv, dw)]
    return back + [du]


# max |G - G_float64| over max |G_float64| of the reverse chunk pass:
# compensated, its rounding is a few fp32 ulps of G (4.3e-7 at most over
# these cases); an uncompensated sum would drift with T where w = 1
G_TOL = 2e-6


@pytest.mark.parametrize("t", [CHUNK + 1, 150, 1030])
@pytest.mark.parametrize("regime", W_REGIMES)
def test_g_chunk_states_match_float64(regime, t):
    """The backward's reverse chunk pass (wkv_bwd_state), as the kernel
    forms it (running products E_t from each chunk's start, a compensated
    pair, (r E)^T dy joined 16 steps at a time), against G at each chunk's
    end as the float64 plain backward steps it, in every regime of w, at
    ragged T, and at T 1030 (w = 1 there: G grows with T)."""
    arrs = _inputs(2, t, 2, 32, seed=t, regime=regime)
    r, k, v, w, u, dy = _torch(arrs)
    got = _chunk_states(r, dy, w, reverse=True)
    r64, _, _, w64, _, dy64 = _torch(arrs, torch.float64)
    want = _g_ends_float64(r64, w64, dy64)
    assert len(got) == len(want) + 1 == -(-t // CHUNK)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    scale = max(float(x.abs().max()) for x in want)
    for c, (g, x) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), c
        assert float((g.double() - x).abs().max()) <= G_TOL * scale, c


@pytest.mark.parametrize("t", [1, 37, CHUNK, 150])
@pytest.mark.parametrize("regime", W_REGIMES)
def test_plain_backward_equals_autograd_in_float64(regime, t):
    """The reverse recurrence against autograd through the float64 plain
    forward, in every regime of w and at ragged T: the same function to
    float64 rounding (du to fp32 rounding: u is fp32, so autograd returns
    its gradient in fp32)."""
    args = _torch(_inputs(2, t, 3, 16, seed=t, regime=regime),
                  torch.float64)
    got = rwkv6_scan_bwd_plain(*args)
    want = _autograd(*args)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        rtol = 1e-6 if name == "du" else 1e-10
        np.testing.assert_allclose(g.numpy(), w.double().numpy(), rtol=rtol,
                                   atol=rtol * float(w.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("b,t,h,hd", SHAPES)
def test_plain_backward_matches_jax_grad_of_the_oracle(b, t, h, hd):
    """fp32 against jax.grad of rwkv6_scan_ref at the reference kernel
    test's shapes and tolerance."""
    arrs = _inputs(b, t, h, hd, seed=t + hd)
    got = rwkv6_scan_bwd_plain(*_torch(arrs))
    want = _jax_grads(*arrs)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,t,h,hd", SHAPES)
def test_kernel_order_matches_jax_grad_of_the_oracle(b, t, h, hd):
    arrs = _inputs(b, t, h, hd, seed=t + hd)
    got = _kernel_order(*_torch(arrs))
    want = _jax_grads(*arrs)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,t,h,hd", [(1, 1, 2, 16), (2, CHUNK - 1, 1, 32),
                                      (1, CHUNK + 1, 2, 64),
                                      (1, 2 * CHUNK + 5, 1, 128)])
@pytest.mark.parametrize("regime", W_REGIMES)
def test_kernel_order_matches_float64(regime, b, t, h, hd):
    """The kernel's fp32 decomposition against the float64 gradient at the
    card tests' bound (5e-5 of each gradient's max |g|): every head dim
    (1, 2, 4 or 8 columns a thread, sub-chunks of 64 down to 8 steps, one
    to eight row tiles), T off the chunks, w = 0, denormal w and w = 1."""
    arrs = _inputs(b, t, h, hd, seed=b * t + hd, regime=regime)
    got = _kernel_order(*_torch(arrs))
    want = rwkv6_scan_bwd_plain(*_torch(arrs, torch.float64))
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= TOL, name


def test_kernel_order_keeps_float64_without_decay_at_length():
    """w = 1 at T 1024: G grows with T as S does.  The compensated pair
    keeps the kernel's decomposition within 5e-5 of max |g| of float64
    (the rounding left is the per-step products'), as close as the fp32
    plain backward, which steps G in plain fp32."""
    arrs = _inputs(1, 1024, 1, 16, seed=0, regime="one")
    want = rwkv6_scan_bwd_plain(*_torch(arrs, torch.float64))
    got = _kernel_order(*_torch(arrs))
    plain = rwkv6_scan_bwd_plain(*_torch(arrs))
    for name, g, p, w in zip(NAMES, got, plain, want):
        assert _rel(g, w) <= TOL, name
        assert _rel(g, w) <= max(2 * _rel(p, w), 1e-6), name


def test_function_on_the_cpu_runs_the_plain_backward():
    """Grad mode on a CPU tensor goes through Rwkv6ScanFn: the forward is
    the plain version and the backward rwkv6_scan_bwd_plain, with no
    kernel launch; every input's gradient comes back in its dtype."""
    r, k, v, w, u, dy = _torch(_inputs(2, 70, 2, 16, seed=1))
    xs = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
    before = (rwkv6_scan.launches, rwkv6_scan_bwd.launches)
    y = rwkv6_scan(*xs)
    assert isinstance(y.grad_fn, Rwkv6ScanFn._backward_cls)
    assert torch.equal(y.detach(), rwkv6_scan_plain(r, k, v, w, u))
    grads = torch.autograd.grad(y, xs, dy)
    want = rwkv6_scan_bwd_plain(r, k, v, w, u, dy)
    for name, g, x, wt in zip(NAMES, grads, xs, want):
        assert g.dtype == x.dtype, name
        assert torch.equal(g, wt.to(x.dtype)), name
    assert (rwkv6_scan.launches, rwkv6_scan_bwd.launches) == before
    got = rwkv6_scan_bwd(r, k, v, w, u, dy, None)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    # no grad wanted: no Function
    assert rwkv6_scan(r, k, v, w, u).grad_fn is None


def test_backward_wrapper_checks_dy():
    r, k, v, w, u, dy = _torch(_inputs(1, 8, 2, 16, seed=2))
    with pytest.raises(ValueError, match="dy must be"):
        rwkv6_scan_bwd(r, k, v, w, u, dy[:, :4], None)
    with pytest.raises(ValueError, match="dy must be"):
        rwkv6_scan_bwd(r, k, v, w, u, dy.double(), None)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan_bwd(r, k, v, w, u,
                       dy.transpose(1, 2).contiguous().transpose(1, 2), None)


def test_backward_cost():
    """rwkv6-7b's training shape (B 1, T 4096, H 64, hd 64), fp32: 604 MB
    (0.180 ms at 3.35 TB/s) and 15.3 GFLOP (0.228 ms at 67 TFLOP/s)."""
    ops, nbytes = rwkv6_scan_bwd_cost(1, 4096, 64, 64, 4)
    assert ops == 4096 * 64 * (14 * 64 * 64 + 16 * 64)
    assert nbytes == 9 * 4096 * 64 * 64 * 4 + 2 * 64 * 64 * 4
    assert abs(nbytes / 1e6 - 604.0) < 0.1
    assert abs(ops / 67e12 * 1e3 - 0.228) < 0.001
