"""ssm_scan's gradient: the plain backward against autograd through the
plain forward in float64 and against ``jax.grad`` of the reference's
oracle in fp32; a torch-op copy of the CUDA backward kernels'
decomposition held to both; the checkpoints the forward keeps; the
autograd Function on the CPU.

The CUDA backward (``ssm_bwd``, ``ssm_bwd_reduce`` in ``ssm_scan.cu``)
starts each BWD_C-step chunk from the checkpoint the saving forward wrote,
recomputes the chunk's states and decays and walks back.
:func:`_kernel_order` repeats it in torch ops: h stepped as the forward
steps it (x = dt*A, expf, h = fmaf(e, h, B*(dt*u))), each e taken in the
sub-chunk's history and used again in its reverse step, each lane's fmaf
chains over its BWD_SPT states (G.B, A (e h G), dt (e h G), and ddt's
part u G.B + A (e h G)) joined by the xor shuffles' tree, the dB and dC
terms summed over a warp's channels by the shuffles' halving tree, then
the block's warps in order and the blocks' partials in order, dA over t
and then over b.  Its constants are read from the source."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan import (SsmScanFn, ssm_scan, ssm_scan_bwd,
                                          ssm_scan_bwd_cost,
                                          ssm_scan_bwd_plain, ssm_scan_plain)
from repro_torch.kernels.ssm_scan.ops import (BWD_CHUNK, SOURCE, STATE_DIMS,
                                              _plain_states)

torch.set_num_threads(1)

_SRC = SOURCE.read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


BWD_SPT, BWD_C, BWD_SB = _const("BWD_SPT"), _const("BWD_C"), _const("BWD_SB")
# threads a block at each N (STATE_DIMS' order)
BWD_THREADS = tuple(int(x) for x in re.search(
    r"constexpr int BWD_THREADS\[\] = \{([\d, ]+)\};", _SRC).group(1)
    .split(","))

# the reference kernel tests' tolerance (tests/test_kernels.py)
TOL = 5e-5
# tests/test_kernels.py::test_ssm_scan's shapes (B, T, D, N)
SHAPES = [(2, 64, 32, 8), (1, 128, 64, 16), (2, 32, 16, 4)]
REGIMES = ("test", "model", "long")
NAMES = ("du", "ddt", "da", "db", "dc")


def _inputs(b, t, d, n, seed, regime="test"):
    """numpy fp32 (u, dt, a, b, c, dy).  "test": as the reference test
    draws them, dt ~ U(0.001, 0.1), A = -U(0.5, 2); "model": dt =
    softplus(N(0, 1)) and A = -(1..N), as init_mamba gives; "long": dt
    0.001 and A -0.5 (a memory of ~2,000 steps)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, d))
    bm = rng.standard_normal((b, t, n))
    cm = rng.standard_normal((b, t, n))
    dy = rng.standard_normal((b, t, d))
    if regime == "test":
        dt = rng.uniform(0.001, 0.1, (b, t, d))
        a = -rng.uniform(0.5, 2.0, (d, n))
    elif regime == "model":
        dt = np.log1p(np.exp(rng.standard_normal((b, t, d))))
        a = -np.tile(np.arange(1, n + 1), (d, 1))
    else:
        dt = np.full((b, t, d), 0.001)
        a = np.full((d, n), -0.5)
    return [x.astype(np.float32) for x in (u, dt, a, bm, cm, dy)]


def _torch(arrs, dtype=torch.float32):
    u, dt, a, bm, cm, dy = (torch.tensor(x) for x in arrs)
    return [u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype),
            dy.to(dtype)]


def _autograd(u, dt, a, b, c, dy):
    xs = [x.clone().requires_grad_(True) for x in (u, dt, a, b, c)]
    with torch.enable_grad():
        y = ssm_scan_plain(*xs)
        return torch.autograd.grad(y, xs, dy)


def _jax_grads(u, dt, a, b, c, dy):
    """jax.grad (a vjp) of ssm_scan_ref on numpy fp32 inputs."""
    _, vjp = jax.vjp(ssm_scan_ref, *(jnp.asarray(x) for x in (u, dt, a, b, c)))
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


def _lanes(x, g):
    """The sum over a channel's g lanes as xor shuffles 1, 2, 4, ... take
    it; (..., g) -> (...)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _tree(x):
    """The sum over the last axis as the shuffles' halving tree takes it:
    element c joined with c + half, half = size / 2, size / 4, ..."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _kernel_order(u, dt, a, b, c, dy):
    """What the backward kernels compute, in their order, in fp32 torch
    ops, from the checkpoints the saving forward steps to: (du, ddt, da,
    db, dc)."""
    bsz, t, d = u.shape
    n = a.shape[1]
    g = n // BWD_SPT                                      # lanes a channel
    nt = BWD_THREADS[STATE_DIMS.index(n)]
    cb, cw, nw = nt // g, 32 // g, nt // 32       # channels a block, a warp
    nblk = -(-d // cb)
    uf, dtf, bf, cf, df = (x.float() for x in (u, dt, b, c, dy))
    av = a.float()[None]                                  # (1, D, N)

    def step(h, i):
        dtv = dtf[:, i, :, None]
        du = dtv * uf[:, i, :, None]
        return _fma(torch.exp(dtv * av), h, bf[:, i, None, :] * du)

    def lanes(x):                          # (B, D, N) -> (B, D, g, BWD_SPT)
        return x.expand(bsz, d, n).reshape(bsz, d, g, BWD_SPT)

    nc = -(-t // BWD_C)
    h = torch.zeros((bsz, d, n))
    saved = [h]                            # the saving forward's checkpoints
    for i in range(t):
        h = step(h, i)
        if (i + 1) % BWD_C == 0:
            saved.append(h)
    gr = torch.zeros((bsz, d, n))
    da = torch.zeros((bsz, d, n))
    du_o, ddt_o = torch.zeros((bsz, t, d)), torch.zeros((bsz, t, d))
    xb, xc = torch.zeros((bsz, t, d, n)), torch.zeros((bsz, t, d, n))
    for ch in range(nc - 1, -1, -1):
        t0 = ch * BWD_C
        starts, h = [], saved[ch]
        for m in range(BWD_C // BWD_SB):
            starts.append(h)
            for q in range(BWD_SB):
                if t0 + m * BWD_SB + q < t:
                    h = step(h, t0 + m * BWD_SB + q)
        for m in range(BWD_C // BWD_SB - 1, -1, -1):
            ts0 = t0 + m * BWD_SB
            if ts0 >= t:
                continue
            hist, decay = [starts[m]], []
            for q in range(BWD_SB):
                i = ts0 + q
                if i < t:
                    decay.append(torch.exp(dtf[:, i, :, None] * av))
                    hist.append(_fma(decay[-1], hist[-1],
                                     bf[:, i, None, :]
                                     * (dtf[:, i, :, None]
                                        * uf[:, i, :, None])))
            for q in range(len(decay) - 1, -1, -1):
                i = ts0 + q
                dtv, uv, dyv = (x[:, i, :, None] for x in (dtf, uf, df))
                bv, cv = bf[:, i, None, :], cf[:, i, None, :]
                e = decay[q]
                gr = _fma(dyv, cv, gr)
                xb[:, i] = gr * (dtv * uv)
                xc[:, i] = dyv * hist[q + 1]
                y = gr * (e * hist[q])
                gb = torch.zeros((bsz, d, g))
                ga = torch.zeros((bsz, d, g))
                grl, bl, yl, al = (lanes(x) for x in (gr, bv, y, av))
                for j in range(BWD_SPT):
                    gb = _fma(grl[..., j], bl[..., j], gb)
                    ga = _fma(al[..., j], yl[..., j], ga)
                dp = _fma(uv.expand(bsz, d, g), gb, ga)
                du_o[:, i] = dtv[..., 0] * _lanes(gb, g)
                ddt_o[:, i] = _lanes(dp, g)
                da = _fma(dtv, y, da)
                gr = e * gr
    # a warp's channels by the halving tree, the block's warps in order
    # (zeros past D), then the blocks in order
    pad = nblk * cb - d

    def blocks(x):                         # (B, T, D, N) -> (B, T, N)
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        x = x.reshape(bsz, t, nblk, nw, cw, n)
        x = _tree(x.transpose(-1, -2))                  # (B, T, nblk, nw, N)
        part = x[:, :, :, 0]
        for w in range(1, nw):
            part = part + x[:, :, :, w]
        out = part[:, :, 0]
        for k in range(1, nblk):
            out = out + part[:, :, k]
        return out
    da_s = da[0]
    for bb in range(1, bsz):
        da_s = da_s + da[bb]
    return (du_o.to(u.dtype), ddt_o.to(u.dtype), da_s,
            blocks(xb).to(u.dtype), blocks(xc).to(u.dtype))


def test_block_layout_read_from_the_source():
    """One thread a block at each N keeps BWD_SPT states; 128 channels a
    block at N 4-16 (the jamba shape's 16,384 channels: 128 blocks, one an
    SM), a warp a multiple of the channel's lanes."""
    assert len(BWD_THREADS) == len(STATE_DIMS)
    for n, nt in zip(STATE_DIMS, BWD_THREADS):
        g = n // BWD_SPT
        assert nt % 32 == 0 and 32 % g == 0, n
        if n <= 16:
            assert nt // g == 128, n
    assert BWD_C == BWD_CHUNK and BWD_C % BWD_SB == 0


@pytest.mark.parametrize("t", [1, 37, BWD_CHUNK, 150])
@pytest.mark.parametrize("regime", REGIMES)
def test_plain_backward_equals_autograd_in_float64(regime, t):
    """The reverse recurrence against autograd through the float64 plain
    forward, in every regime of dt and A and at ragged T: the same
    function to float64 rounding (da to fp32 rounding: A is fp32, so
    autograd returns its gradient in fp32)."""
    args = _torch(_inputs(2, t, 7, 8, seed=t, regime=regime), torch.float64)
    got = ssm_scan_bwd_plain(*args)
    want = _autograd(*args)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        rtol = 1e-6 if name == "da" else 1e-10
        np.testing.assert_allclose(g.numpy(), w.double().numpy(), rtol=rtol,
                                   atol=rtol * float(w.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("b,t,d,n", SHAPES)
def test_plain_backward_matches_jax_grad_of_the_oracle(b, t, d, n):
    """fp32 against jax.grad of ssm_scan_ref at the reference kernel
    test's shapes and tolerance."""
    arrs = _inputs(b, t, d, n, seed=t + d)
    got = ssm_scan_bwd_plain(*_torch(arrs))
    want = _jax_grads(*arrs)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,t,d,n", SHAPES)
def test_kernel_order_matches_jax_grad_of_the_oracle(b, t, d, n):
    arrs = _inputs(b, t, d, n, seed=t + d)
    got = _kernel_order(*_torch(arrs))
    want = _jax_grads(*arrs)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n", STATE_DIMS)
@pytest.mark.parametrize("regime", REGIMES)
def test_kernel_order_matches_float64(regime, n):
    """The kernels' fp32 decomposition against the float64 gradient at the
    card tests' bound (5e-5 of each gradient's max |g|): every N (1 to 16
    lanes a channel, 128 to 8 channels a block), T off the 64-step chunks
    and the 8-step sub-chunks, D off the block's channels, B 2."""
    arrs = _inputs(2, 2 * BWD_C + 13, 137, n, seed=n, regime=regime)
    got = _kernel_order(*_torch(arrs))
    want = ssm_scan_bwd_plain(*_torch(arrs, torch.float64))
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= TOL, name


# how far the fp32 backward lies from float64 at T 4096, as a share of
# each gradient's max |g|.  In "long" (e = exp(-0.0005), a ~2,000-step
# memory) fp32's rounding of each decay compounds over the memory: the fp32
# plain backward and the kernels' decomposition both leave float64 by up
# to 7.2e-5 (dA; 2.7e-5 to 3.7e-5 for the rest) at D 8, N 16, though they
# agree with each other to 2e-6.  So there the card tests hold the kernel
# to the fp32 plain version at 5e-5 and to float64 at this pinned bound.
FP32_REL = {"test": TOL, "model": TOL, "long": 1e-4}


@pytest.mark.parametrize("regime", REGIMES)
def test_fp32_backward_against_float64_at_length(regime):
    """T 4096 (the jamba training shape's), D 8, N 16: the fp32 plain
    backward and the kernels' decomposition stay within FP32_REL of
    float64 and within 5e-5 of each other, in every regime."""
    arrs = _inputs(1, 4096, 8, 16, seed=0, regime=regime)
    want = ssm_scan_bwd_plain(*_torch(arrs, torch.float64))
    plain = ssm_scan_bwd_plain(*_torch(arrs))
    got = _kernel_order(*_torch(arrs))
    for name, g, p, w in zip(NAMES, got, plain, want):
        assert _rel(p, w) <= FP32_REL[regime], name
        assert _rel(g, w) <= FP32_REL[regime], name
        assert _rel(g, p) <= TOL, name
    if regime == "long":               # the pin is not looser than needed
        assert max(_rel(p, w) for p, w in zip(plain, want)) > TOL


def test_function_on_the_cpu_runs_the_plain_backward():
    """Grad mode on a CPU tensor goes through SsmScanFn: the forward is the
    plain version and the backward ssm_scan_bwd_plain, with no kernel
    launch; every input's gradient comes back in its dtype."""
    u, dt, a, bm, cm, dy = _torch(_inputs(2, 70, 9, 8, seed=1))
    xs = [x.clone().requires_grad_(True) for x in (u, dt, a, bm, cm)]
    before = (ssm_scan.launches, ssm_scan_bwd.launches)
    y = ssm_scan(*xs)
    assert isinstance(y.grad_fn, SsmScanFn._backward_cls)
    assert torch.equal(y.detach(), ssm_scan_plain(u, dt, a, bm, cm))
    grads = torch.autograd.grad(y, xs, dy)
    want = ssm_scan_bwd_plain(u, dt, a, bm, cm, dy)
    for name, g, x, wt in zip(NAMES, grads, xs, want):
        assert g.dtype == x.dtype, name
        assert torch.equal(g, wt.to(x.dtype)), name
    assert (ssm_scan.launches, ssm_scan_bwd.launches) == before
    got = ssm_scan_bwd(u, dt, a, bm, cm, dy)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    assert ssm_scan(u, dt, a, bm, cm).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t", [1, 63, BWD_CHUNK, BWD_CHUNK + 1, 150, 200])
def test_plain_states_equal_the_backward_stepping(t, dtype):
    """The checkpoints ssm_scan_plain returns are the ones
    ssm_scan_bwd_plain steps when given none, bit for bit: h after every
    BWD_CHUNK steps but the last, (B, ceil(T / 64) - 1, D, N)."""
    u, dt, a, bm, cm, _ = _torch(_inputs(2, t, 9, 8, seed=t, regime="model"),
                                 dtype)
    y, states = ssm_scan_plain(u, dt, a, bm, cm, states=True)
    assert torch.equal(y, ssm_scan_plain(u, dt, a, bm, cm))
    assert states.shape == (2, -(-t // BWD_CHUNK) - 1, 9, 8)
    assert states.dtype == dtype
    own = _plain_states(u, dt, a.to(dtype), bm)
    assert torch.equal(states, own)


@pytest.mark.parametrize("regime", REGIMES)
def test_plain_backward_with_and_without_states(regime):
    """ssm_scan_bwd_plain from the forward's checkpoints equals the one
    that steps them itself, bit for bit (fp32 and float64)."""
    for dtype in (torch.float32, torch.float64):
        u, dt, a, bm, cm, dy = _torch(_inputs(2, 150, 11, 16, seed=3,
                                              regime=regime), dtype)
        _, states = ssm_scan_plain(u, dt, a, bm, cm, states=True)
        with_states = ssm_scan_bwd_plain(u, dt, a, bm, cm, dy, states=states)
        without = ssm_scan_bwd_plain(u, dt, a, bm, cm, dy)
        for name, x, y in zip(NAMES, with_states, without):
            assert torch.equal(x, y), (name, dtype)
        got = ssm_scan_bwd(u, dt, a, bm, cm, dy, states=states)
        assert all(torch.equal(x, y) for x, y in zip(got, without))


@pytest.mark.parametrize("t", [1, 70, 150])
def test_function_on_the_cpu_equals_autograd(t):
    """SsmScanFn on the CPU (forward keeps the plain checkpoints, backward
    ssm_scan_bwd_plain from them) against autograd through
    ssm_scan_plain, in float64."""
    u, dt, a, bm, cm, dy = _torch(_inputs(2, t, 7, 8, seed=t, regime="model"),
                                  torch.float64)
    xs = [x.clone().requires_grad_(True) for x in (u, dt, a, bm, cm)]
    y = ssm_scan(*xs)
    assert isinstance(y.grad_fn, SsmScanFn._backward_cls)
    got = torch.autograd.grad(y, xs, dy)
    want = _autograd(u, dt, a, bm, cm, dy)
    for name, g, w in zip(NAMES, got, want):
        rtol = 1e-6 if name == "da" else 1e-10
        np.testing.assert_allclose(g.double().numpy(), w.double().numpy(),
                                   rtol=rtol,
                                   atol=rtol * float(w.abs().max()),
                                   err_msg=name)


def test_backward_checks_states():
    """states must be the forward's checkpoints: shape, dtype, device and
    layout are checked before anything runs."""
    u, dt, a, bm, cm, dy = _torch(_inputs(1, 150, 6, 8, seed=4))
    _, states = ssm_scan_plain(u, dt, a, bm, cm, states=True)
    assert states.shape == (1, 2, 6, 8)
    bad = {"shape": states[:, :1].contiguous(),
           "dtype": states.double(),
           "device": torch.empty(states.shape, device="meta"),
           "layout": states.transpose(2, 3).contiguous().transpose(2, 3),
           "type": states.tolist()}
    for what, x in bad.items():
        with pytest.raises(ValueError, match="checkpoints"):
            ssm_scan_bwd(u, dt, a, bm, cm, dy, states=x)
        with pytest.raises(ValueError, match="checkpoints"):
            ssm_scan_bwd_plain(u, dt, a, bm, cm, dy, states=x)
    # float64 inputs take float64 checkpoints on the CPU
    args64 = [x.double() if x is not a else x for x in (u, dt, a, bm, cm)]
    _, s64 = ssm_scan_plain(*args64, states=True)
    assert s64.dtype == torch.float64
    ssm_scan_bwd(*args64, dy.double(), states=s64)
    with pytest.raises(ValueError, match="checkpoints"):
        ssm_scan_bwd(*args64, dy.double(), states=states)


def test_backward_wrapper_checks_dy():
    u, dt, a, bm, cm, dy = _torch(_inputs(1, 8, 4, 8, seed=2))
    with pytest.raises(ValueError, match="dy must be"):
        ssm_scan_bwd(u, dt, a, bm, cm, dy[:, :4])
    with pytest.raises(ValueError, match="dy must be"):
        ssm_scan_bwd(u, dt, a, bm, cm, dy.double())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_bwd(u, dt, a, bm, cm,
                     dy.transpose(1, 2).contiguous().transpose(1, 2))


def test_backward_cost():
    """jamba-1.5-large's training shape (B 1, T 4096, D 16384, N 16), fp32:
    1.345 GB (0.402 ms at 3.35 TB/s), 23.8 GFLOP, 1.07 G exps."""
    ops, nbytes, exps = ssm_scan_bwd_cost(1, 4096, 16384, 16, 4)
    assert ops == 4096 * 16384 * (22 * 16 + 2)
    assert nbytes == (5 * 4096 * 16384 + 4 * 4096 * 16) * 4 + 2 * 16384 * 16 * 4
    assert abs(nbytes / 1e9 - 1.345) < 0.001
    assert abs(ops / 1e9 - 23.76) < 0.01
    assert exps == 4096 * 16384 * 16
