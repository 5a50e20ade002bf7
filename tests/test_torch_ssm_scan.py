"""ssm_scan's plain PyTorch version against the reference kernel
(interpret mode) and its oracle, at the reference's own kernel tolerances
(5e-5 fp32, 5e-2 bf16, tests/test_kernels.py); a torch-op copy of the CUDA
kernel's order of operations held to the same and to the float64
recurrence in three regimes of dt and A; the wrapper's checks; and the
model's Mamba block (kernel path and carried-state path) against the
reference's."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as j_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro.models import ssm as JS
from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_cost,
                                          ssm_scan_plain)
from repro_torch.kernels.ssm_scan.ops import SOURCE, STATE_DIMS
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 5e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
# tests/test_kernels.py::test_ssm_scan's shapes: (b, t, d, n, block_t,
# block_d)
SHAPES = [(2, 64, 32, 8, 16, 16), (1, 128, 64, 16, 64, 32),
          (2, 32, 16, 4, 32, 16)]


def _inputs(b, t, d, n, seed):
    """As the reference test draws them: dt ~ U(0.001, 0.1), A = -U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, d)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, t, d)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (d, n)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    return u, dt, a, bm, cm


def _torch(args, dtype):
    u, dt, a, bm, cm = (torch.tensor(x) for x in args)
    return u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,n,bt,bd", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(b, t, d, n, bt, bd, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    args = _inputs(b, t, d, n, seed=t + d)
    ju, jdt_, ja, jb, jc = (jnp.asarray(x, jdt) for x in args)
    ja = jnp.asarray(args[2])
    kern = j_scan(ju, jdt_, ja, jb, jc, block_t=bt, block_d=bd,
                  interpret=True)
    ref = ssm_scan_ref(ju, jdt_, ja, jb, jc)
    targs = _torch(args, tdt)
    out = ssm_scan_plain(*targs)
    assert out.dtype == tdt and out.shape == (b, t, d)
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)
    before = ssm_scan.launches
    assert torch.equal(ssm_scan(*targs), out)
    assert ssm_scan.launches == before


# states a lane of the CUDA kernel keeps (its build default)
SPT = int(re.search(r"constexpr int SPT_MAX = (\d+);",
                    SOURCE.read_text()).group(1))


def _fma(x, y, z):
    """fp32 fmaf: the product is exact in float64, one rounding there and
    one to fp32 (a double rounding that differs from fmaf only on exact
    ties of the float64 sum)."""
    return (x.double() * y.double() + z.double()).float()


def _kernel_order(u, dt, a, b, c, spt=SPT):
    """What ssm_scan.cu computes, in its order, in torch ops: per step
    x = dt*A, e = exp(x), du = dt*u and h = fmaf(e, h, B*du) in fp32; y
    summed over each lane's `spt` states in state order by fmaf from 0,
    then the G = N / spt lanes joined as the xor shuffles join them
    (lane ^ 1, then ^ 2, ...); y in u's dtype."""
    uf, dtf, bf, cf = (x.float() for x in (u, dt, b, c))
    bsz, t, d = u.shape
    n = a.shape[1]
    s = min(n, spt)
    g = n // s
    lanes = torch.arange(g)
    h = torch.zeros((bsz, d, n))
    ys = []
    for i in range(t):
        dtv = dtf[:, i]
        e = torch.exp(dtv[..., None] * a)
        du = dtv * uf[:, i]
        h = _fma(e, h, bf[:, i, None, :] * du[..., None])
        hl = h.view(bsz, d, g, s)
        cl = cf[:, i, None, :].expand(bsz, d, n).reshape(bsz, d, g, s)
        acc = torch.zeros((bsz, d, g))
        for k in range(s):
            acc = _fma(cl[..., k], hl[..., k], acc)
        off = 1
        while off < g:
            acc = acc + acc[..., lanes ^ off]
            off <<= 1
        ys.append(acc[..., 0])
    return torch.stack(ys, dim=1).to(u.dtype)


def _regime(kind, b, t, d, n, seed=0):
    """fp32 inputs: "test" as the reference test draws dt and A; "model":
    dt = softplus(N(0, 1)) and A = -(1..N), as init_mamba's dt_bias 0 and
    A_log = log(1..N) give; "long": dt 0.001 and A -0.5 (decay 0.9995, a
    memory of ~2,000 steps)."""
    if kind == "test":
        return list(_torch(_inputs(b, t, d, n, seed), torch.float32))
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, d)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    if kind == "model":
        dt = np.log1p(np.exp(rng.standard_normal((b, t, d)))) \
            .astype(np.float32)
        a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    else:
        dt = np.full((b, t, d), 0.001, np.float32)
        a = np.full((d, n), -0.5, np.float32)
    return [torch.tensor(x) for x in (u, dt, a, bm, cm)]


def _share(got, want, tol):
    """Largest |got - want| / (tol + tol |want|): the share of the
    tolerance (assert_allclose passes at <= 1)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,d,n,bt,bd", SHAPES)
def test_kernel_order_matches_reference_kernel_and_oracle(b, t, d, n, bt, bd,
                                                          dtype):
    jdt, tdt, tol = DTYPES[dtype]
    args = _inputs(b, t, d, n, seed=t + d)
    ju, jdt_, ja, jb, jc = (jnp.asarray(x, jdt) for x in args)
    ja = jnp.asarray(args[2])
    kern = j_scan(ju, jdt_, ja, jb, jc, block_t=bt, block_d=bd,
                  interpret=True)
    ref = ssm_scan_ref(ju, jdt_, ja, jb, jc)
    out = _kernel_order(*_torch(args, tdt))
    assert out.dtype == tdt and out.shape == (b, t, d)
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n", STATE_DIMS)
def test_kernel_order_every_state_dim(n):
    """Every N the kernel takes (1, 2, 4 or 8 lanes a channel at SPT 8),
    at a ragged T and D, against the oracle and the float64 recurrence."""
    args = _inputs(2, 37, 19, n, seed=n)
    got = _kernel_order(*_torch(args, torch.float32))
    want = ssm_scan_ref(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    w64 = ssm_scan_plain(*(torch.tensor(x).double() if x.ndim == 3
                           else torch.tensor(x) for x in args))
    assert _share(got, w64, 5e-5) <= 1.0


# how far the fp32 recurrence lies from float64 at T 4096, as a share of
# the 5e-5 tolerance: the kernel's card tests hold it against the fp32
# plain version in the first two regimes and against float64 in "long",
# where the fp32 recurrence itself moves (0.30 of the tolerance here)
FP32_SHARE = {"test": 0.1, "model": 0.2, "long": 0.6}


@pytest.mark.parametrize("regime", list(FP32_SHARE))
def test_fp32_recurrence_against_float64(regime):
    args = _regime(regime, 1, 4096, 8, 16)
    w64 = ssm_scan_plain(*(x.double() if x.dim() == 3 else x for x in args))
    plain = ssm_scan_plain(*args)
    kernel = _kernel_order(*args)
    assert _share(plain, w64, 5e-5) <= FP32_SHARE[regime]
    assert _share(kernel, w64, 5e-5) <= FP32_SHARE[regime]
    assert _share(kernel, plain, 5e-5) <= 0.1


@pytest.mark.parametrize("b,t,d,n", [(2, 37, 19, 16), (1, 5, 3, 4)])
def test_plain_ragged_matches_oracle(b, t, d, n):
    """T and D that the TPU kernel's blocks would not divide."""
    args = _inputs(b, t, d, n, seed=b * t + d)
    want = ssm_scan_ref(*(jnp.asarray(x) for x in args))
    got = ssm_scan(*_torch(args, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    u, dt, a, bm, cm = _torch(_inputs(1, 4, 8, 8, seed=3), torch.float32)
    with pytest.raises(ValueError, match="u and dt"):
        ssm_scan(u, dt[:, :3], a, bm, cm)
    with pytest.raises(ValueError, match="a must be"):
        ssm_scan(u, dt, a[:4], bm, cm)
    with pytest.raises(ValueError, match="b and c"):
        ssm_scan(u, dt, a, bm[:, :, :4], cm)
    with pytest.raises(ValueError, match="state dim"):
        ssm_scan(u, dt, a[:, :6].contiguous(), bm[..., :6].contiguous(),
                 cm[..., :6].contiguous())
    with pytest.raises(TypeError, match="float32"):
        ssm_scan(u, dt, a.double(), bm, cm)
    with pytest.raises(TypeError, match="share"):
        ssm_scan(u.double(), dt, a, bm, cm)
    with pytest.raises(TypeError, match="share"):
        ssm_scan(u.half(), dt.half(), a, bm.half(), cm.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(u.transpose(1, 2).contiguous().transpose(1, 2), dt, a,
                 bm, cm)
    with pytest.raises(ValueError, match="different devices"):
        ssm_scan(u, dt, a.to("meta"), bm, cm)
    with pytest.raises(ValueError, match="unsupported device"):
        ssm_scan(*(x.to("meta") for x in (u, dt, a, bm, cm)))
    # float64 takes the plain version on the CPU (the tests' witness)
    assert ssm_scan(*(x.double() if x is not a else x
                      for x in (u, dt, a, bm, cm))).dtype == torch.float64


def test_cost():
    """jamba-1.5-large's prefill shape (B 1, T 4096, D 16384, N 16), fp32."""
    ops, nbytes, exps = ssm_scan_cost(1, 4096, 16384, 16, 4)
    assert ops == 4096 * 16384 * (6 * 16 + 1)                # ~6.5 GFLOP
    assert nbytes == (3 * 4096 * 16384 + 2 * 4096 * 16) * 4 + 16384 * 16 * 4
    assert abs(nbytes / 1e6 - 806.9) < 0.1
    assert exps == 4096 * 16384 * 16                         # ~1.07 G


def _mamba_pair(d_model=32, d_state=8, d_conv=4, seed=0):
    jp = JS.init_mamba(jax.random.key(seed), d_model, d_state, d_conv,
                       dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    # non-trivial dt_bias, A_log and D, so each term is exercised
    jp = dict(jp, dt_bias=jnp.asarray(rng.uniform(-1, 1, 2 * d_model),
                                      jnp.float32),
              A_log=jnp.asarray(rng.uniform(-1, 2, (2 * d_model, d_state)),
                                jnp.float32),
              D=jnp.asarray(rng.standard_normal(2 * d_model), jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(2 * d_model) * 0.1,
                                 jnp.float32))
    p = TS.Mamba(d_model, d_state, d_conv, device="cpu")
    flat = {"in_proj.w": jp["in_proj"]["w"], "x_proj.w": jp["x_proj"]["w"],
            "out_proj.w": jp["out_proj"]["w"],
            **{k: jp[k] for k in ("conv_w", "conv_b", "dt_bias", "A_log",
                                  "D")}}
    p.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in flat.items()}, strict=True)
    return jp, p


def test_mamba_block_forward_matches_reference():
    """No state: the port's scan is ssm_scan (its plain version here) plus
    D * u outside the kernel."""
    jp, p = _mamba_pair()
    x = np.random.default_rng(1).standard_normal((2, 23, 32)) \
        .astype(np.float32)
    with jax.disable_jit():
        want, _ = JS.mamba_block(jp, jnp.asarray(x))
    got, st = TS.mamba_block(p, torch.tensor(x))
    assert st["h"] is None and st["conv"].shape == (2, 3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("steps", [1, 5])
def test_mamba_block_with_a_carried_state_matches_reference(steps):
    jp, p = _mamba_pair(seed=2)
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((2, 64, 8)).astype(np.float32)
    conv0 = rng.standard_normal((2, 3, 64)).astype(np.float32)
    x = rng.standard_normal((2, steps, 32)).astype(np.float32)
    with jax.disable_jit():
        want, jst = JS.mamba_block(jp, jnp.asarray(x),
                                   {"h": jnp.asarray(h0),
                                    "conv": jnp.asarray(conv0)})
    got, st = TS.mamba_block(p, torch.tensor(x),
                             {"h": torch.tensor(h0),
                              "conv": torch.tensor(conv0)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-4, atol=1e-5)


def test_zero_state_scan_equals_the_kernel_function():
    """_selective_scan from a zero state, less D*u, computes what the
    kernel computes (the model's forward takes the kernel, decode takes
    _selective_scan)."""
    u, dt, a, bm, cm = _torch(_inputs(2, 29, 12, 8, seed=4), torch.float32)
    d = torch.tensor(np.random.default_rng(5).standard_normal(12),
                     dtype=torch.float32)
    y, h = TS._selective_scan(u, dt, a, bm, cm, d)
    assert h.shape == (2, 12, 8)
    np.testing.assert_allclose((y - d * u).numpy(),
                               ssm_scan_plain(u, dt, a, bm, cm).numpy(),
                               rtol=5e-5, atol=5e-5)
