"""ssm_scan's plain PyTorch version against the reference kernel
(interpret mode) and its oracle, at the reference's own kernel tolerances
(5e-5 fp32, 5e-2 bf16, tests/test_kernels.py); the wrapper's checks; and
the model's Mamba block (kernel path and carried-state path) against the
reference's."""
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
