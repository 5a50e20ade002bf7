"""The scans as counted ops: ``ssm_scan_counted`` and
``rwkv6_scan_counted``, one custom op forward and one backward each,
which the dry run traces inside ``models.attention.kernel_route`` where
the plain recurrences would be traced one time step at a time.

At T 130 (two whole 64-step chunks and a ragged 2), in a no-grad forward
and a forward with its backward, counted by ``dryrun.Counter`` on fake
CPU tensors (no process group is needed for plain tensors): the ops'
FLOPs equal the step-by-step trace's exactly, their bytes are their
inputs' and outputs', and the step-by-step trace moves and holds no
less.  The fake outputs are the card's: ssm's checkpoints (B, ceil(T /
64) - 1, D, N) fp32 only when a gradient is taken, rwkv6's chunk-state
workspace (B, H, ceil(T / 64) - 1, hd, hd) fp32 on every call.  On real
tensors seeded with numpy the ops' values and gradients are the wrapper's
CPU route's bit for bit, and are held to the JAX package's
``ssm_scan_ref`` / ``rwkv6_scan_ref`` (and ``jax.grad`` of them) at the
tolerances of the scans' parity tests (5e-5 fp32).  A model traced
outside ``kernel_route`` runs no counted op; inside it each scan is one,
and the loss and gradients are the same bit for bit.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.configs import get_arch
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_counted
from repro_torch.kernels.rwkv6_scan import ops as RO
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_counted
from repro_torch.launch.dryrun import Counter
from repro_torch.models import build_model
from repro_torch.models.attention import kernel_route

torch.set_num_threads(1)

T = 130                        # two whole 64-step chunks and a ragged 2
N_CK = 2                       # ceil(130 / 64) - 1 checkpoints
TOL = 5e-5                     # the scans' parity tests' fp32 tolerance
SSM = (2, T, 8, 16)            # (B, T, D, N)
RWKV = (2, T, 2, 16)           # (B, T, H, hd)
SCANS = {"ssm": (ssm_scan, ssm_scan_counted),
         "rwkv6": (rwkv6_scan, rwkv6_scan_counted)}


def _ssm_inputs(seed):
    """numpy fp32 (u, dt, a, b, c, dy) in the model's regime: dt =
    softplus(N(0, 1)), A = -(1..N)."""
    b, t, d, n = SSM
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, d))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, d))))
    a = -np.tile(np.arange(1, n + 1), (d, 1))
    bm, cm = (rng.standard_normal((b, t, n)) for _ in range(2))
    dy = rng.standard_normal((b, t, d))
    return [x.astype(np.float32) for x in (u, dt, a, bm, cm, dy)]


def _rwkv_inputs(seed):
    """numpy fp32 (r, k, v, w, u, dy): r, k, v ~ 0.5 N(0, 1), w ~ U(0.3,
    0.99) as the reference's tests draw it, u ~ 0.1 N(0, 1)."""
    b, t, h, hd = RWKV
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd)) * 0.5 for _ in range(3))
    w = rng.uniform(0.3, 0.99, (b, t, h, hd))
    u = rng.standard_normal((h, hd)) * 0.1
    dy = rng.standard_normal((b, t, h, hd))
    return [x.astype(np.float32) for x in (r, k, v, w, u, dy)]


INPUTS = {"ssm": _ssm_inputs, "rwkv6": _rwkv_inputs}


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _count(fn, arrs, grad: bool):
    """(flops, bytes, peak) of fn on fake tensors shaped as `arrs`' inputs
    (dy made before the count), with its backward when `grad`."""
    c = Counter()
    with c.active():
        xs = [torch.empty(x.shape).requires_grad_(grad) for x in arrs[:5]]
        dy = torch.empty(arrs[5].shape)
        with c.counting():
            y = fn(*xs)
            if grad:
                y.backward(dy)
    return c.flops, c.bytes, c.peak


def _op_bytes(scan, arrs, grad: bool) -> int:
    """The counted ops' inputs and outputs: the scan's inputs, y and the
    checkpoints / workspace forward; with the gradient, the backward's
    inputs (the forward's, dy and the checkpoints / workspace) and its
    five gradients."""
    xs = [torch.empty(x.shape) for x in arrs[:5]]
    y = torch.empty(arrs[0].shape)
    if scan == "ssm":
        b, t, d, n = SSM
        states = torch.empty((b, N_CK if grad else 0, d, n))
    else:
        b, t, h, hd = RWKV
        states = torch.empty((b, h, N_CK, hd, hd))
    fwd = _nbytes([*xs, y, states])
    if not grad:
        return fwd
    return fwd + _nbytes([*xs, y, states]) + _nbytes(xs)


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("scan", list(SCANS))
def test_counted_op_flops_equal_the_step_by_step_trace(scan, grad):
    plain, counted = SCANS[scan]
    arrs = INPUTS[scan](0)
    steps = _count(plain, arrs, grad)
    ops = _count(counted, arrs, grad)
    assert ops[0] == steps[0] > 0
    # ssm: C . h (2 B T D N) forward, dC, dB, G.B (6 B T D N) backward;
    # rwkv6: r . S (2 B T H hd^2) forward, dr, dk, dv (6 B T H hd^2)
    b, t, x, y = SSM if scan == "ssm" else RWKV
    unit = b * t * x * (y if scan == "ssm" else y * y)
    assert ops[0] == (8 if grad else 2) * unit
    assert ops[1] == _op_bytes(scan, arrs, grad)
    assert steps[1] >= ops[1] and steps[2] >= ops[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_outputs_are_what_the_card_allocates(dtype):
    """ssm: y and, only when a gradient is taken, the checkpoints (B, 2,
    D, N) fp32; rwkv6: y and the workspace (B, H, 2, hd, hd) fp32 on
    every call; the backward ops' gradients in the inputs' shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, t, d, n = SSM
    rb, rt, h, hd = RWKV
    with FakeTensorMode():
        u, dt = (torch.empty((b, t, d), dtype=dtype) for _ in range(2))
        a = torch.empty((d, n))
        bm, cm = (torch.empty((b, t, n), dtype=dtype) for _ in range(2))
        for save, ck in ((True, N_CK), (False, 0)):
            y, st = torch.ops.repro_torch.ssm_scan_fwd(u, dt, a, bm, cm, save)
            assert (y.shape, y.dtype) == (u.shape, dtype)
            assert (tuple(st.shape), st.dtype) == ((b, ck, d, n),
                                                   torch.float32)
        st = torch.empty((b, N_CK, d, n))
        grads = torch.ops.repro_torch.ssm_scan_bwd(u, dt, a, bm, cm, u, st)
        assert [(g.shape, g.dtype) for g in grads] == [
            (u.shape, dtype), (u.shape, dtype), (a.shape, torch.float32),
            (bm.shape, dtype), (cm.shape, dtype)]
        r, k, v, w = (torch.empty((rb, rt, h, hd), dtype=dtype)
                      for _ in range(4))
        uu = torch.empty((h, hd))
        y, ws = torch.ops.repro_torch.rwkv6_scan_fwd(r, k, v, w, uu)
        assert (y.shape, y.dtype) == (r.shape, dtype)
        assert (tuple(ws.shape), ws.dtype) == ((rb, h, N_CK, hd, hd),
                                               torch.float32)
        grads = torch.ops.repro_torch.rwkv6_scan_bwd(r, k, v, w, uu, r, ws)
        assert [(g.shape, g.dtype) for g in grads] == \
            [(r.shape, dtype)] * 4 + [(uu.shape, torch.float32)]


def _jax_ref(scan, arrs):
    """(y, grads) of the reference's oracle (jax.vjp) on numpy fp32."""
    if scan == "ssm":
        y, vjp = jax.vjp(ssm_scan_ref, *(jnp.asarray(x) for x in arrs[:5]))
        return np.asarray(y), [np.asarray(g) for g in
                               vjp(jnp.asarray(arrs[5]))]
    b, t, h, hd = RWKV

    def f(r, k, v, w, u):
        def fl(x):
            return x.transpose(0, 2, 1, 3).reshape(b * h, t, hd)
        uf = jnp.broadcast_to(u[None], (b, h, hd)).reshape(b * h, 1, hd)
        y = rwkv6_scan_ref(fl(r), fl(k), fl(v), fl(w), uf)
        return y.reshape(b, h, t, hd).transpose(0, 2, 1, 3)

    y, vjp = jax.vjp(f, *(jnp.asarray(x) for x in arrs[:5]))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(arrs[5]))]


@pytest.mark.parametrize("scan", list(SCANS))
def test_values_and_gradients_are_the_cpu_route_bit_for_bit(scan):
    plain, counted = SCANS[scan]
    arrs = INPUTS[scan](1)
    dy = torch.tensor(arrs[5])
    runs = {}
    for name, fn in (("route", plain), ("counted", counted)):
        xs = [torch.tensor(x).requires_grad_(True) for x in arrs[:5]]
        y = fn(*xs)
        y.backward(dy)
        with torch.no_grad():
            y0 = fn(*(torch.tensor(x) for x in arrs[:5]))
        runs[name] = (y.detach(), y0, [x.grad for x in xs])
    (y, y0, grads), (cy, cy0, cgrads) = runs["route"], runs["counted"]
    assert torch.equal(cy, y) and torch.equal(cy0, y0)
    assert all(torch.equal(g, c) for g, c in zip(grads, cgrads))
    want_y, want_g = _jax_ref(scan, arrs)
    np.testing.assert_allclose(cy.numpy(), want_y, rtol=TOL, atol=TOL)
    for g, w in zip(cgrads, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_rwkv6_chunk_states_are_the_backwards_chunk_starts():
    """The workspace the forward op returns holds the state entering
    chunks 1 and 2, as the plain backward steps them."""
    r, k, v, w, u, _ = (torch.tensor(x) for x in _rwkv_inputs(2))
    _, ws = RO.rwkv6_scan_plain(r, k, v, w, u, states=True)
    s = torch.zeros(ws.shape[:2] + ws.shape[3:])
    for i in range(T):
        if i and i % RO.CHUNK == 0:
            assert torch.equal(ws[:, :, i // RO.CHUNK - 1], s)
        s = w[:, i, :, :, None] * s + k[:, i, :, :, None] * v[:, i, :, None, :]


class _Ops(TorchDispatchMode):
    """Records the repro_torch ops dispatched."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.seen.append(func._schema.name.split("::")[-1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-7b"])
def test_counted_ops_run_only_inside_kernel_route(arch):
    """The smoke model's loss and gradients (S 70: a ragged chunk) traced
    outside kernel_route run no counted op; inside it each scan is one
    forward op and one backward op, and loss and gradients are the same
    bit for bit."""
    cfg = dataclasses.replace(get_arch(arch).smoke(), n_layers=2 * (
        get_arch(arch).smoke().attn_every or 1))
    model = build_model(cfg, dtype=torch.float32, device="cpu", remat=False)
    model.init_weights(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    rng = np.random.default_rng(3)
    tok = torch.tensor(rng.integers(0, cfg.vocab, (2, 70)))
    batch = {"tokens": tok, "labels": tok}
    n_scans = (len(model.layers) * (cfg.attn_every - 1) if cfg.attn_every
               else len(model.layers))
    fwd = "ssm_scan_fwd" if cfg.attn_every else "rwkv6_scan_fwd"
    runs = {}
    for inside in (False, True):
        model.zero_grad(set_to_none=True)
        with _Ops() as ops, (kernel_route() if inside
                             else contextlib.nullcontext()):
            loss = model.loss(batch)
            loss.backward()
        runs[inside] = (loss.detach(), {n: p.grad.clone() for n, p in
                                        model.named_parameters()
                                        if p.grad is not None}, ops.seen)
    assert runs[False][2] == []
    seen = runs[True][2]
    assert seen.count(fwd) == n_scans
    assert seen.count(fwd.replace("fwd", "bwd")) == n_scans
    assert len(seen) == 2 * n_scans
    assert torch.equal(runs[True][0], runs[False][0])
    assert runs[True][1].keys() == runs[False][1].keys()
    assert all(torch.equal(runs[True][1][n], g)
               for n, g in runs[False][1].items())
