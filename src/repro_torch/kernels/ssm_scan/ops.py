"""``ssm_scan``: the Mamba selective scan from a zero state and its
gradient, CUDA kernels + plain versions.

:func:`ssm_scan` is the wrapper the model's Mamba block calls in a forward
pass (no carried state).  On a CUDA tensor it launches the hand-written
kernel in ``ssm_scan.cu`` (built with nvcc at first use) on the current
stream and counts the launch in ``ssm_scan.launches``; on a CPU tensor it
runs :func:`ssm_scan_plain`, the same recurrence in torch ops.  When a
gradient is wanted (grad mode on and an input that requires grad) the
call goes through :class:`SsmScanFn`: its forward launches the kernel's
fp32 instantiation that also writes the backward's checkpoints (h every
:data:`BWD_CHUNK` steps) and keeps them, and its backward is
:func:`ssm_scan_bwd`: the backward kernels of the same source on a CUDA
tensor (counted in ``ssm_scan_bwd.launches``; fp32 only) and
:func:`ssm_scan_bwd_plain` on a CPU tensor.  There is no fallback between
kernel and plain version: a CUDA tensor either launches the kernel or
raises.

Like the TPU kernel it starts from a zero state, returns no state and
applies no ``D`` term (the model adds ``D * u``), so it does not compute a
decode step; ``models.ssm._selective_scan`` does.

Replaces the TPU Pallas kernel ``_ssm_kernel`` / ``ssm_scan_fwd`` in
``src/repro/kernels/ssm_scan/kernel.py`` without its block-divisibility
limits (any T and D); see the note at the top of ``ssm_scan.cu`` for what
bounds it on an H100 and how its design meets it.  The reference has no
backward kernel: JAX differentiates the ``lax.scan`` of its oracle.  The
backward walks back from the forward's checkpoints, recomputing each
chunk's states from them (the note above ``ssm_bwd`` in the source); the
no-grad forward is compiled without the checkpoint stores.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import TOLERANCE_FLAGS, load_library

SOURCE = Path(__file__).with_name("ssm_scan.cu")
FLAGS = TOLERANCE_FLAGS
STATE_DIMS = (4, 8, 16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # the kernel's
PLAIN_DTYPES = (*DTYPES, torch.float64)            # the plain version's
# ssm_scan.cu's BWD_C: steps between the checkpoints the saving forward
# writes (the plain versions keep the same ones)
BWD_CHUNK = 64
# the backward takes fp32 only; a bf16 backward is queued (ROADMAP.md §2)
BWD_DTYPE_MSG = ("ssm_scan: the backward kernel takes float32 (the model "
                 "upcasts before the scan); a bf16 backward is not written "
                 "yet (ROADMAP.md §2, 'A bf16 backward for the two scans')")


def _check(u, dt, a, b, c) -> None:
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"ssm_scan: u and dt must share one (B, T, D) "
                         f"shape; got {tuple(u.shape)}, {tuple(dt.shape)}")
    bsz, t, d = u.shape
    if a.dim() != 2 or a.shape[0] != d:
        raise ValueError(f"ssm_scan: a must be (D, N) with D = {d}, got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    if b.shape != (bsz, t, n) or c.shape != (bsz, t, n):
        raise ValueError(f"ssm_scan: b and c must be (B, T, N) = "
                         f"{(bsz, t, n)}; got {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssm_scan: state dim {n} not in {STATE_DIMS}")
    if t < 1 or bsz < 1 or d < 1:
        raise ValueError(f"ssm_scan: empty input {tuple(u.shape)}")
    if (u.dtype not in PLAIN_DTYPES
            or any(x.dtype != u.dtype for x in (dt, b, c))):
        raise TypeError(f"ssm_scan: u, dt, b, c must share one of "
                        f"{list(PLAIN_DTYPES)}; got "
                        f"{[x.dtype for x in (u, dt, b, c)]}")
    if a.dtype != torch.float32:
        raise TypeError(f"ssm_scan: a must be float32, got {a.dtype}")
    if not all(x.is_contiguous() for x in (u, dt, a, b, c)):
        raise ValueError("ssm_scan: u, dt, a, b, c must be contiguous")
    if any(x.device != u.device for x in (dt, a, b, c)):
        raise ValueError("ssm_scan: inputs on different devices")


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """u, dt (B, T, D); a (D, N) fp32; b, c (B, T, N) -> y (B, T, D) in u's
    dtype.

    A CUDA tensor launches the kernel (counted in ``ssm_scan.launches``);
    a CPU tensor runs :func:`ssm_scan_plain`, which also takes float64.
    With grad mode on and an input that requires grad, the call is
    differentiable through :class:`SsmScanFn` (on a CUDA tensor in fp32
    only: another dtype raises ``TypeError``).
    """
    _check(u, dt, a, b, c)
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (u, dt, a, b, c)):
        if u.device.type == "cuda" and u.dtype != torch.float32:
            raise TypeError(f"{BWD_DTYPE_MSG}; got {u.dtype}")
        return SsmScanFn.apply(u, dt, a, b, c)
    return _forward(u, dt, a, b, c)


ssm_scan.launches = 0


def _forward(u, dt, a, b, c, save: bool = False):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``save=True`` (the forward a gradient takes; fp32 on the card) returns
    (y, the backward's checkpoints): h after every :data:`BWD_CHUNK` steps
    but the last, (B, ceil(T / BWD_CHUNK) - 1, D, N), from the kernel's
    instantiation that also stores them (fp32), or from the plain version
    (in its compute dtype)."""
    if u.device.type == "cpu":
        return ssm_scan_plain(u, dt, a, b, c, states=save)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {u.device}")
    if u.dtype not in DTYPES:
        raise TypeError(f"ssm_scan: the kernel takes {list(DTYPES)}, got "
                        f"{u.dtype}")
    if save and u.dtype != torch.float32:
        raise TypeError(f"{BWD_DTYPE_MSG}; got {u.dtype}")
    if u.shape[0] > 65535:
        raise ValueError(f"ssm_scan: B = {u.shape[0]} exceeds the grid")
    out = _launch(_library(), u, dt, a, b, c, save)
    ssm_scan.launches += 1
    return out


def _states_shape(u, a) -> tuple:
    bsz, t, d = u.shape
    return (bsz, -(-t // BWD_CHUNK) - 1, d, a.shape[1])


class SsmScanFn(torch.autograd.Function):
    """ssm_scan with a gradient: the forward keeps its inputs and the
    checkpoints its launch wrote; the backward is :func:`ssm_scan_bwd`
    from them."""

    @staticmethod
    def forward(ctx, u, dt, a, b, c):
        y, states = _forward(u, dt, a, b, c, save=True)
        ctx.save_for_backward(u, dt, a, b, c, states)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        u, dt, a, b, c, states = ctx.saved_tensors
        du, ddt, da, db, dc = ssm_scan_bwd(u, dt, a, b, c, dy.contiguous(),
                                           states=states)
        return du, ddt, da.to(a.dtype), db, dc


def ssm_scan_bwd(u, dt, a, b, c, dy, *, states=None):
    """(du, ddt, da, db, dc) of ssm_scan for the output gradient `dy` (u's
    shape and dtype): du, ddt, db, dc in u's dtype, da (D, N).

    `states`: the checkpoints the saving forward wrote (h after every
    :data:`BWD_CHUNK` steps but the last, (B, ceil(T / BWD_CHUNK) - 1, D,
    N), contiguous, fp32 on the card, the plain version's compute dtype on
    the CPU), as :class:`SsmScanFn` keeps them; None steps them afresh
    (on the card by the saving forward, counted in ``ssm_scan.launches``).
    A CUDA tensor launches the backward kernels (the reverse walk and a
    fixed-order reduction; counted once in ``ssm_scan_bwd.launches``; fp32
    only); a CPU tensor runs :func:`ssm_scan_bwd_plain`."""
    _check(u, dt, a, b, c)
    if dy.shape != u.shape or dy.dtype != u.dtype or dy.device != u.device:
        raise ValueError(f"ssm_scan_bwd: dy must be u's {tuple(u.shape)} "
                         f"{u.dtype} on {u.device}; got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("ssm_scan_bwd: dy must be contiguous")
    if u.device.type == "cpu":
        return ssm_scan_bwd_plain(u, dt, a, b, c, dy, states=states)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd: unsupported device {u.device}")
    if u.dtype != torch.float32:
        raise TypeError(f"{BWD_DTYPE_MSG}; got {u.dtype}")
    bsz, t, d = u.shape
    n = a.shape[1]
    if bsz > 65535:
        raise ValueError(f"ssm_scan_bwd: B = {bsz} exceeds the grid")
    if states is None:
        states = _forward(u, dt, a, b, c, save=True)[1]
    else:
        _check_states(u, a, states, torch.float32)
    lib = _library()
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty_like(a)
    ws = torch.empty(lib.ssm_scan_bwd_workspace_floats(bsz, t, d, n),
                     dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssm_scan_bwd_launch(
            u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), dy.data_ptr(), states.data_ptr(), du.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
            ws.data_ptr(), ws.numel(), bsz, t, d, n, stream)
    if err:
        raise RuntimeError("ssm_scan backward launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    ssm_scan_bwd.launches += 1
    return du, ddt, da, db, dc


ssm_scan_bwd.launches = 0


def _check_states(u, a, states, dtype) -> None:
    """`states` must be the checkpoints of u's forward: (B, ceil(T /
    BWD_CHUNK) - 1, D, N) `dtype`, contiguous, on u's device."""
    want = _states_shape(u, a)
    if (not isinstance(states, torch.Tensor)
            or tuple(states.shape) != want or states.dtype != dtype
            or states.device != u.device or not states.is_contiguous()):
        got = ((tuple(states.shape), states.dtype, str(states.device))
               if isinstance(states, torch.Tensor) else type(states))
        raise ValueError(f"ssm_scan_bwd: states must be the forward's "
                         f"checkpoints, {want} {dtype} contiguous on "
                         f"{u.device}; got {got}")


def _launch(lib: ctypes.CDLL, u, dt, a, b, c, save: bool = False):
    """The kernel in `lib` on checked CUDA inputs, on the current stream:
    y, or with ``save`` (fp32) (y, checkpoints) from the instantiation
    that also stores them."""
    bsz, t, d = u.shape
    y = torch.empty_like(u)
    args = [x.data_ptr() for x in (u, dt, a, b, c, y)]
    with torch.cuda.device(u.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        if save:
            hs = torch.empty(_states_shape(u, a), dtype=torch.float32,
                             device=u.device)
            err = lib.ssm_scan_fwd_states_launch(
                *args, hs.data_ptr(), hs.numel(), bsz, t, d, a.shape[1],
                stream)
        else:
            err = lib.ssm_scan_launch(*args, bsz, t, d, a.shape[1],
                                      DTYPES[u.dtype], stream)
    if err:
        raise RuntimeError("ssm_scan launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    return (y, hs) if save else y


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE, FLAGS)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.ssm_scan_launch.restype = i
        lib.ssm_scan_fwd_states_launch.argtypes = [p] * 7 + [
            ctypes.c_longlong, i, i, i, i, p]
        lib.ssm_scan_fwd_states_launch.restype = i
        lib.ssm_scan_bwd_launch.argtypes = [p] * 13 + [
            ctypes.c_longlong, i, i, i, i, p]
        lib.ssm_scan_bwd_launch.restype = i
        lib.ssm_scan_bwd_workspace_floats.argtypes = [i, i, i, i]
        lib.ssm_scan_bwd_workspace_floats.restype = ctypes.c_longlong
        lib.ssm_scan_smem_bytes.argtypes = [i, i]
        lib.ssm_scan_smem_bytes.restype = i
        lib.ssm_scan_bwd_smem_bytes.argtypes = [i]
        lib.ssm_scan_bwd_smem_bytes.restype = i
        lib.ssm_scan_error_string.argtypes = [i]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def smem_bytes(n: int, dtype: torch.dtype) -> int:
    """One block's dynamic shared memory in bytes at state dim `n` and
    `dtype`, as the kernel states it (builds it if needed)."""
    return int(_library().ssm_scan_smem_bytes(n, DTYPES[dtype]))


def bwd_smem_bytes(n: int) -> int:
    """One ``ssm_bwd`` block's dynamic shared memory in bytes at state dim
    `n`, as the kernel states it (builds it if needed)."""
    return int(_library().ssm_scan_bwd_smem_bytes(n))


def ssm_scan_plain(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, states: bool = False):
    """The reference oracle's recurrence (``ssm_scan_ref``) in torch ops,
    on any device: fp32 state (B, D, N) from zero (fp64 for fp64 inputs),
    one step per time index; y in u's dtype.  ``states=True`` returns (y,
    the backward's checkpoints): h after every :data:`BWD_CHUNK` steps but
    the last, (B, ceil(T / BWD_CHUNK) - 1, D, N) in the state's dtype."""
    _check(u, dt, a, b, c)
    bsz, t, d = u.shape
    cdt = torch.promote_types(u.dtype, torch.float32)
    uf, dtf, bf, cf = (x.to(cdt) for x in (u, dt, b, c))
    af = a.to(cdt)[None]
    h = torch.zeros((bsz, d, a.shape[1]), dtype=cdt, device=u.device)
    ys, saved = [], []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * af)                 # (B, D, N)
        dbu = dtf[:, i, :, None] * bf[:, i, None, :] * uf[:, i, :, None]
        h = da * h + dbu
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, i]))
        if states and (i + 1) % BWD_CHUNK == 0 and i + 1 < t:
            saved.append(h)
    y = torch.stack(ys, dim=1).to(u.dtype)
    if not states:
        return y
    hs = (torch.stack(saved, dim=1) if saved else
          torch.zeros((bsz, 0, d, a.shape[1]), dtype=cdt, device=u.device))
    return y, hs


def ssm_scan_cost(b: int, t: int, d: int, n: int, itemsize: int):
    """(operations, bytes, exps) the function needs: per step and channel
    ``dt*u`` once and, per state element, ``dt*A``, its exp's product with
    h, ``B*(dt*u)``, the add, ``C*h`` and its sum (6 operations; the exp
    is counted apart, for the SFU); u, dt, b, c read once, a read once and
    y written once."""
    ops = b * t * d * (6 * n + 1)
    nbytes = (3 * b * t * d + 2 * b * t * n) * itemsize + d * n * 4
    return ops, nbytes, b * t * d * n


def _plain_step(uf, dtf, af, bf, h, i):
    """h after step i, as :func:`ssm_scan_plain` steps it."""
    e = torch.exp(dtf[:, i, :, None] * af)
    return e * h + dtf[:, i, :, None] * bf[:, i, None, :] * uf[:, i, :, None]


def _plain_states(uf, dtf, af, bf):
    """The checkpoints :func:`ssm_scan_bwd_plain` steps when it is given
    none: h after every :data:`BWD_CHUNK` steps but the last, (B, n, D,
    N), stepped from zero in the inputs' (compute) dtype."""
    bsz, t, d = uf.shape
    h = torch.zeros((bsz, d, af.shape[1]), dtype=uf.dtype, device=uf.device)
    saved = []
    for i in range(t - 1):
        h = _plain_step(uf, dtf, af, bf, h, i)
        if (i + 1) % BWD_CHUNK == 0:
            saved.append(h)
    return (torch.stack(saved, dim=1) if saved else
            torch.zeros((bsz, 0, d, af.shape[1]), dtype=uf.dtype,
                        device=uf.device))


def ssm_scan_bwd_plain(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                       states: torch.Tensor | None = None):
    """The backward's reverse recurrence in torch ops, on any device, with
    no autograd: (du, ddt, db, dc in u's dtype, da (D, N)), in fp32
    (float64 for float64 inputs, da too).

    h starts each :data:`BWD_CHUNK`-step chunk from its checkpoint:
    `states`, the forward's ((B, ceil(T / BWD_CHUNK) - 1, D, N) in the
    compute dtype, :func:`ssm_scan_plain` with ``states=True``), or, when
    None, stepped forward from zero here the same way.  Each chunk's states
    are recomputed forward from its checkpoint (never recovered by dividing
    by the decay); then, per step from the last, with G = dL/dh_t: G +=
    dy_t C_t; dC_t = sum_d dy_t h_t; dB_t = sum_d G dt_t u_t; du_t = dt_t
    G.B_t; ddt_t = sum_n G (A e_t h_{t-1} + B_t u_t); dA += G dt_t e_t
    h_{t-1}; G = e_t G, with e_t = exp(dt_t A)."""
    _check(u, dt, a, b, c)
    if dy.shape != u.shape:
        raise ValueError(f"ssm_scan_bwd_plain: dy must be {tuple(u.shape)}, "
                         f"got {tuple(dy.shape)}")
    bsz, t, d = u.shape
    cdt = torch.promote_types(u.dtype, torch.float32)
    uf, dtf, bf, cf, df = (x.to(cdt) for x in (u, dt, b, c, dy))
    af = a.to(cdt)
    if states is None:
        states = _plain_states(uf, dtf, af, bf)
    else:
        _check_states(u, a, states, cdt)

    def step(h, i):
        return _plain_step(uf, dtf, af, bf, h, i)

    h = torch.zeros((bsz, d, a.shape[1]), dtype=cdt, device=u.device)
    starts = [h] + list(states.unbind(1))
    g = torch.zeros_like(h)
    du, ddt = torch.empty_like(uf), torch.empty_like(uf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    for ci in range(len(starts) - 1, -1, -1):
        t0, t1 = ci * BWD_CHUNK, min((ci + 1) * BWD_CHUNK, t)
        hist = [starts[ci]]
        for i in range(t0, t1):
            hist.append(step(hist[-1], i))
        for i in range(t1 - 1, t0 - 1, -1):
            hp, hc = hist[i - t0], hist[i - t0 + 1]
            dti, ui, bi = dtf[:, i], uf[:, i], bf[:, i]
            g = g + df[:, i, :, None] * cf[:, i, None, :]
            dc[:, i] = torch.einsum("bd,bdn->bn", df[:, i], hc)
            db[:, i] = torch.einsum("bdn,bd->bn", g, dti * ui)
            du[:, i] = dti * torch.einsum("bdn,bn->bd", g, bi)
            e = torch.exp(dti[..., None] * af)
            x = e * hp
            ddt[:, i] = (g * (af * x + bi[:, None, :] * ui[..., None])).sum(-1)
            da += (g * dti[..., None] * x).sum(0)
            g = e * g
    return (du.to(u.dtype), ddt.to(u.dtype), da, db.to(u.dtype),
            dc.to(u.dtype))


def ssm_scan_bwd_cost(b: int, t: int, d: int, n: int, itemsize: int):
    """(operations, bytes, exps) the backward needs.  Per step, channel and
    state element: 4 operations to step h forward (``dt*A``, ``B*(dt*u)``
    and the decay's multiply-add) and 18 for the gradient: G += dy C (2);
    the terms and sums of dC (``dy h``: 2), dB (``G dt u``: 2) and G.B
    (2); ddt's ``e h``, ``A (e h)``, ``B u``, their add, the product with
    G and its sum (6); dA's ``G dt``, its product with ``e h`` and the
    accumulation (3); G = e G (1).  Per channel ``dt*u`` and du's
    ``dt*``: 2.  The exp counted apart, once per element (the SFU's
    work), as :func:`ssm_scan_cost` counts it.  u, dt, dy, b, c and a read
    once; du, ddt, db, dc and da written once."""
    ops = b * t * d * (22 * n + 2)
    nbytes = ((5 * b * t * d + 4 * b * t * n) * itemsize
              + 2 * d * n * 4)
    return ops, nbytes, b * t * d * n


# ---------------------------------------------------------------------
# The scan as one counted op (the dry run's trace)
#
# ``launch.dryrun`` traces the model on fake CPU tensors, where the
# wrapper's plain versions would be traced one time step at a time (tens
# of ms a step, hours for a cell).  Inside ``models.attention.
# kernel_route`` the Mamba block calls :func:`ssm_scan_counted` instead:
# the forward and the backward are each one custom op, whose real
# implementation is the plain version (so values and gradients are those
# of ``SsmScanFn``'s CPU route, bit for bit) and whose fake implementation
# allocates what the card's launch allocates: the outputs and, when a
# gradient is taken, the saving forward's checkpoints.  Their FLOPs are
# the matmul-class FLOPs of the plain versions' products (C . h a step
# forward; dC, dB and G.B a step backward), which the step-by-step trace
# counts; their bytes are their inputs' and outputs'.
# ---------------------------------------------------------------------

def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


@torch.library.custom_op("repro_torch::ssm_scan_fwd", mutates_args=())
def ssm_scan_fwd_op(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, save: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, checkpoints): :func:`ssm_scan_plain`; the checkpoints are
    (B, ceil(T / BWD_CHUNK) - 1, D, N) with `save`, else (B, 0, D, N)."""
    if save:
        return ssm_scan_plain(u, dt, a, b, c, states=True)
    y = ssm_scan_plain(u, dt, a, b, c)
    return y, u.new_empty((u.shape[0], 0, u.shape[2], a.shape[1]),
                          dtype=_compute_dtype(u.dtype))


@ssm_scan_fwd_op.register_fake
def _(u, dt, a, b, c, save):
    bsz, n_ck, d, n = _states_shape(u, a)
    return (torch.empty_like(u),
            u.new_empty((bsz, n_ck if save else 0, d, n),
                        dtype=_compute_dtype(u.dtype)))


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def ssm_scan_bwd_op(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                    states: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """(du, ddt, da, db, dc): :func:`ssm_scan_bwd_plain` from the
    forward's checkpoints."""
    return ssm_scan_bwd_plain(u, dt, a, b, c, dy, states=states)


@ssm_scan_bwd_op.register_fake
def _(u, dt, a, b, c, dy, states):
    return (torch.empty_like(u), torch.empty_like(u),
            a.new_empty(a.shape, dtype=_compute_dtype(u.dtype)),
            torch.empty_like(b), torch.empty_like(c))


def _fwd_setup(ctx, inputs, output):
    u, dt, a, b, c, _ = inputs
    ctx.save_for_backward(u, dt, a, b, c, output[1])
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)      # no zeros for the states' gradient


def _fwd_backward(ctx, dy, _dstates):
    u, dt, a, b, c, states = ctx.saved_tensors
    du, ddt, da, db, dc = ssm_scan_bwd_op(u, dt, a, b, c, dy.contiguous(),
                                          states)
    return du, ddt, da.to(a.dtype), db, dc, None


ssm_scan_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


@register_flop_formula(torch.ops.repro_torch.ssm_scan_fwd)
def _fwd_flops(u_shape, dt_shape, a_shape, *args, out_shape=None,
               **kwargs) -> int:
    bsz, t, d = u_shape
    return 2 * bsz * t * d * a_shape[1]


@register_flop_formula(torch.ops.repro_torch.ssm_scan_bwd)
def _bwd_flops(u_shape, dt_shape, a_shape, *args, out_shape=None,
               **kwargs) -> int:
    bsz, t, d = u_shape
    return 6 * bsz * t * d * a_shape[1]


def ssm_scan_counted(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """:func:`ssm_scan` on CPU tensors as one op forward and one op
    backward (``repro_torch::ssm_scan_fwd`` / ``ssm_scan_bwd``), for a
    trace that counts ops: the same values and gradients as the wrapper's
    CPU route, bit for bit."""
    _check(u, dt, a, b, c)
    if u.device.type != "cpu":
        raise ValueError(f"ssm_scan_counted: CPU tensors only, got "
                         f"{u.device}")
    save = torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (u, dt, a, b, c))
    return ssm_scan_fwd_op(u, dt, a, b, c, save)[0]
