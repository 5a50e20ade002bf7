"""``rwkv6_scan``: the RWKV6 WKV recurrence from a zero state and its
gradient, CUDA kernels + plain versions.

:func:`rwkv6_scan` is the wrapper the model's RWKV time-mix calls in a
forward pass (no carried state).  On a CUDA tensor it launches the
hand-written kernel in ``rwkv6_scan.cu`` (built with nvcc at first use) on
the current stream and counts the launch in ``rwkv6_scan.launches``; on a
CPU tensor it runs :func:`rwkv6_scan_plain`, the same recurrence in torch
ops.  When a gradient is wanted (grad mode on and an input that requires
grad) the call goes through :class:`Rwkv6ScanFn`: its forward keeps the
kernel's chunk states, and its backward is :func:`rwkv6_scan_bwd`, the
backward kernel of the same source on a CUDA tensor (counted in
``rwkv6_scan_bwd.launches``; fp32 only) and
:func:`rwkv6_scan_bwd_plain` on a CPU tensor.  There is no fallback
between kernel and plain version: a CUDA tensor either launches the
kernel or raises.

Like the TPU kernel it starts from a zero state and returns no state, so
it does not compute a decode step; ``models.ssm.wkv6_scan`` does.

The kernel is a chunked scan over chunks of :data:`CHUNK` steps: a state
pass writes each chunk's incoming state to an fp32 workspace that the
wrapper allocates (``torch.empty``; (B, H, ceil(T / CHUNK) - 1, hd, hd),
as the library states it), and an output pass computes every chunk's y
in parallel from it.  The backward runs a reverse state pass for G (dL/dS
at every chunk's end) and then walks every chunk at once from those two
sets of states (the note above ``wkv_bwd`` in the source).

Replaces the TPU Pallas kernel ``_wkv6_kernel`` / ``rwkv6_scan_fwd`` in
``src/repro/kernels/rwkv6_scan/kernel.py``; see the note at the top of
``rwkv6_scan.cu`` for what bounds it on an H100 and how its design meets
it.  The reference has no backward kernel: JAX differentiates the
``lax.scan`` of its oracle.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import TOLERANCE_FLAGS, load_library

SOURCE = Path(__file__).with_name("rwkv6_scan.cu")
FLAGS = TOLERANCE_FLAGS
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # the kernel's
PLAIN_DTYPES = (*DTYPES, torch.float64)            # the plain version's
# rwkv6_scan.cu's C (steps per chunk) and L (steps per sub-chunk of its
# output pass), for the tests that mirror its decomposition
CHUNK = 64
SUB_CHUNK = 16
# the backward takes fp32 only; a bf16 backward is queued (ROADMAP.md §2)
BWD_DTYPE_MSG = ("rwkv6_scan: the backward kernel takes float32 (the model "
                 "upcasts before the scan); a bf16 backward is not written "
                 "yet (ROADMAP.md §2, 'A bf16 backward for the two scans')")


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_scan: r, k, v, w must share one (B, T, H, "
                         f"hd) shape; got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"rwkv6_scan: u must be (H, hd) = {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {hd} not in {HEAD_DIMS}")
    if t < 1:
        raise ValueError("rwkv6_scan: empty sequence")
    if (r.dtype not in PLAIN_DTYPES
            or any(x.dtype != r.dtype for x in (k, v, w))):
        raise TypeError(f"rwkv6_scan: r, k, v, w must share one of "
                        f"{list(PLAIN_DTYPES)}; got "
                        f"{[x.dtype for x in (r, k, v, w)]}")
    if u.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan: u must be float32, got {u.dtype}")
    if not all(x.is_contiguous() for x in (r, k, v, w, u)):
        raise ValueError("rwkv6_scan: r, k, v, w, u must be contiguous")
    if any(x.device != r.device for x in (k, v, w, u)):
        raise ValueError("rwkv6_scan: inputs on different devices")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w (B, T, H, hd); u (H, hd) fp32 -> y (B, T, H, hd) in r's
    dtype.

    A CUDA tensor launches the kernel (counted in ``rwkv6_scan.launches``);
    a CPU tensor runs :func:`rwkv6_scan_plain`, which also takes float64.
    With grad mode on and an input that requires grad, the call is
    differentiable through :class:`Rwkv6ScanFn` (on a CUDA tensor in fp32
    only: another dtype raises ``TypeError``).
    """
    _check(r, k, v, w, u)
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (r, k, v, w, u)):
        if r.device.type == "cuda" and r.dtype != torch.float32:
            raise TypeError(f"{BWD_DTYPE_MSG}; got {r.dtype}")
        return Rwkv6ScanFn.apply(r, k, v, w, u)
    return _forward(r, k, v, w, u)[0]


rwkv6_scan.launches = 0


def _states_shape(r) -> tuple:
    """The chunk states' shape: (B, H, ceil(T / CHUNK) - 1, hd, hd)."""
    b, t, h, hd = r.shape
    return (b, h, -(-t // CHUNK) - 1, hd, hd)


def _forward(r, k, v, w, u):
    """(y, chunk states or None): the kernel on a CUDA tensor, with the
    fp32 workspace its state pass wrote ((B, H, ceil(T / CHUNK) - 1, hd,
    hd)); the plain version, and no states, on a CPU tensor."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u), None
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if r.dtype not in DTYPES:
        raise TypeError(f"rwkv6_scan: the kernel takes {list(DTYPES)}, got "
                        f"{r.dtype}")
    b, t, h, hd = r.shape
    if b * h > 65535:
        raise ValueError(f"rwkv6_scan: B*H = {b * h} exceeds the grid")
    if any(x.data_ptr() % 16 for x in (r, k, v, w, u)):
        raise ValueError("rwkv6_scan: the kernel reads 16-byte vectors; "
                         "r, k, v, w, u must start 16-byte aligned")
    lib = _library()
    y = torch.empty_like(r)
    ws = torch.empty(lib.rwkv6_scan_workspace_floats(b, t, h, hd),
                     dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), b, t, h,
            hd, DTYPES[r.dtype], stream)
    if err:
        raise RuntimeError("rwkv6_scan launch failed: "
                           + lib.rwkv6_scan_error_string(err).decode())
    rwkv6_scan.launches += 1
    return y, ws.view(_states_shape(r))


class Rwkv6ScanFn(torch.autograd.Function):
    """rwkv6_scan with a gradient: the forward keeps (r, k, v, w, u) and
    the kernel's chunk states; the backward is :func:`rwkv6_scan_bwd`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, states = _forward(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u, states)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        r, k, v, w, u, states = ctx.saved_tensors
        dr, dk, dv, dw, du = rwkv6_scan_bwd(r, k, v, w, u, dy.contiguous(),
                                            states)
        return dr, dk, dv, dw, du.to(u.dtype)


def rwkv6_scan_bwd(r, k, v, w, u, dy, states):
    """(dr, dk, dv, dw, du) of rwkv6_scan for the output gradient `dy`
    (r's shape and dtype): dr, dk, dv, dw in r's dtype, du (H, hd).

    A CUDA tensor launches the backward kernel (counted in
    ``rwkv6_scan_bwd.launches``; fp32 only) from `states`, the chunk
    states the forward kernel wrote ((B, H, ceil(T / CHUNK) - 1, hd, hd)
    fp32, :class:`Rwkv6ScanFn` keeps them); a CPU tensor runs
    :func:`rwkv6_scan_bwd_plain`, which recomputes them (`states` may be
    None there)."""
    _check(r, k, v, w, u)
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device:
        raise ValueError(f"rwkv6_scan_bwd: dy must be r's {tuple(r.shape)} "
                         f"{r.dtype} on {r.device}; got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("rwkv6_scan_bwd: dy must be contiguous")
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_plain(r, k, v, w, u, dy)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    if r.dtype != torch.float32:
        raise TypeError(f"{BWD_DTYPE_MSG}; got {r.dtype}")
    b, t, h, hd = r.shape
    n_states = _states_shape(r)
    if (states is None or tuple(states.shape) != n_states
            or states.dtype != torch.float32 or not states.is_contiguous()
            or states.device != r.device):
        raise ValueError(f"rwkv6_scan_bwd: needs the forward kernel's chunk "
                         f"states, {n_states} fp32 contiguous on {r.device}")
    if b * h > 65535:
        raise ValueError(f"rwkv6_scan_bwd: B*H = {b * h} exceeds the grid")
    if any(x.data_ptr() % 16 for x in (r, k, v, w, u, dy)):
        raise ValueError("rwkv6_scan_bwd: the kernel reads 16-byte vectors; "
                         "r, k, v, w, u, dy must start 16-byte aligned")
    lib = _library()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    ws = torch.empty(lib.rwkv6_scan_bwd_workspace_floats(b, t, h, hd),
                     dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv6_scan_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(), states.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ws.data_ptr(), ws.numel(), b, t, h, hd, stream)
    if err:
        raise RuntimeError("rwkv6_scan backward launch failed: "
                           + lib.rwkv6_scan_error_string(err).decode())
    rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du


rwkv6_scan_bwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE, FLAGS)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_scan_launch.argtypes = [p, p, p, p, p, p, p,
                                          ctypes.c_longlong, i, i, i, i, i, p]
        lib.rwkv6_scan_launch.restype = i
        lib.rwkv6_scan_workspace_floats.argtypes = [i, i, i, i]
        lib.rwkv6_scan_workspace_floats.restype = ctypes.c_longlong
        lib.rwkv6_scan_bwd_launch.argtypes = [p] * 13 + [
            ctypes.c_longlong, i, i, i, i, p]
        lib.rwkv6_scan_bwd_launch.restype = i
        lib.rwkv6_scan_bwd_workspace_floats.argtypes = [i, i, i, i]
        lib.rwkv6_scan_bwd_workspace_floats.restype = ctypes.c_longlong
        lib.rwkv6_scan_smem_bytes.argtypes = [i, i]
        lib.rwkv6_scan_smem_bytes.restype = i
        lib.rwkv6_scan_error_string.argtypes = [i]
        lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def smem_bytes(hd: int) -> dict:
    """Dynamic shared memory of one block of each of the kernel's passes
    at head size `hd`, as the built library states it (builds the library
    if needed): the state passes (the forward's and the backward's G
    pass), the output pass and the backward's chunk pass."""
    lib = _library()
    return {"state": int(lib.rwkv6_scan_smem_bytes(hd, 0)),
            "out": int(lib.rwkv6_scan_smem_bytes(hd, 1)),
            "bwd": int(lib.rwkv6_scan_smem_bytes(hd, 2))}


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, states: bool = False):
    """The kernel's recurrence in torch ops, on any device: fp32 state
    (B, H, hd, hd) from zero (fp64 for fp64 inputs), one step per time
    index; y in r's dtype.  ``states=True`` returns (y, the chunk states):
    the state entering every :data:`CHUNK`-step chunk but the first, (B,
    H, ceil(T / CHUNK) - 1, hd, hd) in the state's dtype, laid out as the
    kernel's workspace."""
    _check(r, k, v, w, u)
    b, t, h, hd = r.shape
    cdt = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf = (x.to(cdt) for x in (r, k, v, w))
    s = torch.zeros((b, h, hd, hd), dtype=cdt, device=r.device)
    uu = u[None, :, :, None]
    ys, saved = [], []
    for i in range(t):
        if states and i and i % CHUNK == 0:
            saved.append(s)
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]     # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uu * kv))
        s = wf[:, i, :, :, None] * s + kv
    y = torch.stack(ys, dim=1).to(r.dtype)
    if not states:
        return y
    hs = (torch.stack(saved, dim=2) if saved else
          torch.zeros((b, h, 0, hd, hd), dtype=cdt, device=r.device))
    return y, hs


def rwkv6_scan_cost(b: int, t: int, h: int, hd: int, itemsize: int):
    """(operations, bytes) the function needs, r, k, v, w read once, u
    read once and y written once.  Per step and head, factored as
    ``y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i``: 2 hd^2 for r.S, 3 hd
    for r.(u*k), 2 hd for v*c + (r.S); and 3 hd^2 for the update
    ``S_ij = w_i S_ij + k_i v_j``."""
    ops = b * t * h * (5 * hd * hd + 5 * hd)
    nbytes = 5 * b * t * h * hd * itemsize + h * hd * 4
    return ops, nbytes


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """The backward's reverse recurrence in torch ops, on any device, with
    no autograd: (dr, dk, dv, dw) in r's dtype and du (H, hd), in fp32
    (float64 for float64 inputs, du too).

    States are stepped forward from zero once, keeping each chunk's
    incoming one (every :data:`CHUNK` steps), and recomputed forward per
    chunk; then, per step from the last, with G = dL/dS_out (zero at T):
    dr = S_in dy + u k (dy.v), dk = G v + u r (dy.v), dv = G^T k + dy
    (r.(u k)), dw = rowsum(G * S_in), du += r k (dy.v), and G = diag(w) G
    + r^T dy."""
    _check(r, k, v, w, u)
    if dy.shape != r.shape:
        raise ValueError(f"rwkv6_scan_bwd_plain: dy must be "
                         f"{tuple(r.shape)}, got {tuple(dy.shape)}")
    b, t, h, hd = r.shape
    cdt = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf, df = (x.to(cdt) for x in (r, k, v, w, dy))
    uf = u.to(cdt)[None]                                   # (1, H, hd)

    def step(s, i):
        return (wf[:, i, :, :, None] * s
                + kf[:, i, :, :, None] * vf[:, i, :, None, :])

    starts, s = [], torch.zeros((b, h, hd, hd), dtype=cdt, device=r.device)
    for t0 in range(0, t, CHUNK):
        starts.append(s)
        for i in range(t0, min(t0 + CHUNK, t)):
            s = step(s, i)
    g = torch.zeros_like(s)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((h, hd), dtype=cdt, device=r.device)
    for ci in range(len(starts) - 1, -1, -1):
        t0 = ci * CHUNK
        hist, s = [], starts[ci]
        for i in range(t0, min(t0 + CHUNK, t)):
            hist.append(s)
            s = step(s, i)
        for i in range(min(t0 + CHUNK, t) - 1, t0 - 1, -1):
            s_in, ri, ki, vi, di = (hist[i - t0], rf[:, i], kf[:, i],
                                    vf[:, i], df[:, i])
            dyv = (di * vi).sum(-1, keepdim=True)            # (B, H, 1)
            dr[:, i] = torch.einsum("bhij,bhj->bhi", s_in, di) \
                + uf * ki * dyv
            dk[:, i] = torch.einsum("bhij,bhj->bhi", g, vi) + uf * ri * dyv
            dv[:, i] = torch.einsum("bhij,bhi->bhj", g, ki) \
                + di * (ri * uf * ki).sum(-1, keepdim=True)
            dw[:, i] = (g * s_in).sum(-1)
            du += (ri * ki * dyv).sum(0)
            g = wf[:, i, :, :, None] * g + ri[..., None] * di[..., None, :]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(r.dtype),
            du)


def rwkv6_scan_bwd_cost(b: int, t: int, h: int, hd: int, itemsize: int):
    """(operations, bytes) the backward needs: per step and head, 3 hd^2
    to step S_in forward (``w_i S_ij + k_i v_j``), 3 hd^2 for G's update
    (``w_i G_ij + r_i dy_j``) and 2 hd^2 each for dr (``S_in dy``), dk
    (``G v``), dv (``G^T k``) and dw (``rowsum(G * S_in)``); 2 hd for
    dy.v and r.(u k), 3 hd each for the u terms of dr, dk and dv and for
    du.  r, k, v, w, dy read once and dr, dk, dv, dw written once; u read
    and du written once."""
    ops = b * t * h * (14 * hd * hd + 16 * hd)
    nbytes = 9 * b * t * h * hd * itemsize + 2 * h * hd * 4
    return ops, nbytes


# ---------------------------------------------------------------------
# The scan as one counted op (the dry run's trace)
#
# ``launch.dryrun`` traces the model on fake CPU tensors, where the
# wrapper's plain versions would be traced one time step at a time.
# Inside ``models.attention.kernel_route`` the RWKV time-mix calls
# :func:`rwkv6_scan_counted` instead: the forward and the backward are
# each one custom op, whose real implementation is the plain version (so
# values and gradients are those of ``Rwkv6ScanFn``'s CPU route, bit for
# bit) and whose fake implementation allocates what the card's launch
# allocates: the outputs and, on every call, the chunk states' workspace.
# Their FLOPs are the matmul-class FLOPs of the plain versions' products
# (r . S a step forward; dr, dk and dv a step backward), which the
# step-by-step trace counts; their bytes are their inputs' and outputs'.
# ---------------------------------------------------------------------

def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


@torch.library.custom_op("repro_torch::rwkv6_scan_fwd", mutates_args=())
def rwkv6_scan_fwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, chunk states): :func:`rwkv6_scan_plain` with ``states=True``."""
    return rwkv6_scan_plain(r, k, v, w, u, states=True)


@rwkv6_scan_fwd_op.register_fake
def _(r, k, v, w, u):
    return (torch.empty_like(r),
            r.new_empty(_states_shape(r), dtype=_compute_dtype(r.dtype)))


@torch.library.custom_op("repro_torch::rwkv6_scan_bwd", mutates_args=())
def rwkv6_scan_bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                      states: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
    """(dr, dk, dv, dw, du): :func:`rwkv6_scan_bwd_plain`, which steps
    the states again itself, as the CPU route's backward does."""
    return rwkv6_scan_bwd_plain(r, k, v, w, u, dy)


@rwkv6_scan_bwd_op.register_fake
def _(r, k, v, w, u, dy, states):
    return (*(torch.empty_like(r) for _ in range(4)),
            u.new_empty(u.shape, dtype=_compute_dtype(r.dtype)))


def _fwd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[1])
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)      # no zeros for the states' gradient


def _fwd_backward(ctx, dy, _dstates):
    r, k, v, w, u, states = ctx.saved_tensors
    dr, dk, dv, dw, du = rwkv6_scan_bwd_op(r, k, v, w, u, dy.contiguous(),
                                           states)
    return dr, dk, dv, dw, du.to(u.dtype)


rwkv6_scan_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_fwd)
def _fwd_flops(r_shape, *args, out_shape=None, **kwargs) -> int:
    b, t, h, hd = r_shape
    return 2 * b * t * h * hd * hd


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_bwd)
def _bwd_flops(r_shape, *args, out_shape=None, **kwargs) -> int:
    b, t, h, hd = r_shape
    return 6 * b * t * h * hd * hd


def rwkv6_scan_counted(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`rwkv6_scan` on CPU tensors as one op forward and one op
    backward (``repro_torch::rwkv6_scan_fwd`` / ``rwkv6_scan_bwd``), for
    a trace that counts ops: the same values and gradients as the
    wrapper's CPU route, bit for bit."""
    _check(r, k, v, w, u)
    if r.device.type != "cpu":
        raise ValueError(f"rwkv6_scan_counted: CPU tensors only, got "
                         f"{r.device}")
    return rwkv6_scan_fwd_op(r, k, v, w, u)[0]
