"""``ssm_scan``: the Mamba selective scan from a zero state, CUDA kernel +
plain version.

:func:`ssm_scan` is the wrapper the model's Mamba block calls in a forward
pass (no carried state).  On a CUDA tensor it launches the hand-written
kernel in ``ssm_scan.cu`` (built with nvcc at first use) on the current
stream and counts the launch in ``ssm_scan.launches``; on a CPU tensor it
runs :func:`ssm_scan_plain`, the same recurrence in torch ops.  There is no
fallback between the two: a CUDA tensor either launches the kernel or
raises.

Like the TPU kernel it starts from a zero state, returns no state and
applies no ``D`` term (the model adds ``D * u``), so it does not compute a
decode step; ``models.ssm._selective_scan`` does.

Replaces the TPU Pallas kernel ``_ssm_kernel`` / ``ssm_scan_fwd`` in
``src/repro/kernels/ssm_scan/kernel.py`` without its block-divisibility
limits (any T and D); see the note at the top of ``ssm_scan.cu`` for what
bounds it on an H100 and how its design meets it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import TOLERANCE_FLAGS, load_library

SOURCE = Path(__file__).with_name("ssm_scan.cu")
FLAGS = TOLERANCE_FLAGS
STATE_DIMS = (4, 8, 16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}     # the kernel's
PLAIN_DTYPES = (*DTYPES, torch.float64)            # the plain version's


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
    a CPU tensor runs :func:`ssm_scan_plain`, which also takes float64
    and keeps autograd.  The kernel has no backward yet: on a CUDA tensor
    a call that would need one (grad mode on and an input that requires
    grad) raises ``NotImplementedError`` rather than return an output cut
    from the graph.
    """
    _check(u, dt, a, b, c)
    if u.device.type == "cpu":
        return ssm_scan_plain(u, dt, a, b, c)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {u.device}")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (u, dt, a, b, c)):
        raise NotImplementedError(
            "ssm_scan: the CUDA kernel has no backward yet, so the hybrid "
            "family cannot train on the card (ROADMAP.md §1, 'ssm_scan "
            "backward kernel'); run the forward under torch.no_grad()")
    if u.dtype not in DTYPES:
        raise TypeError(f"ssm_scan: the kernel takes {list(DTYPES)}, got "
                        f"{u.dtype}")
    if u.shape[0] > 65535:
        raise ValueError(f"ssm_scan: B = {u.shape[0]} exceeds the grid")
    y = _launch(_library(), u, dt, a, b, c)
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0


def _launch(lib: ctypes.CDLL, u, dt, a, b, c) -> torch.Tensor:
    """The kernel in `lib` on checked CUDA inputs, on the current stream."""
    bsz, t, d = u.shape
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssm_scan_launch(
            u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), bsz, t, d, a.shape[1],
            DTYPES[u.dtype], stream)
    if err:
        raise RuntimeError("ssm_scan launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    return y


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE, FLAGS)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.ssm_scan_launch.restype = i
        lib.ssm_scan_smem_bytes.argtypes = [i, i]
        lib.ssm_scan_smem_bytes.restype = i
        lib.ssm_scan_error_string.argtypes = [i]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def smem_bytes(n: int, dtype: torch.dtype) -> int:
    """One block's dynamic shared memory in bytes at state dim `n` and
    `dtype`, as the kernel states it (builds it if needed)."""
    return int(_library().ssm_scan_smem_bytes(n, DTYPES[dtype]))


def ssm_scan_plain(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The reference oracle's recurrence (``ssm_scan_ref``) in torch ops,
    on any device: fp32 state (B, D, N) from zero (fp64 for fp64 inputs),
    one step per time index; y in u's dtype."""
    _check(u, dt, a, b, c)
    bsz, t, d = u.shape
    cdt = torch.promote_types(u.dtype, torch.float32)
    uf, dtf, bf, cf = (x.to(cdt) for x in (u, dt, b, c))
    af = a.to(cdt)[None]
    h = torch.zeros((bsz, d, a.shape[1]), dtype=cdt, device=u.device)
    ys = []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * af)                 # (B, D, N)
        dbu = dtf[:, i, :, None] * bf[:, i, None, :] * uf[:, i, :, None]
        h = da * h + dbu
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, i]))
    return torch.stack(ys, dim=1).to(u.dtype)


def ssm_scan_cost(b: int, t: int, d: int, n: int, itemsize: int):
    """(operations, bytes, exps) the function needs: per step and channel
    ``dt*u`` once and, per state element, ``dt*A``, its exp's product with
    h, ``B*(dt*u)``, the add, ``C*h`` and its sum (6 operations; the exp
    is counted apart, for the SFU); u, dt, b, c read once, a read once and
    y written once."""
    ops = b * t * d * (6 * n + 1)
    nbytes = (3 * b * t * d + 2 * b * t * n) * itemsize + d * n * 4
    return ops, nbytes, b * t * d * n
