"""``rwkv6_scan``: the RWKV6 WKV recurrence from a zero state, CUDA kernel
+ plain version.

:func:`rwkv6_scan` is the wrapper the model's RWKV time-mix calls in a
forward pass (no carried state).  On a CUDA tensor it launches the
hand-written kernel in ``rwkv6_scan.cu`` (built with nvcc at first use) on
the current stream and counts the launch in ``rwkv6_scan.launches``; on a
CPU tensor it runs :func:`rwkv6_scan_plain`, the same recurrence in torch
ops.  There is no fallback between the two: a CUDA tensor either launches
the kernel or raises.

Like the TPU kernel it starts from a zero state and returns no state, so
it does not compute a decode step; ``models.ssm.wkv6_scan`` does.

The kernel is a chunked scan over chunks of :data:`CHUNK` steps: a state
pass writes each chunk's incoming state to an fp32 workspace that the
wrapper allocates (``torch.empty``; (B, H, ceil(T / CHUNK) - 1, hd, hd),
as the library states it), and an output pass computes every chunk's y
in parallel from it.

Replaces the TPU Pallas kernel ``_wkv6_kernel`` / ``rwkv6_scan_fwd`` in
``src/repro/kernels/rwkv6_scan/kernel.py``; see the note at the top of
``rwkv6_scan.cu`` for what bounds it on an H100 and how its design meets
it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

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
    a CPU tensor runs :func:`rwkv6_scan_plain`, which also takes float64
    and keeps autograd.  The kernel has no backward yet: on a CUDA tensor
    a call that would need one (grad mode on and an input that requires
    grad) raises ``NotImplementedError`` rather than return an output cut
    from the graph.
    """
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (r, k, v, w, u)):
        raise NotImplementedError(
            "rwkv6_scan: the CUDA kernel has no backward yet, so the ssm "
            "family cannot train on the card (ROADMAP.md §1, 'rwkv6_scan "
            "backward kernel'); run the forward under torch.no_grad()")
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
    return y


rwkv6_scan.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE, FLAGS)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_scan_launch.argtypes = [p, p, p, p, p, p, p,
                                          ctypes.c_longlong, i, i, i, i, i, p]
        lib.rwkv6_scan_launch.restype = i
        lib.rwkv6_scan_workspace_floats.argtypes = [i, i, i, i]
        lib.rwkv6_scan_workspace_floats.restype = ctypes.c_longlong
        lib.rwkv6_scan_smem_bytes.argtypes = [i, i]
        lib.rwkv6_scan_smem_bytes.restype = i
        lib.rwkv6_scan_error_string.argtypes = [i]
        lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def smem_bytes(hd: int) -> dict:
    """Dynamic shared memory of one block of each of the kernel's two
    passes at head size `hd`, as the built library states it (builds the
    library if needed)."""
    lib = _library()
    return {"state": int(lib.rwkv6_scan_smem_bytes(hd, 0)),
            "out": int(lib.rwkv6_scan_smem_bytes(hd, 1))}


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The kernel's recurrence in torch ops, on any device: fp32 state
    (B, H, hd, hd) from zero (fp64 for fp64 inputs), one step per time
    index; y in r's dtype."""
    _check(r, k, v, w, u)
    b, t, h, hd = r.shape
    cdt = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf = (x.to(cdt) for x in (r, k, v, w))
    s = torch.zeros((b, h, hd, hd), dtype=cdt, device=r.device)
    uu = u[None, :, :, None]
    ys = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]     # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uu * kv))
        s = wf[:, i, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype)


def rwkv6_scan_cost(b: int, t: int, h: int, hd: int, itemsize: int):
    """(operations, bytes) the function needs, r, k, v, w read once, u
    read once and y written once.  Per step and head, factored as
    ``y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i``: 2 hd^2 for r.S, 3 hd
    for r.(u*k), 2 hd for v*c + (r.S); and 3 hd^2 for the update
    ``S_ij = w_i S_ij + k_i v_j``."""
    ops = b * t * h * (5 * hd * hd + 5 * hd)
    nbytes = 5 * b * t * h * hd * itemsize + h * hd * 4
    return ops, nbytes
