"""``pareto_reduce``: the exact Pareto entrants of a batch, CUDA kernel +
plain.

:func:`pareto_reduce` screens the candidate rows of a batch (a keep mask
over its rows) against each other and against an archive's rows (the
front) with :class:`~repro_torch.core.pareto.ParetoArchive`'s dominance
rule, on the device that holds them.  It returns ``(head, rows)``: ``head``
(2 + f,) int32 is ``[n candidates, m entering, the dead flag of each front
row]`` and the first m rows of ``rows`` (int32, 4 columns) are the
entering rows, the three objectives' float32 bits and the row's id.
:func:`entrants` brings both to the host in one wait, ordered by id, in the
form :meth:`ParetoArchive.apply` takes.

On a CUDA tensor it sorts the rows' keys with ``torch.sort`` and launches
the hand-written kernels of ``pareto_reduce.cu`` (built with nvcc at first
use) on the current stream, counted once a call in
``pareto_reduce.launches``; it never synchronises.  On a CPU tensor it runs
:func:`pareto_reduce_plain`, the same function in blocked torch ops.  There
is no fallback between the two.

Replaces no TPU kernel: the JAX package screens a sweep chunk's survivors
on the host in ``repro.core.pareto.ParetoArchive.insert``; see the note at
the top of ``pareto_reduce.cu`` for why the port moved it onto the card and
what bounds it there (pair tests).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import NVCC_FLAGS, load_library

SOURCE = Path(__file__).with_name("pareto_reduce.cu")
FLAGS = NVCC_FLAGS      # comparisons only: bit-exact flags
N_OBJ = 3               # objectives a row holds (the kernel's layout)
FLT_MAX = float(np.finfo(np.float32).max)
# pareto_reduce.cu's operations a pair test: six compares, five logic ops
OPS_PER_TEST = 11


def _check(ys: torch.Tensor, front: torch.Tensor, keep: torch.Tensor,
           ids: torch.Tensor, weights: Sequence[float]) -> None:
    for name, t in (("rows", ys), ("front", front)):
        if t.dtype != torch.float32:
            raise TypeError(f"pareto_reduce: {name} must be float32, "
                            f"got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != N_OBJ:
            raise ValueError(f"pareto_reduce: {name} must have shape "
                             f"(n, {N_OBJ}), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pareto_reduce: {name} must be contiguous")
        if t.device != ys.device:
            raise ValueError(f"pareto_reduce: rows on {ys.device} but "
                             f"{name} on {t.device}")
    for name, t, dtype in (("keep", keep, torch.bool),
                           ("ids", ids, torch.int32)):
        if t.dtype != dtype or t.shape != (ys.shape[0],):
            raise ValueError(f"pareto_reduce: {name} must be ({ys.shape[0]},)"
                             f" {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.device != ys.device:
            raise ValueError(f"pareto_reduce: {name} must be contiguous, on "
                             f"{ys.device}")
    if len(weights) != N_OBJ or not all(0.0 < w < math.inf for w in weights):
        raise ValueError(f"pareto_reduce: weights must be {N_OBJ} positive "
                         f"finite floats, got {list(weights)}")
    if ys.shape[0] >= 2**31:
        raise ValueError("pareto_reduce: at most 2**31 - 1 rows a call")


def _weights(weights: Optional[Sequence[float]]) -> Tuple[float, ...]:
    """The key's weights, rounded to float32 as the kernel takes them."""
    w = (1.0,) * N_OBJ if weights is None else weights
    return tuple(float(np.float32(x)) for x in w)


def pareto_reduce(ys: torch.Tensor, front: torch.Tensor,
                  keep: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[Sequence[float]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of `ys` (c, 3) that `keep` (c,) marks, screened against
    each other and against `front` (f, 3), on their
    device -> ``(head, rows)``: ``head`` (2 + f,) int32 ``[n, m, dead...]``
    and ``rows`` (>= m, 4) int32 holding the m entering rows (objective
    bits, id) first.

    A row enters when no other candidate and no front row dominates it; a
    front row is dead when an entering row dominates it.  `ids` (c,) int32
    labels the rows.  `weights` (3 positive
    floats, default ones) scale the objectives in the sort key, which
    orders the work and never the result: pass about 1 / each objective's
    typical size.  A CUDA tensor launches the kernel (counted in
    ``pareto_reduce.launches``); a CPU tensor runs
    :func:`pareto_reduce_plain`."""
    w = _weights(weights)
    _check(ys, front, keep, ids, w)
    if ys.device.type == "cpu":
        return pareto_reduce_plain(ys, front, keep, ids, w)
    return _launch(ys, front, keep, ids, w)


pareto_reduce.launches = 0

_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more call in ``pareto_reduce.launches``; a sweep's worker spans
    launch from several threads, and ``+=`` alone can lose a count."""
    with _LAUNCH_LOCK:
        pareto_reduce.launches += 1


def _launch(ys: torch.Tensor, front: torch.Tensor, keep: torch.Tensor,
            ids: torch.Tensor, w: Tuple[float, ...]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if ys.device.type != "cuda":
        raise ValueError(f"pareto_reduce: unsupported device {ys.device}")
    c, f, dev = ys.shape[0], front.shape[0], ys.device
    if c == 0:
        return (torch.zeros(2 + f, dtype=torch.int32, device=dev),
                torch.empty((0, 4), dtype=torch.int32, device=dev))
    lib = _library()
    head = torch.empty(2 + f, dtype=torch.int32, device=dev)
    key = torch.empty(c, dtype=torch.float32, device=dev)
    rows = torch.empty((c, 4), dtype=torch.float32, device=dev)
    rid = torch.empty(c, dtype=torch.int32, device=dev)
    out = torch.empty((c, 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):         # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pareto_key_launch(ys.data_ptr(), keep.data_ptr(), c, *w,
                                    key.data_ptr(), stream)
        _raise(lib, err)
        skey, perm = torch.sort(key)
        err = lib.pareto_reduce_launch(
            ys.data_ptr(), skey.data_ptr(), perm.data_ptr(), ids.data_ptr(),
            c, front.data_ptr(), f, rows.data_ptr(), rid.data_ptr(),
            out.data_ptr(), head.data_ptr(), stream)
        _raise(lib, err)
    _count_launch()
    return head, out


def _raise(lib: ctypes.CDLL, err: int) -> None:
    if err:
        raise RuntimeError("pareto_reduce launch failed: "
                           + lib.pareto_reduce_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded and typed once per process."""
    lib = load_library(SOURCE, FLAGS)
    p, f32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
    lib.pareto_key_launch.argtypes = [p, p, i64, f32, f32, f32, p, p]
    lib.pareto_key_launch.restype = ctypes.c_int
    lib.pareto_reduce_launch.argtypes = [p, p, p, p, i64, p, ctypes.c_int,
                                         p, p, p, p, p]
    lib.pareto_reduce_launch.restype = ctypes.c_int
    lib.pareto_reduce_error_string.argtypes = [ctypes.c_int]
    lib.pareto_reduce_error_string.restype = ctypes.c_char_p
    return lib


def sort_key(ys: torch.Tensor, w: Tuple[float, ...]) -> torch.Tensor:
    """The kernel's key of each row, in torch ops: (y0 w0 + y1 w1) + y2 w2
    in float32, NaN and anything above it clamped to FLT_MAX.  Rounding is
    monotone, so a row's dominators all have keys <= its own."""
    k = (ys[:, 0] * w[0] + ys[:, 1] * w[1]) + ys[:, 2] * w[2]
    return torch.nan_to_num(k, nan=FLT_MAX, posinf=FLT_MAX,
                            neginf=-math.inf)


def _dominated(doms: torch.Tensor, blk: torch.Tensor,
               width: int) -> torch.Tensor:
    """Rows of blk (b, 3) dominated by some row of doms (d, 3), taking
    doms `width` rows at a time (no b x d matrix beyond b x width)."""
    dead = torch.zeros(blk.shape[0], dtype=torch.bool, device=blk.device)
    for s in range(0, doms.shape[0], width):
        d = doms[s:s + width]
        all_le = torch.ones((blk.shape[0], d.shape[0]), dtype=torch.bool,
                            device=blk.device)
        any_lt = torch.zeros_like(all_le)
        for j in range(N_OBJ):
            dj, bj = d[:, j][None, :], blk[:, j][:, None]
            all_le &= dj <= bj
            any_lt |= dj < bj
        dead |= (all_le & any_lt).any(dim=1)
    return dead


def pareto_reduce_plain(ys: torch.Tensor, front: torch.Tensor,
                        keep: torch.Tensor, ids: torch.Tensor,
                        weights: Optional[Sequence[float]] = None,
                        block: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pareto_reduce` in torch ops, on any device, with the entering
    rows in position order.

    The candidates go in key order, `block` at a time.  A block's
    dominators are the front, the rows that entered from earlier blocks,
    and the sorted rows whose keys lie within the block's (its ties
    included): a dominator with a smaller key was either an entering row
    or is dominated by one (dominance is transitive, and what dominates a
    row has a key <= its own), so nothing else is needed.  No (n, n)
    matrix is built."""
    w = _weights(weights)
    dev = ys.device
    pos = torch.nonzero(keep).squeeze(1)
    n = pos.numel()
    cand = ys[pos]
    key = sort_key(cand, w)
    order = torch.argsort(key, stable=True)
    ys_s, key_s = cand[order], key[order]
    enter_s = torch.zeros(n, dtype=torch.bool, device=dev)
    known = [front]                     # front rows, then entering rows
    for s in range(0, n, block):
        e = min(s + block, n)
        lo = int(torch.searchsorted(key_s, key_s[s:s + 1]))
        hi = int(torch.searchsorted(key_s, key_s[e - 1:e], right=True))
        doms = torch.cat(known + [ys_s[lo:hi]])
        ok = ~_dominated(doms, ys_s[s:e], 4 * block)
        enter_s[s:e] = ok
        known.append(ys_s[s:e][ok])
    enter_pos = torch.sort(pos[order[enter_s]]).values
    y_in = ys[enter_pos]
    dead = _dominated(y_in, front, 4 * block)
    m = enter_pos.numel()
    head = torch.cat([torch.tensor([n, m], dtype=torch.int32, device=dev),
                      dead.to(torch.int32)])
    rows = torch.cat([y_in.contiguous().view(torch.int32),
                      ids[enter_pos][:, None]], dim=1)
    return head, rows


def entrants(head: torch.Tensor, rows: torch.Tensor
             ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """A :func:`pareto_reduce` result on the host -> (n candidates, (m, 3)
    float64 entering rows, their int64 ids, (f,) bool dead flags), the
    rows ordered by id.  Copying ``head`` is the one wait for the device;
    the m rows follow it."""
    h = head.cpu().numpy()
    n, m = int(h[0]), int(h[1])
    got = rows[:m].cpu().numpy() if m else np.zeros((0, 4), np.int32)
    got = got[np.argsort(got[:, 3], kind="stable")]
    y = np.ascontiguousarray(got[:, :N_OBJ]).view(np.float32)
    return (n, y.astype(np.float64), got[:, 3].astype(np.int64),
            h[2:].astype(bool))


def pareto_reduce_cost(c: int, n: int, f: int, m: int) -> dict:
    """The least work of one call on `c` rows with `n` candidates, `f`
    front rows and `m` entering: a pair test for each dominated candidate
    (against one dominator), for each entering row against every other
    entering row and every front row, and for each front row against the
    entering rows (``tests``; ``ops`` at OPS_PER_TEST a test), and the
    inputs read and outputs written once (``bytes``: rows, keep mask and
    ids of the c rows, the front; the head and the m entering rows)."""
    c, n, f, m = int(c), int(n), int(f), int(m)
    tests = (n - m) + m * max(m - 1, 0) + 2 * m * f
    return {"tests": tests, "ops": OPS_PER_TEST * tests,
            "bytes": 17 * c + 12 * f + 4 * (2 + f) + 16 * m}
