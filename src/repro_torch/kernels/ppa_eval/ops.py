"""``ppa_eval``: batched design-point PPA evaluation, CUDA kernel + plain.

:func:`ppa_eval_workloads` is what the evaluator and the sweep call: on a
CUDA tensor it makes one launch of the hand-written kernel in
``ppa_eval.cu`` (built with nvcc at first use) for all of the call's
workloads, on the current stream, and counts it once in
``ppa_eval.launches``; on a CPU tensor it runs :func:`ppa_eval_plain`, the
same per-op loop in torch ops, once per workload.  :func:`ppa_eval` is the
single-table entry point, the same kernel at one workload.  There is no
fallback between the two: a CUDA tensor either launches the kernel or
raises.

Replaces the TPU Pallas kernel ``_ppa_kernel`` / ``ppa_eval_fwd`` in
``src/repro/kernels/ppa_eval/kernel.py``; see the note at the top of
``ppa_eval.cu`` for what bounds it on an H100 and how its design meets it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import NVCC_FLAGS, load_library
from repro_torch.perfmodel import workload as W
from repro_torch.perfmodel.hardware import (
    AREA_BASE, AREA_CORE_BASE, AREA_PER_CHANNEL, AREA_PER_GBUF_MB,
    AREA_PER_LINK, AREA_PER_MAC, AREA_PER_SRAM_KB, AREA_PER_VLANE,
    BW_PER_CHANNEL, BW_PER_LINK, CLOCK_HZ, LINK_LATENCY_S)
from repro_torch.perfmodel.roofline import SRAM_FEED_WORDS_PER_KB

SOURCE = Path(__file__).with_name("ppa_eval.cu")
# an empty kernel: the launch floor that bench.py and chip_smoke.py time
FLOOR_SOURCE = Path(__file__).with_name("launch_floor.cu")
FLAGS = NVCC_FLAGS      # bit-exact agreement with the torch path
# ppa_eval.cu's constants (tests/test_torch_ppa_eval.py reads them there)
BLOCK = 256             # threads per block, one design each
MAX_SA = 8              # distinct sa_dim values a block tabulates
MAX_WORKLOADS = 64      # workloads one launch takes
# shared memory per op row: the staged op (32 B) and its (prefix, tiles)
# pair per sa slot; above 48 KB the launch opts in, up to the H100's
# 227 KB a block
SMEM_PER_OP = 32 + MAX_SA * 8
MAX_OPS = 2048          # op rows of one launch, all workloads together

# op-table columns
OP_KIND, OP_FLOPS, OP_BYTES, OP_M, OP_N, OP_K, OP_COMM, OP_COUNT = range(8)


def op_table(wl: W.Workload) -> np.ndarray:
    """Workload -> (n_ops, 8) float64 table in the kernel's column order
    ``[kind, flops, bytes, m, n, k, comm, count]``."""
    a = wl.arrays()
    return np.stack([
        a["kind"].astype(np.float64), a["flops"], a["bytes"],
        a["m"], a["n"], a["k"], a["comm_bytes"], a["count"],
    ], axis=1)


def workload_tp(wl: W.Workload) -> float:
    """The workload's scalar TP degree; the kernel takes one ``tp`` per
    workload, so every op's ``tp`` must agree."""
    tps = np.unique(wl.arrays()["tp"])
    if tps.size != 1:
        raise ValueError(f"ppa_eval needs a uniform per-op tp; workload "
                         f"{wl.name!r} has {tps.tolist()}")
    return float(tps[0])


def op_table_tensor(wl: W.Workload, device) -> torch.Tensor:
    """fp32 op table on `device` (the reference runs without x64)."""
    return torch.as_tensor(op_table(wl), dtype=torch.float32,
                           device=device).contiguous()


@dataclasses.dataclass(frozen=True)
class KernelTables:
    """Several workloads' op tables packed for one launch: their rows one
    after another in ``ops``, workload w's ending at ``ends[w]``, and each
    workload's scalar tp."""

    ops: torch.Tensor
    ends: Tuple[int, ...]
    tps: Tuple[float, ...]

    @classmethod
    def pack(cls, tables: Sequence[Tuple[torch.Tensor, float]]
             ) -> "KernelTables":
        """(op table, tp) pairs -> one packed table, rows kept in order."""
        if not tables:
            raise ValueError("ppa_eval: need at least one op table")
        ops = (tables[0][0] if len(tables) == 1
               else torch.cat([t for t, _ in tables]))
        ends = tuple(int(e) for e in np.cumsum([t.shape[0]
                                                for t, _ in tables]))
        return cls(ops, ends, tuple(float(tp) for _, tp in tables))

    def __len__(self) -> int:
        return len(self.ends)

    def table(self, w: int) -> torch.Tensor:
        """Workload w's (n_ops, 8) rows (a view of ``ops``)."""
        return self.ops[(self.ends[w - 1] if w else 0):self.ends[w]]

    def unpack(self) -> List[Tuple[torch.Tensor, float]]:
        return [(self.table(w), self.tps[w]) for w in range(len(self))]


def kernel_tables(workloads: Sequence[W.Workload], device) -> KernelTables:
    """The workloads' op tables on `device`, packed for
    :func:`ppa_eval_workloads`."""
    return KernelTables.pack([(op_table_tensor(wl, device), workload_tp(wl))
                              for wl in workloads])


def ppa_eval_workloads(dv: torch.Tensor, tables: KernelTables
                       ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                  List[torch.Tensor]]:
    """Every workload of `tables` on the same designs -> (per-workload (B,)
    latencies, (B,) area, per-workload (B, 4) stall sums).  A CUDA tensor
    makes one launch for all of them (counted once in
    ``ppa_eval.launches``); a CPU tensor runs :func:`ppa_eval_plain` per
    workload.  The one place that knows the kernel's output row."""
    if dv.device.type == "cpu":
        _check(dv, tables)
        outs = [ppa_eval_plain(dv, tab, tp) for tab, tp in tables.unpack()]
    else:
        outs = list(_launch(dv, tables))
    return ([o[:, 0] for o in outs], outs[0][:, 5],
            [o[:, 1:5] for o in outs])


def _check(dv: torch.Tensor, tables: KernelTables) -> None:
    for name, t in (("design values", dv), ("op table", tables.ops)):
        if t.dtype != torch.float32:
            raise TypeError(f"ppa_eval: {name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 8:
            raise ValueError(f"ppa_eval: {name} must have shape (n, 8), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ppa_eval: {name} must be contiguous")
    if dv.device != tables.ops.device:
        raise ValueError(f"ppa_eval: design values on {dv.device} but op "
                         f"table on {tables.ops.device}")
    if not 0 < len(tables) <= MAX_WORKLOADS:
        raise ValueError(f"ppa_eval: one launch takes 1..{MAX_WORKLOADS} "
                         f"workloads, got {len(tables)}")
    starts = (0,) + tables.ends[:-1]
    if any(e <= s for s, e in zip(starts, tables.ends)):
        raise ValueError(f"ppa_eval: every op table needs 1 or more rows; "
                         f"row ends {tables.ends}")
    if tables.ends[-1] != tables.ops.shape[0]:
        raise ValueError(f"ppa_eval: row ends {tables.ends} do not cover "
                         f"the {tables.ops.shape[0]} packed rows")
    if tables.ends[-1] > MAX_OPS:
        raise ValueError(
            f"ppa_eval: the op tables of one launch hold {tables.ends[-1]} "
            f"rows, more than {MAX_OPS} ({MAX_OPS * SMEM_PER_OP} B of "
            f"shared memory a block at {SMEM_PER_OP} B a row)")


def _launch(dv: torch.Tensor, tables: KernelTables) -> torch.Tensor:
    """One kernel launch for every workload -> (n_workloads, B, 8)."""
    _check(dv, tables)
    if dv.device.type != "cuda":
        raise ValueError(f"ppa_eval: unsupported device {dv.device}")
    if dv.data_ptr() % 16:
        raise ValueError("ppa_eval: design values must be 16-byte aligned")
    lib = _library()
    n, b = len(tables), dv.shape[0]
    out = torch.empty((n, b, 8), dtype=torch.float32, device=dv.device)
    ends = (ctypes.c_int * n)(*tables.ends)
    tps = (ctypes.c_float * n)(*tables.tps)
    with torch.cuda.device(dv.device):   # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppa_eval_tables_launch(dv.data_ptr(), tables.ops.data_ptr(),
                                         n, ends, tps, out.data_ptr(), b,
                                         stream)
    if err:
        raise RuntimeError("ppa_eval launch failed: "
                           + lib.ppa_eval_error_string(err).decode())
    _count_launch()
    return out


_LAUNCH_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more launch in ``ppa_eval.launches``; a sweep's worker spans
    launch from several threads, and ``+=`` alone can lose a count."""
    with _LAUNCH_LOCK:
        ppa_eval.launches += 1


def ppa_eval(dv: torch.Tensor, table: torch.Tensor, tp: float) -> torch.Tensor:
    """(B, 8) design values x (n_ops, 8) op table -> (B, 8) fp32
    ``[latency, s0, s1, s2, s3, area, 0, 0]``: one workload.

    A CUDA tensor launches the kernel (counted in ``ppa_eval.launches``);
    a CPU tensor runs :func:`ppa_eval_plain`.
    """
    if dv.device.type == "cpu":
        return ppa_eval_plain(dv, table, tp)
    return _launch(dv, KernelTables.pack([(table, tp)]))[0]


ppa_eval.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded and typed once per process (finding
    it hashes the source, a cost no launch should pay)."""
    lib = load_library(SOURCE, FLAGS)
    p = ctypes.c_void_p
    lib.ppa_eval_tables_launch.argtypes = [
        p, p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), p, ctypes.c_longlong, p]
    lib.ppa_eval_tables_launch.restype = ctypes.c_int
    lib.ppa_eval_error_string.argtypes = [ctypes.c_int]
    lib.ppa_eval_error_string.restype = ctypes.c_char_p
    return lib


def ppa_eval_plain(dv: torch.Tensor, table: torch.Tensor,
                   tp: float) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, on any device.

    Mirrors ``ppa_eval.cu`` expression for expression (same per-op loop,
    same operands, same order; the kernel forms some terms once per block
    or per op where this forms them per design), so on the CUDA device it
    equals the kernel bit for bit.  The CPU tests and the on-card
    comparison use it; the main path never does when a card is present.
    """
    _check(dv, KernelTables.pack([(table, tp)]))
    dev = dv.device
    f32 = torch.float32
    links, cores, sub, sa, vw, sram, gbuf_mb, chan = dv.unbind(1)
    tp_t = torch.tensor(float(tp), dtype=f32, device=dev)
    kinds = [int(k) for k in table[:, OP_KIND].tolist()]

    tensor = cores * sub * sa * sa * 2.0 * CLOCK_HZ
    vector = cores * sub * vw * 2.0 * CLOCK_HZ
    mem_bw = chan * BW_PER_CHANNEL
    ici_bw = links * BW_PER_LINK
    gbuf_bytes = gbuf_mb * 2.0**20
    sqrt_f = torch.sqrt(torch.clamp(gbuf_bytes / 2.0, min=1.0))
    sram_need = 6.0 * sa * sa * 2.0 / 1024.0
    u_sram = torch.clamp(sram / sram_need, max=1.0)
    u_feed = torch.clamp(SRAM_FEED_WORDS_PER_KB * sram / (sa * sub), max=1.0)
    par = cores * sub

    zero = torch.zeros_like(cores)
    lat = zero
    stalls = [zero, zero, zero, zero]
    for j, kind in enumerate(kinds):
        op = table[j]
        flops, m, n, k = op[OP_FLOPS], op[OP_M], op[OP_N], op[OP_K]
        comm, count = op[OP_COMM], op[OP_COUNT]
        bytes_eff = op[OP_BYTES].expand_as(cores)
        t_c, t_x = zero, zero
        if kind == W.MATMUL:
            u_k = k / (torch.ceil(k / sa) * sa)
            u_n = n / (torch.ceil(n / sa) * sa)
            u_pipe = m / (m + sa)
            n_tiles = torch.ceil(m / sa) * torch.ceil(n / sa)
            u_par = torch.clamp(n_tiles / par, max=1.0)
            util = u_k * u_n * u_pipe * u_par * u_sram * u_feed
            bound = 2.0 * m * n * k / sqrt_f * 2.0
            bytes_eff = torch.maximum(bytes_eff, bound)
            t_c = flops / (tensor * util)
        elif kind == W.VECTOR:
            t_c = flops / vector
        elif kind == W.ALLREDUCE:
            steps = 2.0 * (tp_t - 1.0)
            t_x = steps / tp_t * comm / ici_bw + steps * LINK_LATENCY_S
        elif kind == W.P2P:
            t_x = ((tp_t - 1.0) / tp_t * comm / ici_bw
                   + (tp_t - 1.0) * LINK_LATENCY_S)
        t_m = bytes_eff / mem_bw
        t_op = torch.maximum(torch.maximum(t_c, t_m), t_x) * count
        dom_comm = (t_x >= t_c) & (t_x >= t_m)
        dom_compute = (t_c > t_m) & ~dom_comm
        cls = torch.where(dom_comm, 3, torch.where(
            dom_compute, 0 if kind == W.MATMUL else 1, 2))
        lat = lat + t_op
        stalls = [s + torch.where(cls == c, t_op, 0.0)
                  for c, s in enumerate(stalls)]

    macs = sub * sa * sa
    vlanes = sub * vw
    core_area = (AREA_CORE_BASE + AREA_PER_MAC * macs
                 + AREA_PER_VLANE * vlanes + AREA_PER_SRAM_KB * sram)
    area = (AREA_BASE + cores * core_area + AREA_PER_GBUF_MB * gbuf_mb
            + AREA_PER_CHANNEL * chan + AREA_PER_LINK * links)
    return torch.stack([lat, *stalls, area, zero, zero], dim=1)


# fp32 operations per design and workload that the function costs, as
# ppa_eval.cu writes them, counting each add/mul/div/sqrt/ceil/min/max/
# compare as one: the per-design terms, then per op the common tail (memory
# term, max, class tests, two adds) plus the kind's own terms.  The kernel
# forms some of them once per block instead of once per design (the staged
# op terms, the per-(op, sa_dim) terms); the count is the function's.
_OPS_PER_DESIGN = 43
_OPS_PER_OP = 9
_OPS_BY_KIND: Dict[int, int] = {W.MATMUL: 30, W.VECTOR: 1, W.MEMCPY: 0,
                                W.ALLREDUCE: 7, W.P2P: 7}


def ppa_eval_op_count(*tables: np.ndarray) -> int:
    """fp32 operations one design costs on these op tables, evaluated in
    one launch (the per-design terms once)."""
    kinds = [int(k) for t in tables for k in np.asarray(t)[:, OP_KIND]]
    return _OPS_PER_DESIGN + sum(_OPS_PER_OP + _OPS_BY_KIND[k]
                                 for k in kinds)
