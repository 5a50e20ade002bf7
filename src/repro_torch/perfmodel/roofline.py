"""Vectorized roofline evaluation of (designs x workload ops) in torch.

Per-op time = max(compute-term, memory-term, interconnect-term) under an
effective-throughput model that couples every design-space parameter to the
metrics it physically influences:

* systolic utilization   <- sa_dim vs matmul dims (padding + pipeline fill),
  sublane/core tile parallelism, SRAM double-buffer capacity;
* HBM traffic            <- compulsory bytes vs blocked-matmul I/O lower
  bound 2*M*N*K/sqrt(gbuf) (global-buffer reuse);
* collectives            <- ring all-reduce / all-to-all on the ICI links.

Arithmetic contract.  Every expression below is evaluated in fp32 in the
reference's order, and every reduction over ops is a left-to-right sum in op
order (:func:`_seq_sum`), never a library reduction whose order depends on
the device or the row's alignment.  That makes three things bit-identical:
the stacked and looped evaluator paths, the port's CPU and CUDA runs of this
module, and this module and the CUDA ``ppa_eval`` kernel (which adds the
ops in the same order with no fused multiply-adds).
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.perfmodel import workload as W
from repro_torch.perfmodel.designspace import DesignSpace, SPACE
from repro_torch.perfmodel.hardware import BYTES_FP16, LINK_LATENCY_S

# stall classes (aligned with critical_path.STALL_CLASSES)
TENSOR, VECTORU, MEMORY, INTERCONNECT = 0, 1, 2, 3

# SRAM operand-feed bandwidth: words/cycle supplied per KB of per-core SRAM.
# Calibrated so the A100 point (128 KB feeding a 16x16 array x 4 sublanes)
# is exactly unconstrained while a 32x32 array x 4 sublanes on the same SRAM
# runs at 62.5% feed utilization (the Table-4 deltas of designs A/B).
SRAM_FEED_WORDS_PER_KB = 0.625


def _ceil_div(a, b):
    return torch.ceil(a / b)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis: ``((x0 + x1) + x2) + ...``.

    The one reduction order every path of the port (and the CUDA kernel)
    uses, so sums agree bit for bit across paths and devices.
    """
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def matmul_utilization(hw: Dict[str, torch.Tensor], m, n, k) -> torch.Tensor:
    """Fraction of peak tensor throughput achieved on an (m,k)x(k,n) matmul.

      u_pad  — K and N pad to the sa_dim grid (weight-stationary mapping);
      u_pipe — pipeline fill: m rows stream through a sa-deep array;
      u_par  — not enough independent output tiles to fill cores*sublanes;
      u_sram — double-buffered A/B/C tiles must fit the per-core SRAM;
      u_feed — SRAM operand-feed bandwidth vs the array's consumption.
    """
    sa = hw["sa_dim"]
    u_k = k / (_ceil_div(k, sa) * sa)
    u_n = n / (_ceil_div(n, sa) * sa)
    u_pipe = m / (m + sa)
    n_tiles = _ceil_div(m, sa) * _ceil_div(n, sa)
    u_par = torch.clamp(n_tiles / (hw["core_count"] * hw["sublane_count"]),
                        max=1.0)
    sram_need_kb = 3.0 * 2.0 * sa * sa * BYTES_FP16 / 1024.0   # A,B,C x dbuf
    u_sram = torch.clamp(hw["sram_kb"] / sram_need_kb, max=1.0)
    u_feed = torch.clamp(SRAM_FEED_WORDS_PER_KB * hw["sram_kb"]
                         / (sa * hw["sublane_count"]), max=1.0)
    return u_k * u_n * u_pipe * u_par * u_sram * u_feed


def matmul_hbm_bytes(hw, compulsory, m, n, k) -> torch.Tensor:
    """Blocked-matmul HBM traffic: max(compulsory, I/O lower bound given the
    global buffer as the reuse capacity)."""
    f_elems = torch.clamp(hw["gbuf_bytes"] / BYTES_FP16, min=1.0)
    bound = 2.0 * m * n * k / torch.sqrt(f_elems) * BYTES_FP16
    return torch.maximum(compulsory, bound)


def ring_allreduce_time(hw, nbytes, tp) -> torch.Tensor:
    steps = 2.0 * (tp - 1.0)
    return steps / tp * nbytes / hw["ici_bw"] + steps * LINK_LATENCY_S


def a2a_time(hw, nbytes, tp) -> torch.Tensor:
    return (tp - 1.0) / tp * nbytes / hw["ici_bw"] + (tp - 1.0) * LINK_LATENCY_S


def _space_key(space: DesignSpace) -> tuple:
    return tuple(tuple(float(v) for v in c) for c in space.choices)


def _workload_fingerprint(wl: W.Workload) -> str:
    a = wl.arrays()
    h = hashlib.sha1()
    for kk in sorted(a):
        h.update(kk.encode())
        h.update(np.ascontiguousarray(a[kk]).tobytes())
    return h.hexdigest()


def ops_to_tensors(ops: Mapping[str, np.ndarray],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Op-field arrays -> tensors on `device`: ``kind`` int32, the rest fp32
    (the reference runs without x64, so its float64 tables become fp32)."""
    return {kk: torch.as_tensor(np.asarray(vv),
                                dtype=torch.int32 if kk == "kind"
                                else torch.float32, device=device)
            for kk, vv in ops.items()}


def _batch_bucket(b: int) -> int:
    """Round a batch size up to the next power of two (min 8)."""
    bb = 8
    while bb < b:
        bb *= 2
    return bb


def _to_host(tree, b: int):
    if isinstance(tree, dict):
        return {k: _to_host(v, b) for k, v in tree.items()}
    return tree[:b].cpu().numpy()


def _bucketed_call(fn: Callable, idx: np.ndarray, device: torch.device):
    """Pad an index batch to its power-of-two bucket with its last row, call
    `fn` on the device, and bring every output leaf back to the host sliced
    to the true batch size.

    Every op the port runs is row-independent, so the padding never changes
    a row's result; it keeps the batch shapes a caller sees to a handful,
    as in the reference (whose jit compiles once per shape).
    """
    idx = np.atleast_2d(np.asarray(idx, dtype=np.int32))
    b = idx.shape[0]
    bb = _batch_bucket(b)
    if bb != b:                       # pad with the last row; slice back
        idx = np.concatenate([idx, np.repeat(idx[-1:], bb - b, axis=0)])
    out = fn(torch.as_tensor(idx, device=device))
    return _to_host(out, b)


def _dominant_class(t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dominant-resource class per op from `_op_terms` components.

    Ties: comm wins on >=, compute needs a strict > over memory; pure memcpy
    ops always attribute to MEMORY.
    """
    t_compute, t_memory, t_comm = t["t_compute"], t["t_memory"], t["t_comm"]
    dom_is_comm = (t_comm >= t_compute) & (t_comm >= t_memory)
    dom_is_compute = (t_compute > t_memory) & ~dom_is_comm
    per_unit = torch.where(t["is_mm"], TENSOR, VECTORU)
    dom_class = torch.where(
        dom_is_comm, INTERCONNECT,
        torch.where(dom_is_compute, per_unit, MEMORY))
    return torch.where(t["is_mem"], MEMORY, dom_class).to(torch.int32)


def _attribute(t: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stall attribution for `_op_terms` output: each op's time goes to its
    dominant resource.  Returns (dom_class (B, ops), stall (B, 4))."""
    dom_class = _dominant_class(t)
    t_op = t["t_op"]
    stall = torch.stack(
        [_seq_sum(torch.where(dom_class == c, t_op, 0.0)) for c in range(4)],
        dim=1)
    return dom_class, stall


class RooflineModel:
    """Per-workload op-term model: the building block every
    :class:`~repro_torch.perfmodel.evaluator.ModelEvaluator` (and the sweep
    engine's chunk step) composes via :meth:`_workload_batch`."""

    # Compass-tier knobs (overridden by CompassModel)
    op_overhead_s: float = 0.0        # fixed per-op launch overhead
    nonoverlap: float = 0.0           # fraction of the minor term not hidden
    mem_efficiency: float = 1.0       # achievable fraction of peak HBM bw

    def __init__(self, wl: W.Workload, space: DesignSpace = SPACE):
        self.wl = wl
        self.space = space
        self._arrays = wl.arrays()
        self._dev_ops: Dict[str, Dict[str, torch.Tensor]] = {}

    def ops_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """This workload's op table as tensors on `device` (cached)."""
        key = str(device)
        ops = self._dev_ops.get(key)
        if ops is None:
            ops = self._dev_ops[key] = ops_to_tensors(self._arrays, device)
        return ops

    # ------------------------------------------------------------------
    def _op_terms(self, hwb: Dict[str, torch.Tensor],
                  ops: Optional[Dict[str, torch.Tensor]] = None,
                  ) -> Dict[str, torch.Tensor]:
        """Per-op time terms for (B, 1)-broadcast hardware dicts.

        ``ops`` overrides the model's own op table — the stacked path feeds
        the deduped union of a :class:`~repro_torch.perfmodel.workload.
        WorkloadStack` through the same math (``t_unit`` is the count-free
        per-op time the gather reassembly multiplies back out).
        """
        o = (self.ops_on(hwb["sa_dim"].device) if ops is None else ops)
        kind = o["kind"][None, :]
        flops = o["flops"][None, :]
        m, n, k = o["m"][None, :], o["n"][None, :], o["k"][None, :]
        comm = o["comm_bytes"][None, :]
        count = o["count"][None, :]
        tp = o["tp"][None, :]

        util = matmul_utilization(hwb, m, n, k)
        eff_tensor = hwb["tensor_flops"] * util
        is_mm = kind == W.MATMUL
        is_vec = kind == W.VECTOR
        is_mem = kind == W.MEMCPY
        is_ar = kind == W.ALLREDUCE
        is_p2p = kind == W.P2P

        bytes_eff = torch.where(
            is_mm, matmul_hbm_bytes(hwb, o["bytes"][None, :], m, n, k),
            o["bytes"][None, :])

        t_compute = torch.where(
            is_mm, flops / eff_tensor,
            torch.where(is_vec, flops / hwb["vector_flops"], 0.0))
        t_memory = bytes_eff / (hwb["mem_bw"] * self.mem_efficiency)
        t_comm = torch.where(
            is_ar, ring_allreduce_time(hwb, comm, tp),
            torch.where(is_p2p, a2a_time(hwb, comm, tp), 0.0))

        major = torch.maximum(torch.maximum(t_compute, t_memory), t_comm)
        minor = t_compute + t_memory + t_comm - major
        t_unit = major + self.nonoverlap * minor + self.op_overhead_s
        t_op = t_unit * count
        return {
            "t_op": t_op, "t_unit": t_unit, "t_compute": t_compute,
            "t_memory": t_memory, "t_comm": t_comm, "count": count,
            "is_mm": is_mm, "is_mem": is_mem,
        }

    def _workload_batch(self, hwb: Dict[str, torch.Tensor],
                        detail: str = "stalls") -> Dict[str, torch.Tensor]:
        """Per-workload outputs for (B, 1)-broadcast hardware tensors.

        detail: "objectives" -> latency only; "ppa" adds the per-op
        breakdown; "stalls" adds stall attribution on top of "ppa".
        """
        t = self._op_terms(hwb)
        latency = _seq_sum(t["t_op"])
        if detail == "objectives":
            return {"latency": latency}
        count = t["count"]
        out = {
            "latency": latency,
            "op_time": t["t_op"],
            "t_compute": t["t_compute"] * count,
            "t_memory": t["t_memory"] * count,
            "t_comm": t["t_comm"] * count,
        }
        if detail == "stalls":
            dom_class, stall = _attribute(t)
            out["op_class"] = dom_class
            out["stall"] = stall            # (B, 4) seconds per stall class
        return out


# --------------------------------------------------------------------------
# stacked-workload evaluation: op terms ONCE over the deduped union
# --------------------------------------------------------------------------

def stacked_workload_batches(model: RooflineModel,
                             stack: "W.WorkloadStack",
                             hwb: Dict[str, torch.Tensor],
                             detail: Union[str, Mapping[str, str]] = "stalls",
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every workload's ``_workload_batch`` outputs from ONE op-term pass.

    ``model`` supplies the op-term math (class + compass knobs — every
    workload in the stack must share them); its :meth:`RooflineModel.
    _op_terms` runs once over ``stack.unique`` (count-free ``t_unit``), and
    each workload's per-op arrays are reassembled by gathering its rows out
    of the union and multiplying its own counts back in.  Every per-op value
    is elementwise in the op fields and every reduction is the same
    :func:`_seq_sum`, so the result is BIT-IDENTICAL to looping
    ``_workload_batch`` per workload.

    ``detail`` is one level for all workloads or a per-workload mapping.
    """
    device = hwb["sa_dim"].device
    uops = ops_to_tensors(stack.unique, device)
    uops["count"] = torch.ones(stack.n_unique, dtype=torch.float32,
                               device=device)
    t = model._op_terms(hwb, ops=uops)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for nm in stack.names:
        d = detail if isinstance(detail, str) else detail[nm]
        mp = torch.as_tensor(stack.op_map[nm], dtype=torch.long, device=device)
        cnt = torch.as_tensor(stack.counts[nm], dtype=torch.float32,
                              device=device)[None, :]
        t_op = t["t_unit"][:, mp] * cnt
        latency = _seq_sum(t_op)
        if d == "objectives":
            out[nm] = {"latency": latency}
            continue
        ow = {
            "latency": latency,
            "op_time": t_op,
            "t_compute": t["t_compute"][:, mp] * cnt,
            "t_memory": t["t_memory"][:, mp] * cnt,
            "t_comm": t["t_comm"][:, mp] * cnt,
        }
        if d == "stalls":
            tw = {
                "t_op": t_op,
                "t_compute": t["t_compute"][:, mp],
                "t_memory": t["t_memory"][:, mp],
                "t_comm": t["t_comm"][:, mp],
                "is_mm": t["is_mm"][:, mp],
                "is_mem": t["is_mem"][:, mp],
            }
            dom_class, stall = _attribute(tw)
            ow["op_class"] = dom_class
            ow["stall"] = stall
        out[nm] = ow
    return out
