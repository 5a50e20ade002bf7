"""Plain PyTorch reference of LUMINA's full-space design sweep.

The design space (the paper's Table 1: 4,741,632 GPU-node designs), the
operator graph of an LM's prefill and decode at a tensor-parallel degree,
the derived hardware and die area, and the roofline model (each op's time
the largest of its compute, HBM and interconnect terms, summed over the
ops in order) are written out here from their definitions, in fp32 in the
order the model states.  Over every design, in blocks, the reference then
takes what a sweep reports: how many designs beat the A100 reference on
all three objectives (prefill latency, decode latency, area), the best
designs of each objective, the best designs by prefill latency of each
dominant stall class, and the exact Pareto front.

This file imports torch alone and nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

# ------------------------------------------------------------- the space
CHOICES = (
    (6, 12, 18, 24),                                           # links
    (1, 2, 4, 8, 16, 32, 64, 96, 108, 128, 132, 136, 140, 256),  # cores
    (1, 2, 4, 8),                                              # sublanes
    (4, 8, 16, 32, 64, 128),                                   # sa_dim
    (4, 8, 16, 32, 64, 128),                                   # vector width
    (32, 64, 128, 192, 256, 512, 1024),                        # sram KB
    (32, 64, 128, 256, 320, 512, 1024),                        # gbuf MB
    tuple(range(1, 13)),                                       # HBM channels
)
CARDS = tuple(len(c) for c in CHOICES)
SIZE = math.prod(CARDS)
A100 = (12, 108, 4, 16, 32, 128, 40, 5)     # its 40 MB snaps to the nearest

# hardware constants (A100-calibrated)
CLOCK_HZ, BW_CHANNEL, BW_LINK, LINK_LATENCY_S = 1.41e9, 311.0e9, 25.0e9, 1e-6
FEED_WORDS_PER_KB = 0.625
BYTES = 2                                   # fp16 operands

MATMUL, VECTOR, MEMCPY, ALLREDUCE, P2P = range(5)
TENSOR, VECTOR_UNIT, MEMORY, INTERCONNECT = range(4)
FIELDS = ("kind", "flops", "bytes", "m", "n", "k", "comm", "count")


def decode(flat: torch.Tensor) -> List[torch.Tensor]:
    """Flat ids (mixed radix, the last parameter fastest) -> the eight
    parameters' values, fp32."""
    cols, rem = [], flat.long()
    for c in reversed(CARDS):
        cols.append(rem % c)
        rem = rem // c
    cols = cols[::-1]
    return [torch.tensor(ch, dtype=torch.float32, device=flat.device)[i]
            for ch, i in zip(CHOICES, cols)]


def nearest_id(values) -> int:
    flat = 0
    for ch, v, c in zip(CHOICES, values, CARDS):
        i = min(range(c), key=lambda j: (abs(ch[j] - v), j))
        flat = flat * c + i
    return flat


# ------------------------------------------------------------- the ops
def _mm(m, k, n, count=1.0):
    return (MATMUL, 2.0 * m * k * n, (m * k + k * n + m * n) * BYTES,
            m, n, k, 0.0, count)


def _vec(elems, flops_per_elem, count=1.0):
    return (VECTOR, flops_per_elem * elems, 2.0 * elems * BYTES,
            1.0, 1.0, 1.0, 0.0, count)


def _copy(nbytes, count=1.0):
    return (MEMCPY, 0.0, nbytes, 1.0, 1.0, 1.0, 0.0, count)


def _reduce(elems, count=1.0):
    return (ALLREDUCE, 0.0, 0.0, 1.0, 1.0, 1.0, elems * BYTES, count)


def _p2p(nbytes, count=1.0):
    return (P2P, 0.0, 0.0, 1.0, 1.0, 1.0, nbytes, count)


def ops(a: dict, batch: int, seq: int, tp: int, decode_step: bool,
        kv_len: Optional[int] = None) -> List[tuple]:
    """The operator graph of a transformer LM (dense or MoE FFN) per
    tensor-parallel rank: the embedding read, the norms, each layer's
    attention (fused QKV, scores, softmax, PV, KV write or read, output
    projection, all-reduce) and FFN (gated up, activation, down,
    all-reduce; for MoE the router, top-k, an all-to-all each way around
    the experts' FFN over the tokens a rank receives, and the shared
    experts' gated FFN), then the rank's slice of the head."""
    kv_len = kv_len or seq
    q = 1 if decode_step else seq
    d, L = a["d_model"], a["n_layers"]
    h, kvh, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    M = batch * q
    hl, kvl = max(1, h // tp), max(1, kvh // tp)
    out = [_copy(M * d * BYTES), _vec(2 * M * d, 8.0, L)]
    out.append(_mm(M, d, h * hd // tp + 2 * kvh * hd // tp, L))
    if decode_step:
        out += [_copy(batch * kv_len * 2 * kvl * hd * BYTES, L),
                (MATMUL, 2.0 * batch * hl * kv_len * hd * 2,
                 batch * hl * (kv_len + hd) * BYTES, batch, kv_len, hd, 0.0,
                 L),
                _vec(batch * hl * kv_len, 6.0, L),
                _copy(batch * 2 * kvl * hd * BYTES, L)]
    else:
        out += [_mm(q, hd, kv_len, L * batch * hl),
                _vec(batch * hl * q * kv_len, 6.0, L),
                _mm(q, kv_len, hd, L * batch * hl),
                _copy(batch * q * 2 * kvl * hd * BYTES, L)]
    out += [_mm(M, h * hd // tp, d, L), _reduce(M * d, L)]
    if a.get("n_experts"):
        e, k, f = a["n_experts"], a["top_k"], a["expert_ff"]
        payload = M * k * d * BYTES
        m_eff = M * k / tp
        out += [_mm(M, d, e, L), _vec(M * e, 4.0, L), _p2p(payload, L),
                _mm(m_eff, d, 2 * f, L), _vec(m_eff * f, 8.0, L),
                _mm(m_eff, f, d, L), _p2p(payload, L)]
        if a.get("n_shared_experts"):
            out += _ffn(M, d, f * a["n_shared_experts"], tp, L)
    else:
        out += _ffn(M, d, a["d_ff"], tp, L)
    out.append(_mm(M, d, a["vocab"] // tp))
    return [tuple(float(v) for v in o) + (float(tp),) for o in out]


def _ffn(M, d, d_ff, tp, count):
    return [_mm(M, d, 2 * d_ff // tp, count), _vec(M * d_ff // tp, 8.0, count),
            _mm(M, d_ff // tp, d, count), _reduce(M * d, count)]


def op_table(op_list: List[tuple], device, dtype=torch.float32
             ) -> Dict[str, torch.Tensor]:
    cols = list(zip(*op_list))
    t = {f: torch.tensor(c, dtype=dtype, device=device)[None, :]
         for f, c in zip(FIELDS + ("tp",), cols)}
    t["kind"] = torch.tensor(cols[0], dtype=torch.int32, device=device)[None, :]
    return t


# ------------------------------------------------------------- the model
def hardware(v: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    links, cores, sub, sa, vw, sram, gbuf, ch = v
    core = (2.924 + 1.826e-4 * (sub * sa * sa) + 0.008 * (sub * vw)
            + 0.0081 * sram)
    return {
        "tensor": cores * sub * sa * sa * 2.0 * CLOCK_HZ,
        "vector": cores * sub * vw * 2.0 * CLOCK_HZ,
        "mem_bw": ch * BW_CHANNEL,
        "ici_bw": links * BW_LINK,
        "sram": sram, "gbuf": gbuf * 2.0 ** 20, "sa": sa, "sub": sub,
        "cores": cores,
        "area": 140.0 + cores * core + 0.72 * gbuf + 15.0 * ch + 1.8 * links,
    }


def op_times(hw: Dict[str, torch.Tensor], o: Dict[str, torch.Tensor]):
    """Per design and op: (time, dominant stall class)."""
    c = {k: v[:, None] for k, v in hw.items()}
    sa = c["sa"]
    m, n, k = o["m"], o["n"], o["k"]
    util = (k / (torch.ceil(k / sa) * sa)) * (n / (torch.ceil(n / sa) * sa)) \
        * (m / (m + sa)) \
        * torch.clamp(torch.ceil(m / sa) * torch.ceil(n / sa)
                      / (c["cores"] * c["sub"]), max=1.0) \
        * torch.clamp(c["sram"] / (3.0 * 2.0 * sa * sa * BYTES / 1024.0),
                      max=1.0) \
        * torch.clamp(FEED_WORDS_PER_KB * c["sram"] / (sa * c["sub"]),
                      max=1.0)
    is_mm, is_vec = o["kind"] == MATMUL, o["kind"] == VECTOR
    is_mem = o["kind"] == MEMCPY
    blocked = 2.0 * m * n * k / torch.sqrt(
        torch.clamp(c["gbuf"] / BYTES, min=1.0)) * BYTES
    nbytes = torch.where(is_mm, torch.maximum(o["bytes"], blocked),
                         o["bytes"])
    compute = torch.where(is_mm, o["flops"] / (c["tensor"] * util),
                          torch.where(is_vec, o["flops"] / c["vector"], 0.0))
    memory = nbytes / (c["mem_bw"] * 1.0)
    tp = o["tp"]
    steps = 2.0 * (tp - 1.0)
    ring = steps / tp * o["comm"] / c["ici_bw"] + steps * LINK_LATENCY_S
    a2a = (tp - 1.0) / tp * o["comm"] / c["ici_bw"] \
        + (tp - 1.0) * LINK_LATENCY_S
    comm = torch.where(o["kind"] == ALLREDUCE, ring,
                       torch.where(o["kind"] == P2P, a2a, 0.0))
    t = torch.maximum(torch.maximum(compute, memory), comm) * o["count"]
    by_comm = (comm >= compute) & (comm >= memory)
    by_compute = (compute > memory) & ~by_comm
    cls = torch.where(by_comm, INTERCONNECT,
                      torch.where(by_compute,
                                  torch.where(is_mm, TENSOR, VECTOR_UNIT),
                                  MEMORY))
    return t, torch.where(is_mem, MEMORY, cls)


def in_order_sum(x: torch.Tensor) -> torch.Tensor:
    """((x0 + x1) + x2) + ... over the last axis (the model's op order)."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def evaluate(flat: torch.Tensor, prefill: Dict[str, torch.Tensor],
             decode_: Dict[str, torch.Tensor], dtype=torch.float32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Designs' objectives (n, 3) [prefill latency, decode latency, area]
    and the prefill's dominant stall class (n,), computed in `dtype`."""
    hw = {k: v.to(dtype) for k, v in hardware(decode(flat)).items()}
    tp, cls = op_times(hw, prefill)
    td, _ = op_times(hw, decode_)
    stall = torch.stack([in_order_sum(torch.where(cls == s, tp, 0.0))
                         for s in range(4)], dim=1)
    ys = torch.stack([in_order_sum(tp), in_order_sum(td), hw["area"]], dim=1)
    return ys.float(), torch.argmax(stall, dim=1)


# ------------------------------------------------------------- the sweep
def _dominated(by: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(p,) mask: which of pts (p, 3) some row of `by` (f, 3) dominates
    (no worse in every objective, better in one)."""
    le = (by[None, :, :] <= pts[:, None, :]).all(-1)
    lt = (by[None, :, :] < pts[:, None, :]).any(-1)
    return (le & lt).any(1)


def front(ys: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Ids (ascending) of the exact Pareto front of ys (n, 3); equal
    points are all kept.  Points dominated by a few killers (the best by
    each objective and by the sum of logs) go first; the survivors are
    then checked against each other."""
    n = ys.shape[0]
    keys = [ys[:, 0], ys[:, 1], ys[:, 2], torch.log(ys).sum(1)]
    killers = torch.cat([ys[torch.argsort(kk, stable=True)[:64]]
                         for kk in keys])
    alive = torch.ones(n, dtype=torch.bool, device=ys.device)
    for s in range(0, n, block * 16):
        alive[s:s + block * 16] = ~_dominated(killers, ys[s:s + block * 16])
    cand = torch.nonzero(alive)[:, 0]
    pts = ys[cand]
    keep = torch.ones(cand.numel(), dtype=torch.bool, device=ys.device)
    for s in range(0, cand.numel(), block):
        blk = pts[s:s + block]
        for t in range(0, cand.numel(), block):
            keep[s:s + block] &= ~_dominated(pts[t:t + block], blk)
    return cand[keep]


def smallest(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the k smallest values, the lower id first on a tie."""
    return torch.argsort(vals, stable=True)[:k]


def sweep(a: dict, mix: dict, device, dtype=torch.float32,
          block: int = 1 << 18) -> dict:
    """What a full sweep of the space reports, for the workload pair of
    model `a` that the mix states: {"n_superior", "topk_ids" (3, topk),
    "topk_val", "stall_ids" (4, stall_topk; -1 where a class has fewer),
    "front_ids", "front_y"}."""
    b, s, tp = mix["batch"], mix["seq"], mix["tp"]
    pre = op_table(ops(a, b, s, tp, False), device, dtype)
    dec = op_table(ops(a, b, s, tp, True, s + mix["out_pos"]), device, dtype)
    stop = mix.get("stop") or SIZE
    ys, dom = [], []
    for s0 in range(0, stop, block):
        flat = torch.arange(s0, min(s0 + block, stop), device=device)
        y, d = evaluate(flat, pre, dec, dtype)
        ys.append(y)
        dom.append(d)
    ys, dom = torch.cat(ys), torch.cat(dom)
    ref, _ = evaluate(torch.tensor([nearest_id(A100)], device=device), pre,
                      dec, dtype)
    k, sk = mix["topk"], mix["stall_topk"]
    top = torch.stack([smallest(ys[:, o], k) for o in range(3)])
    stall = torch.full((4, sk), -1, dtype=torch.long, device=device)
    for c in range(4):
        lat = torch.where(dom == c, ys[:, 0], math.inf)
        ids = smallest(lat, sk)
        stall[c] = torch.where(torch.isfinite(lat[ids]), ids, -1)
    f = front(ys)
    return {"n_superior": int((ys < ref).all(1).sum()),
            "topk_ids": top.cpu(),
            "topk_val": torch.stack([ys[top[o], o] for o in range(3)]).cpu(),
            "stall_ids": stall.cpu(), "front_ids": f.cpu(),
            "front_y": ys[f].cpu(), "n": int(ys.shape[0])}
