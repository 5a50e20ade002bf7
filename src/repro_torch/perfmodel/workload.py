"""Operator-graph workload descriptions for the analytical models (numpy).

A :class:`Workload` is a struct-of-arrays list of operators, each with
FLOPs, compulsory HBM bytes, matmul dims (for systolic-utilization modelling)
and collective bytes.  The models evaluate ``(designs x ops)`` vectorized.

Builders:

* :func:`gpt3_layer_prefill` / :func:`gpt3_layer_decode` — the paper's
  evaluation workload (single GPT-3 175B layer, TP=8, batch 8, seq 2048,
  FP16; TPOT at output token 1024).
* :func:`workload_from_arrays` — rebuild a workload from the
  struct-of-arrays dict :meth:`Workload.arrays` produces (the form in which
  op tables travel between the two frameworks).

Portfolio pieces:

* :class:`WorkloadStack` — the deduped union of many workloads' op tables:
  identical ``(kind, flops, bytes, m, n, k, comm_bytes, tp)`` rows across
  workloads collapse to one unique op, with a ``(W x n_unique)`` count
  matrix and per-workload gather maps.  The stacked evaluator path runs the
  op-term model ONCE over the union and reassembles every workload by
  gather.
* :class:`Scenario` + :func:`paper_suite` — named (prefill, decode)
  workload pairs; the paper's GPT-3 pair is the one suite ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np

BYTES = 2  # fp16 everywhere (paper: "all operators are executed in FP16")

# op kinds
MATMUL = 0   # runs on the systolic (tensor) unit
VECTOR = 1   # runs on the vector unit (softmax, norms, activations, scans)
MEMCPY = 2   # pure HBM streaming (KV-cache reads, cache updates)
ALLREDUCE = 3  # ring all-reduce over the interconnect (TP collective)
P2P = 4      # point-to-point transfer over the interconnect

KIND_NAMES = {MATMUL: "matmul", VECTOR: "vector", MEMCPY: "memcpy",
              ALLREDUCE: "allreduce", P2P: "p2p"}


@dataclasses.dataclass
class Op:
    name: str
    kind: int
    flops: float = 0.0
    bytes: float = 0.0        # compulsory HBM traffic (read+write)
    m: float = 1.0            # matmul dims (ignored for non-matmul)
    n: float = 1.0
    k: float = 1.0
    comm_bytes: float = 0.0   # collective payload per participant
    count: float = 1.0        # multiplicity (e.g. layer count)


@dataclasses.dataclass
class Workload:
    name: str
    ops: List[Op]
    tp: int = 8               # tensor-parallel degree (ring size for collectives)

    # ---- struct-of-arrays view consumed by the vectorized models ----
    def arrays(self):
        f = lambda attr: np.array([getattr(o, attr) for o in self.ops], dtype=np.float64)
        kinds = np.array([o.kind for o in self.ops], dtype=np.int32)
        return {
            "kind": kinds, "flops": f("flops"), "bytes": f("bytes"),
            "m": f("m"), "n": f("n"), "k": f("k"),
            "comm_bytes": f("comm_bytes"), "count": f("count"),
            # per-op TP degree: constant within one workload, but the stacked
            # union mixes workloads, so tp rides the op table like every
            # other field (collective times depend on it)
            "tp": np.full(len(self.ops), float(self.tp), dtype=np.float64),
        }

    @property
    def op_names(self) -> List[str]:
        return [o.name for o in self.ops]


def workload_from_arrays(name: str, arrays: Mapping[str, np.ndarray],
                         tp: int) -> Workload:
    """A :class:`Workload` from its :meth:`Workload.arrays` dict.

    ``arrays`` needs the op fields (``kind``, ``flops``, ``bytes``, ``m``,
    ``n``, ``k``, ``comm_bytes``, ``count``); op names are positional
    (``op0``, ``op1``, ...) since the struct-of-arrays form carries none.
    A per-op ``tp`` column, when present, must equal ``tp`` everywhere.
    """
    kinds = np.asarray(arrays["kind"])
    if "tp" in arrays and not np.all(np.asarray(arrays["tp"]) == float(tp)):
        raise ValueError(f"op tp column disagrees with tp={tp}")
    fields = ("flops", "bytes", "m", "n", "k", "comm_bytes", "count")
    ops = [Op(f"op{i}", int(kinds[i]),
              **{f: float(np.asarray(arrays[f])[i]) for f in fields})
           for i in range(kinds.shape[0])]
    return Workload(name, ops, tp=int(tp))


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _matmul(name: str, m: float, k: float, n: float, count: float = 1.0) -> Op:
    """Dense matmul A(m,k) @ B(k,n). Compulsory traffic: A + B + C."""
    return Op(name, MATMUL, flops=2.0 * m * k * n,
              bytes=(m * k + k * n + m * n) * BYTES,
              m=m, n=n, k=k, count=count)


def _vector(name: str, elems: float, flops_per_elem: float = 5.0,
            passes: float = 2.0, count: float = 1.0) -> Op:
    """Elementwise/reduction op over `elems` elements (norms, softmax, act)."""
    return Op(name, VECTOR, flops=flops_per_elem * elems,
              bytes=passes * elems * BYTES, count=count)


def _memcpy(name: str, nbytes: float, count: float = 1.0) -> Op:
    return Op(name, MEMCPY, bytes=nbytes, count=count)


def _allreduce(name: str, elems: float, count: float = 1.0) -> Op:
    return Op(name, ALLREDUCE, comm_bytes=elems * BYTES, count=count)


# --------------------------------------------------------------------------
# Paper workload: one GPT-3 175B layer, TP=8, batch 8, seq 2048, FP16
# --------------------------------------------------------------------------

GPT3 = dict(d_model=12288, n_heads=96, head_dim=128, d_ff=4 * 12288)


def gpt3_layer_prefill(batch: int = 8, seq: int = 2048, tp: int = 8) -> Workload:
    d, H, hd, ff = GPT3["d_model"], GPT3["n_heads"], GPT3["head_dim"], GPT3["d_ff"]
    hl = H // tp                      # heads per TP shard
    M = batch * seq
    ops = [
        _vector("ln1", M * d, flops_per_elem=8.0),
        _matmul("qkv_proj", M, d, 3 * d // tp),
        _matmul("attn_qk", seq, hd, seq, count=batch * hl),
        _vector("softmax", seq * seq * batch * hl, flops_per_elem=6.0),
        _matmul("attn_av", seq, seq, hd, count=batch * hl),
        _matmul("o_proj", M, d // tp, d),
        _allreduce("ar_attn", M * d),
        _vector("ln2", M * d, flops_per_elem=8.0),
        _matmul("mlp_up", M, d, ff // tp),
        _vector("gelu", M * ff // tp, flops_per_elem=8.0),
        _matmul("mlp_down", M, ff // tp, d),
        _allreduce("ar_mlp", M * d),
        _memcpy("kv_write", batch * seq * 2 * hl * hd * BYTES),
    ]
    return Workload(f"gpt3-prefill-b{batch}-s{seq}-tp{tp}", ops, tp=tp)


def gpt3_layer_decode(batch: int = 8, seq: int = 2048, out_pos: int = 1024,
                      tp: int = 8) -> Workload:
    """Time per output token at position `out_pos` (KV length seq+out_pos)."""
    d, H, hd, ff = GPT3["d_model"], GPT3["n_heads"], GPT3["head_dim"], GPT3["d_ff"]
    hl = H // tp
    kv = seq + out_pos
    M = batch                         # one new token per sequence
    ops = [
        _vector("ln1", M * d, flops_per_elem=8.0),
        _matmul("qkv_proj", M, d, 3 * d // tp),
        _memcpy("kv_read", batch * kv * 2 * hl * hd * BYTES),
        Op("attn_gemv", MATMUL, flops=2.0 * batch * hl * kv * hd * 2,
           bytes=batch * hl * (kv * hd * 2 + kv + hd) * BYTES,
           m=batch, n=kv, k=hd, count=1.0),
        _vector("softmax", batch * hl * kv, flops_per_elem=6.0),
        _matmul("o_proj", M, d // tp, d),
        _allreduce("ar_attn", M * d),
        _vector("ln2", M * d, flops_per_elem=8.0),
        _matmul("mlp_up", M, d, ff // tp),
        _vector("gelu", M * ff // tp, flops_per_elem=8.0),
        _matmul("mlp_down", M, ff // tp, d),
        _allreduce("ar_mlp", M * d),
        _memcpy("kv_append", batch * 2 * hl * hd * BYTES),
    ]
    return Workload(f"gpt3-decode-b{batch}-kv{kv}-tp{tp}", ops, tp=tp)


# --------------------------------------------------------------------------
# Stacked-workload representation: the deduped union of many op tables
# --------------------------------------------------------------------------

# fields that define an op's identity for dedup (count is multiplicity and
# lives in the count matrix; name is presentation-only)
STACK_KEY_FIELDS = ("kind", "flops", "bytes", "m", "n", "k", "comm_bytes",
                    "tp")


@dataclasses.dataclass(frozen=True)
class WorkloadStack:
    """Flat union of W workloads' op tables with cross-workload dedup.

    ``unique`` holds one row per distinct ``STACK_KEY_FIELDS`` tuple across
    all workloads (first-occurrence order).  Per workload, ``op_map`` gathers
    its ops (in original op order) out of the union and ``counts`` carries
    its own multiplicities, so a model that evaluates the union ONCE can
    reassemble every workload's per-op outputs bit-identically — the
    representation behind the stacked evaluator path and the portfolio
    sweep.  ``count_matrix[w, u]`` aggregates workload w's total count of
    unique op u (duplicate rows within one workload sum).
    """
    names: Tuple[str, ...]
    unique: Dict[str, np.ndarray]            # field -> (n_unique,)
    op_map: Dict[str, np.ndarray]            # name -> (n_ops_w,) int32
    counts: Dict[str, np.ndarray]            # name -> (n_ops_w,) float64
    count_matrix: np.ndarray                 # (W, n_unique) float64

    @property
    def n_unique(self) -> int:
        return int(self.count_matrix.shape[1])

    @property
    def total_ops(self) -> int:
        return sum(m.shape[0] for m in self.op_map.values())

    @classmethod
    def build(cls, workloads: Mapping[str, "Workload"]) -> "WorkloadStack":
        names = tuple(workloads)
        uniq: Dict[tuple, int] = {}
        rows: List[tuple] = []
        op_map: Dict[str, np.ndarray] = {}
        counts: Dict[str, np.ndarray] = {}
        per_wl_keys: Dict[str, List[tuple]] = {}
        for nm in names:
            a = workloads[nm].arrays()
            keys = [tuple(a[f][i] for f in STACK_KEY_FIELDS)
                    for i in range(len(a["count"]))]
            per_wl_keys[nm] = keys
            pos = np.empty(len(keys), dtype=np.int32)
            for i, key in enumerate(keys):
                u = uniq.get(key)
                if u is None:
                    u = uniq[key] = len(rows)
                    rows.append(key)
                pos[i] = u
            op_map[nm] = pos
            counts[nm] = np.asarray(a["count"], dtype=np.float64)
        unique = {
            f: np.array([r[j] for r in rows],
                        dtype=np.int32 if f == "kind" else np.float64)
            for j, f in enumerate(STACK_KEY_FIELDS)
        }
        cmat = np.zeros((len(names), len(rows)), dtype=np.float64)
        for w, nm in enumerate(names):
            np.add.at(cmat[w], op_map[nm], counts[nm])
        return cls(names=names, unique=unique, op_map=op_map, counts=counts,
                   count_matrix=cmat)


# --------------------------------------------------------------------------
# Workload suites: named (prefill, decode) scenario pairs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One latency scenario: a (prefill, decode) workload pair whose
    objective triple is ``[prefill_latency, decode_latency, area]`` — the
    portfolio generalization of the paper's (ttft, tpot, area)."""
    name: str
    prefill: str                 # workload key of the prefill objective
    decode: str                  # workload key of the decode objective


def paper_suite() -> Tuple[Dict[str, "Workload"], Tuple[Scenario, ...]]:
    """The paper's GPT-3 pair as a one-scenario suite."""
    wls = {"ttft": gpt3_layer_prefill(), "tpot": gpt3_layer_decode()}
    return wls, (Scenario("gpt3", "ttft", "tpot"),)
