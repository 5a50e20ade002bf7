"""Operator-graph workload descriptions for the analytical models (numpy).

A :class:`Workload` is a struct-of-arrays list of operators, each with
FLOPs, compulsory HBM bytes, matmul dims (for systolic-utilization modelling)
and collective bytes.  The models evaluate ``(designs x ops)`` vectorized.

Builders:

* :func:`gpt3_layer_prefill` / :func:`gpt3_layer_decode` — the paper's
  evaluation workload (single GPT-3 175B layer, TP=8, batch 8, seq 2048,
  FP16; TPOT at output token 1024).
* :func:`from_arch` — operator graph for any assigned architecture config
  (dense / MoE / hybrid-SSM / RWKV / enc-dec / VLM backbone), so every arch
  doubles as a DSE workload.
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
* :class:`Scenario` + :func:`paper_suite` / :func:`zoo_suite` — named
  (prefill, decode) workload pairs: the paper's GPT-3 pair, or one scenario
  per assigned architecture config (``repro_torch.configs``), so the whole
  workload zoo rides the sweep stack.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

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
# Assigned-architecture workloads (configs -> operator graphs)
# --------------------------------------------------------------------------

def _attn_block(ops: List[Op], pfx: str, batch: int, q_len: int, kv_len: int,
                d: float, n_heads: int, n_kv: int, head_dim: int, tp: int,
                qkv_bias: bool, count: float, decode: bool) -> None:
    hl = max(1, n_heads // tp)
    kvl = max(1, n_kv // tp)
    M = batch * q_len
    q_n = n_heads * head_dim // tp
    kv_n = 2 * n_kv * head_dim // tp
    ops.append(_matmul(f"{pfx}.qkv", M, d, q_n + kv_n, count=count))
    if decode:
        ops.append(_memcpy(f"{pfx}.kv_read",
                           batch * kv_len * 2 * kvl * head_dim * BYTES, count=count))
        ops.append(Op(f"{pfx}.attn", MATMUL,
                      flops=2.0 * batch * hl * kv_len * head_dim * 2,
                      bytes=batch * hl * (kv_len + head_dim) * BYTES,
                      m=batch, n=kv_len, k=head_dim, count=count))
        ops.append(_vector(f"{pfx}.softmax", batch * hl * kv_len, 6.0, count=count))
        ops.append(_memcpy(f"{pfx}.kv_append", batch * 2 * kvl * head_dim * BYTES,
                           count=count))
    else:
        ops.append(_matmul(f"{pfx}.qk", q_len, head_dim, kv_len, count=count * batch * hl))
        ops.append(_vector(f"{pfx}.softmax", batch * hl * q_len * kv_len, 6.0, count=count))
        ops.append(_matmul(f"{pfx}.av", q_len, kv_len, head_dim, count=count * batch * hl))
        ops.append(_memcpy(f"{pfx}.kv_write",
                           batch * q_len * 2 * kvl * head_dim * BYTES, count=count))
    ops.append(_matmul(f"{pfx}.o", M, n_heads * head_dim // tp, d, count=count))
    ops.append(_allreduce(f"{pfx}.ar", M * d, count=count))


def _ffn_block(ops: List[Op], pfx: str, M: float, d: float, d_ff: float,
               tp: int, gated: bool, count: float) -> None:
    up = (2 if gated else 1) * d_ff // tp
    ops.append(_matmul(f"{pfx}.up", M, d, up, count=count))
    ops.append(_vector(f"{pfx}.act", M * d_ff // tp, 8.0, count=count))
    ops.append(_matmul(f"{pfx}.down", M, d_ff // tp, d, count=count))
    ops.append(_allreduce(f"{pfx}.ar", M * d, count=count))


def _moe_block(ops: List[Op], pfx: str, M: float, d: float, expert_ff: float,
               n_experts: int, top_k: int, n_shared: int, tp: int,
               count: float) -> None:
    """Expert-parallel MoE: router + top-k expert FFNs + shared experts.
    Experts sharded over the TP group (EP=tp); tokens all-to-all'd."""
    ops.append(_matmul(f"{pfx}.router", M, d, n_experts, count=count))
    ops.append(_vector(f"{pfx}.route_topk", M * n_experts, 4.0, count=count))
    # all-to-all dispatch+combine approximated as two p2p rounds of the
    # activated token payload
    payload = M * top_k * d * BYTES
    ops.append(Op(f"{pfx}.a2a_dispatch", P2P, comm_bytes=payload, count=count))
    # expert FFN: M*top_k tokens spread over tp shards -> per-shard M_eff
    m_eff = M * top_k / tp
    ops.append(_matmul(f"{pfx}.exp_up", m_eff, d, 2 * expert_ff, count=count))
    ops.append(_vector(f"{pfx}.exp_act", m_eff * expert_ff, 8.0, count=count))
    ops.append(_matmul(f"{pfx}.exp_down", m_eff, expert_ff, d, count=count))
    ops.append(Op(f"{pfx}.a2a_combine", P2P, comm_bytes=payload, count=count))
    if n_shared:
        _ffn_block(ops, f"{pfx}.shared", M, d, expert_ff * n_shared, tp,
                   gated=True, count=count)


def _ssm_block(ops: List[Op], pfx: str, batch: int, q_len: float, d: float,
               d_state: int, tp: int, count: float, decode: bool) -> None:
    """Mamba-style selective-scan block (memory/vector bound)."""
    d_in = 2 * d  # expansion factor 2
    M = batch * q_len
    ops.append(_matmul(f"{pfx}.in_proj", M, d, 2 * d_in // tp, count=count))
    ops.append(_vector(f"{pfx}.conv1d", M * d_in // tp, 8.0, count=count))
    # selective scan: state (d_in/tp, d_state) per token; flops ~ 6*d_in*d_state
    scan_elems = M * (d_in // tp) * d_state
    ops.append(Op(f"{pfx}.scan", VECTOR, flops=6.0 * scan_elems,
                  bytes=(2.0 if decode else 3.0) * M * (d_in // tp) * BYTES
                  + 2 * batch * (d_in // tp) * d_state * BYTES,
                  count=count))
    ops.append(_matmul(f"{pfx}.out_proj", M, d_in // tp, d, count=count))
    ops.append(_allreduce(f"{pfx}.ar", M * d, count=count))


def _rwkv_block(ops: List[Op], pfx: str, batch: int, q_len: float, d: float,
                d_ff: float, tp: int, count: float, decode: bool) -> None:
    """RWKV6 time-mix (data-dependent decay WKV recurrence) + channel-mix."""
    M = batch * q_len
    head = 64
    n_heads = d // head
    ops.append(_matmul(f"{pfx}.rkvwg", M, d, 5 * d // tp, count=count))
    # WKV recurrence: per token, per head, a (head x head) state update:
    # flops ~ 4 * d * head ; state bytes traffic dominates at decode
    ops.append(Op(f"{pfx}.wkv", VECTOR,
                  flops=4.0 * M * (d // tp) * head,
                  bytes=(2 * batch * (n_heads // max(1, tp)) * head * head
                         + 4 * M * d // tp) * BYTES,
                  count=count))
    ops.append(_matmul(f"{pfx}.out", M, d // tp, d, count=count))
    ops.append(_allreduce(f"{pfx}.ar_tm", M * d, count=count))
    ops.append(_matmul(f"{pfx}.cm_up", M, d, d_ff // tp, count=count))
    ops.append(_vector(f"{pfx}.cm_act", M * d_ff // tp, 8.0, count=count))
    ops.append(_matmul(f"{pfx}.cm_down", M, d_ff // tp, d, count=count))
    ops.append(_allreduce(f"{pfx}.ar_cm", M * d, count=count))


def from_arch(cfg, batch: int, seq: int, tp: int = 8, decode: bool = False,
              kv_len: Optional[int] = None) -> Workload:
    """Operator graph for an assigned ArchConfig (repro_torch.configs schema).

    decode=False: prefill of `seq` tokens.  decode=True: one new token with a
    KV/state history of `kv_len` (default `seq`).
    """
    kv_len = kv_len or seq
    q_len = 1 if decode else seq
    d = cfg.d_model
    M = batch * q_len
    ops: List[Op] = []

    n_layers = cfg.n_layers
    fam = cfg.family

    # embeddings / logits (vocab matmul is TP-sharded on vocab)
    ops.append(_memcpy("embed", M * d * BYTES))

    if fam == "ssm":  # rwkv6
        ops.append(_vector("ln_all", 2 * M * d * n_layers / n_layers, 8.0, count=n_layers))
        _rwkv_block(ops, "rwkv", batch, q_len, d, cfg.d_ff, tp,
                    count=n_layers, decode=decode)
    elif fam == "hybrid":  # jamba: 1 attention per `attn_every` layers, MoE every 2nd
        n_attn = n_layers // cfg.attn_every
        n_mamba = n_layers - n_attn
        n_moe = n_layers // 2
        n_dense = n_layers - n_moe
        ops.append(_vector("ln_all", 2 * M * d, 8.0, count=n_layers))
        _attn_block(ops, "attn", batch, q_len, kv_len, d, cfg.n_heads,
                    cfg.n_kv_heads, cfg.head_dim, tp, cfg.qkv_bias,
                    count=n_attn, decode=decode)
        _ssm_block(ops, "mamba", batch, q_len, d, cfg.d_state, tp,
                   count=n_mamba, decode=decode)
        _moe_block(ops, "moe", M, d, cfg.expert_ff, cfg.n_experts,
                   cfg.top_k, cfg.n_shared_experts, tp, count=n_moe)
        _ffn_block(ops, "ffn", M, d, cfg.d_ff, tp, gated=True, count=n_dense)
    else:
        # transformer families: dense / moe / vlm / audio (backbone only)
        enc_layers = getattr(cfg, "enc_layers", 0)
        if enc_layers and not decode:
            # encoder runs full self-attention over its own context
            enc_ctx = getattr(cfg, "enc_ctx", 1500)
            _attn_block(ops, "enc.attn", batch, enc_ctx, enc_ctx, d,
                        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp,
                        cfg.qkv_bias, count=enc_layers, decode=False)
            _ffn_block(ops, "enc.ffn", batch * enc_ctx, d, cfg.d_ff, tp,
                       gated=False, count=enc_layers)
        ops.append(_vector("ln_all", 2 * M * d, 8.0, count=n_layers))
        _attn_block(ops, "attn", batch, q_len, kv_len, d, cfg.n_heads,
                    cfg.n_kv_heads, cfg.head_dim, tp, cfg.qkv_bias,
                    count=n_layers, decode=decode)
        if enc_layers:
            # cross-attention in every decoder layer (enc-dec only)
            enc_ctx = getattr(cfg, "enc_ctx", 1500)
            _attn_block(ops, "xattn", batch, q_len, enc_ctx, d, cfg.n_heads,
                        cfg.n_kv_heads, cfg.head_dim, tp, cfg.qkv_bias,
                        count=n_layers, decode=decode)
        if fam == "moe":
            _moe_block(ops, "moe", M, d, cfg.expert_ff, cfg.n_experts,
                       cfg.top_k, cfg.n_shared_experts, tp, count=n_layers)
            if getattr(cfg, "dense_residual", False):
                _ffn_block(ops, "ffn", M, d, cfg.d_ff, tp, gated=True,
                           count=n_layers)
        else:
            _ffn_block(ops, "ffn", M, d, cfg.d_ff, tp, gated=cfg.gated_mlp,
                       count=n_layers)

    ops.append(_matmul("logits", M, d, cfg.vocab // tp))
    mode = "decode" if decode else "prefill"
    return Workload(f"{cfg.name}-{mode}-b{batch}-s{seq}-kv{kv_len}-tp{tp}",
                    ops, tp=tp)


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


def zoo_suite(batch: int = 8, seq: int = 2048, tp: int = 8,
              out_pos: int = 1024, smoke: bool = False,
              archs: Optional[Tuple[str, ...]] = None,
              ) -> Tuple[Dict[str, "Workload"], Tuple[Scenario, ...]]:
    """Every assigned architecture config as a DSE scenario.

    Each arch contributes a ``<arch>:prefill`` + ``<arch>:decode`` workload
    pair (decode at KV length ``seq + out_pos``, mirroring the paper's TPOT
    operating point).  ``smoke=True`` shrinks every config via
    ``ArchConfig.smoke()`` for CPU-cheap tests; ``archs`` restricts to a
    subset of config names.
    """
    from repro_torch.configs import ARCHS     # leaf import (no cycle)
    wls: Dict[str, Workload] = {}
    scenarios: List[Scenario] = []
    for name in sorted(archs if archs is not None else ARCHS):
        cfg = ARCHS[name]
        if smoke:
            cfg = cfg.smoke()
        wls[f"{name}:prefill"] = from_arch(cfg, batch, seq, tp=tp,
                                           decode=False)
        wls[f"{name}:decode"] = from_arch(cfg, batch, seq, tp=tp,
                                          decode=True, kv_len=seq + out_pos)
        scenarios.append(Scenario(name, f"{name}:prefill", f"{name}:decode"))
    return wls, tuple(scenarios)
