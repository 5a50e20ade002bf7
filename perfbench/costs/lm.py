"""FLOPs of the decoder-only LMs' prefill and train steps, and of the
attention function, from a configuration's ``model`` dict.

A product of an (m, k) by a (k, n) matrix is 2 m k n operations.  Model
FLOPs count the products a step needs: every weight matrix a token passes
through (for an MoE layer its top-k routed experts, the router and the
shared expert), the head, and causal attention's q.k and p.v over the
pairs (query, key <= query).  A train step is the forward and twice the
forward for the backward; the recompute of remat is not counted."""
from __future__ import annotations


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal attention of length s keeps."""
    return s * (s + 1) // 2


def matmul_params(a: dict) -> int:
    """Weights a token multiplies through in one forward (the active ones
    of an MoE layer), the head included."""
    d, hd = a["d_model"], a["head_dim"]
    attn = d * a["n_heads"] * hd * 2 + d * a["n_kv_heads"] * hd * 2
    if a.get("n_experts"):
        ffn = d * a["n_experts"] + a["top_k"] * 3 * d * a["expert_ff"]
        if a.get("n_shared_experts"):
            ffn += 3 * d * a["d_ff"]
    else:
        ffn = (3 if a.get("gated_mlp", True) else 2) * d * a["d_ff"]
    return a["n_layers"] * (attn + ffn) + d * a["vocab"]


def attention_fwd_flops(a: dict, b: int, s: int) -> int:
    """q.k and p.v of every layer's causal attention."""
    return 4 * b * a["n_heads"] * a["head_dim"] * causal_pairs(s) \
        * a["n_layers"]


def prefill_flops(a: dict, b: int, s: int) -> int:
    return 2 * matmul_params(a) * b * s + attention_fwd_flops(a, b, s)


def train_flops(a: dict, b: int, s: int) -> int:
    return 3 * prefill_flops(a, b, s)


def flash_fwd_cost(b: int, s: int, h: int, kvh: int, hd: int,
                   itemsize: int) -> tuple:
    """(operations, bytes) of one causal attention forward: two
    multiply-adds per head dim for each kept pair (q.k and p.v); q, k, v
    read once and o written once (the log-sum-exp beside it: 4 bytes a
    row and head)."""
    ops = 4 * b * h * hd * causal_pairs(s)
    nbytes = (2 * b * s * h * hd + 2 * b * s * kvh * hd) * itemsize \
        + 4 * b * h * s
    return ops, nbytes


def flash_bwd_cost(b: int, s: int, h: int, kvh: int, hd: int,
                   itemsize: int) -> tuple:
    """(operations, bytes) of one causal attention backward: the four
    products of the gradients (dO.v, P^T dO, dS k, dS^T q) and the
    recomputed q.k, two operations per head dim and kept pair; q, k, v, o,
    dO and lse read once, dq, dk, dv written once."""
    ops = 10 * b * h * hd * causal_pairs(s)
    nbytes = (4 * b * s * h * hd + 4 * b * s * kvh * hd) * itemsize \
        + 4 * b * h * s
    return ops, nbytes
