"""GQA attention: full, memory-efficient chunked (online softmax), and
cached decode.

The port's counterpart of ``repro.models.attention``.  ``chunked_attention``
is the flash-attention algorithm in torch ops (online-softmax rescaling
over q/kv blocks), the plain version of the ``flash_attention`` kernel.
The layer picks the implementation by sequence length, as the reference
does: above :data:`CHUNKED_THRESHOLD` causal self-attention on a CUDA
tensor launches the kernel and on a CPU tensor runs ``chunked_attention``
(on DTensors, either on each rank's local shards); at or below it
``full_attention`` (torch ops) runs on either device.  Inside
:func:`kernel_route` a CPU tensor takes the kernel's wrapper too (its
plain version), as ``launch.dryrun`` traces the model.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.dtensor import (attention_kernel, gather_seq,
                                        is_dtensor, local_einsum, pinned,
                                        replicated_like, split_heads,
                                        write_position)
from repro_torch.models.layers import Linear, apply_rope, linear

NEG_INF = -1e30

# Above this seq len the memory-efficient chunked (flash) impl is used.
CHUNKED_THRESHOLD = 2048

# whether the long causal attention on a CPU tensor takes the kernel's
# wrapper (set by kernel_route) instead of chunked_attention
_cpu_kernel = [False]


@contextlib.contextmanager
def kernel_route():
    """Within the block the long causal attention takes the kernel's
    wrapper on CPU tensors too (``flash_attention_plain``; under grad,
    ``FlashAttentionFn``, which keeps q, k, v, the output and lse for the
    backward, as on the card), where it otherwise runs
    ``chunked_attention``, whose autograd keeps every block's scores."""
    prev, _cpu_kernel[0] = _cpu_kernel[0], True
    try:
        yield
    finally:
        _cpu_kernel[0] = prev


def in_kernel_route() -> bool:
    """Whether a :func:`kernel_route` block is open (the scans read it
    too: ``models.ssm``)."""
    return _cpu_kernel[0]


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, kvH, hd) -> (B, S, kvH*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, H, hd). Materializes scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(replicated_like(logits, ki <= qi), logits,
                             NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 512) -> torch.Tensor:
    """Memory-efficient attention: never materializes (Sq, Sk) scores.

    Loops over q blocks and, inside, over kv blocks carrying (max, sum,
    acc) online-softmax state.  Equivalent to full_attention.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        raise ValueError(f"chunked_attention: {(sq, q_chunk, sk, k_chunk)} "
                         f"do not divide")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for q0 in range(0, sq, q_chunk):
        qblk = q[:, q0:q0 + q_chunk]                  # (b, q_chunk, h, hd)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, q_chunk, h, hd), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, sk, k_chunk):
            kblk = k[:, k0:k0 + k_chunk]
            vblk = v[:, k0:k0 + k_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).float() * scale
            if causal:
                qpos = q0 + torch.arange(q_chunk, device=dev)[:, None]
                kpos = k0 + torch.arange(k_chunk, device=dev)[None, :]
                s = torch.where(kpos <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p.to(vblk.dtype), vblk).float()
            m = m_new
        out = acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, hd) against cache (B, S, H, hd);
    positions >= kv_len are masked."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    mask = torch.arange(k_cache.shape[1], device=q.device) < kv_len
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_cache)


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Grouped-query decode without materializing a repeated KV cache:
    q (B, 1, H, hd) -> (B, kvH, G, hd), attention per kv head over the
    group dim."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    # (a DTensor's query heads are replicated where a mesh dim splits them
    # but not the KV heads, as split_heads does)
    qg = split_heads(q.reshape(b, 1, h * hd), kvh, (h // kvh) * hd) \
        .reshape(b, kvh, h // kvh, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = local_einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    mask = torch.arange(k_cache.shape[1], device=q.device) < kv_len
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = local_einsum("bkgs,bskd->bkgd", w, v_cache)
    return out.reshape(b, 1, h, hd)


# ---------------------------------------------------------------------------
# attention layer (projections + rope + impl dispatch)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Projections ``q``, ``k``, ``v``, ``o`` (the reference's names)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, bias: bool, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.q = Linear(d_model, n_heads * head_dim, bias, **kw)
        self.k = Linear(d_model, n_kv_heads * head_dim, bias, **kw)
        self.v = Linear(d_model, n_kv_heads * head_dim, bias, **kw)
        self.o = Linear(n_heads * head_dim, d_model, False, **kw)

    def init_weights(self, gen: torch.Generator) -> None:
        for p in (self.q, self.k, self.v, self.o):
            p.init_weights(gen)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """The kernel (it reads KV head h // n_rep itself)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)


def _chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
    n_rep = q.shape[2] // k.shape[2]
    return chunked_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                             causal=True)


def attention_block(p: Attention, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int,
                    rope_theta: Optional[float],
                    positions: Optional[torch.Tensor] = None,
                    kv: Optional[torch.Tensor] = None, causal: bool = True,
                    impl: str = "auto") -> torch.Tensor:
    """Self-attention (kv=None) or cross-attention (kv=encoder output).
    On DTensors the long causal self-attention (the kernel, or
    ``chunked_attention`` on the CPU) runs on each rank's local batch rows
    and heads (``models.dtensor.attention_kernel``), the sequence of a
    sequence-parallel input gathered first (``gather_seq``)."""
    b, s, _ = x.shape
    x = gather_seq(x)
    src = gather_seq(kv) if kv is not None else x
    q = split_heads(linear(p.q, x), n_heads, head_dim)
    k = split_heads(linear(p.k, src), n_kv_heads, head_dim)
    v = split_heads(linear(p.v, src), n_kv_heads, head_dim)
    if rope_theta is not None and kv is None:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device)[None, :])
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    use_chunked = impl == "chunked" or (impl == "auto"
                                        and s > CHUNKED_THRESHOLD)
    if use_chunked and causal and kv is None:
        fn = _flash if x.is_cuda or _cpu_kernel[0] else _chunked
        o = attention_kernel(fn, q, k, v) if is_dtensor(q) else fn(q, k, v)
    else:
        n_rep = n_heads // n_kv_heads
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        full = functools.partial(full_attention, causal=causal and kv is None)
        if is_dtensor(q):
            # on each rank's batch rows and heads, as the kernel's site: k
            # and v placed as q is (a replicated head is sliced); DTensor's
            # einsum rules refuse some head splits (torch 2.11)
            k, v = (t.redistribute(q.device_mesh, q.placements)
                    for t in (k, v))
            o = attention_kernel(full, q, k, v)
        else:
            o = full(q, k, v)
    o = pinned(o.reshape(b, s, n_heads * head_dim))
    return linear(p.o, o)


def cached_attention_step(p: Attention, x: torch.Tensor, cache: Dict, *,
                          n_heads: int, n_kv_heads: int, head_dim: int,
                          rope_theta: Optional[float]
                          ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.

    x: (B, 1, d).  cache: {"k", "v": (B, S, kvH, hd), "len": int — the
    shared history length}.  The new key and value are written into the
    cache in place at position ``len`` (the reference builds a new cache);
    returns (out (B, 1, d), {"k", "v", "len": len + 1}).
    """
    b = x.shape[0]
    pos = cache["len"]
    q = split_heads(linear(p.q, x), n_heads, head_dim)
    k = split_heads(linear(p.k, x), n_kv_heads, head_dim)
    v = split_heads(linear(p.v, x), n_kv_heads, head_dim)
    if rope_theta is not None:
        pos_t = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_t, rope_theta)
        k = apply_rope(k, pos_t, rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    write_position(k_cache, pos, k)
    write_position(v_cache, pos, v)
    o = gqa_decode_attention(q, k_cache, v_cache, pos + 1)
    out = linear(p.o, o.reshape(b, 1, n_heads * head_dim))
    return out, {"k": k_cache, "v": v_cache, "len": pos + 1}
