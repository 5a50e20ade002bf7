"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

The port's counterpart of ``repro.models.moe``: tokens are scattered into
a dense (G, E, C, d) buffer by their position within their expert, so the
expert computation is one batched product over (group, expert), with
FLOPs proportional to the capacity, not to the number of experts times
the tokens.  Overflow assignments drop (their contribution is the residual
path only), by the reference's rule: positions are a cumulative count over
the flattened (token, k) order, so earlier tokens win.  The expert FFN is
a plain batched product (``torch.einsum``), as the reference leaves it to
XLA.  The ``moe`` family's shared expert is one always-on gated MLP added
to the routed output, as in the reference (no sigmoid gate on it).  The
expert-parallel block on a mesh is :mod:`repro_torch.models.moe_shard`.

While the process tracer records (:data:`repro_torch.obs.PROCESS_TRACER`),
:func:`moe_block` is the device span ``moe.block`` and its routing and
scatter the device span ``moe.dispatch``, which counts the assignments
kept, assigned and the dispatch buffer's slots.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.dtensor import is_dtensor, to_placements
from repro_torch.models.layers import MLP, empty_param, mlp, upcast
from repro_torch.obs.trace import PROCESS_TRACER as _TRACER


class MoE(nn.Module):
    """``router`` (d, E) fp32, ``w_gate``/``w_up`` (E + pad, d, f) and
    ``w_down`` (E + pad, f, d), and with ``n_shared`` a gated ``shared``
    :class:`MLP` of width ``shared_ff``: the reference's names and layouts
    (``init_moe``).  ``expert_pad`` adds zero-traffic experts; the router
    only ever emits ``n_experts`` logits."""

    def __init__(self, d_model: int, expert_ff: int, n_experts: int, *,
                 n_shared: int = 0, shared_ff: int = 0, expert_pad: int = 0,
                 dtype=torch.float32, device=None):
        super().__init__()
        e_tot = n_experts + expert_pad
        self.router = empty_param((d_model, n_experts), torch.float32,
                                  device)
        self.w_gate = empty_param((e_tot, d_model, expert_ff), dtype, device)
        self.w_up = empty_param((e_tot, d_model, expert_ff), dtype, device)
        self.w_down = empty_param((e_tot, expert_ff, d_model), dtype, device)
        self.shared = (MLP(d_model, shared_ff, gated=True, dtype=dtype,
                           device=device) if n_shared else None)

    def init_weights(self, gen: torch.Generator) -> None:
        init_moe(self, gen)
        if self.shared is not None:
            self.shared.init_weights(gen)


def init_moe(p: MoE, gen: torch.Generator) -> None:
    d_model, expert_ff = p.w_up.shape[1:]
    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(expert_ff)
    p.router.normal_(0.0, s_in, generator=gen)
    p.w_gate.normal_(0.0, s_in, generator=gen)
    p.w_up.normal_(0.0, s_in, generator=gen)
    p.w_down.normal_(0.0, s_ff, generator=gen)


def constrain(t: torch.Tensor, spec: Optional[Sequence]) -> torch.Tensor:
    """t redistributed to `spec`'s placements on its mesh when t is a
    DTensor and `spec` is given; otherwise t."""
    if spec is None or not is_dtensor(t):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, to_placements(mesh, spec, t.dim()))


def route(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
          capacity_factor: float = 1.25, n_groups: int = 1,
          e_tot: Optional[int] = None) -> Dict:
    """Routing and drop decisions of :func:`moe_block` for x (B, S, d):

    ``probs`` (G, Tg, E) fp32, ``gate_vals`` (G, Tg, k) renormalised,
    ``gate_idx`` (G, Tg, k) in ``top_k`` order, ``flat_expert`` and
    ``pos`` (G, Tg*k) (each assignment's slot in its expert), ``keep``
    (G, Tg*k) = pos < cap, and ``cap`` = ceil(Tg k / E * capacity_factor),
    computed on the host in float64 as the reference does.  `e_tot`, the
    experts with the zero-traffic pad ones, is ``p.w_up``'s leading dim
    unless given (``moe_shard`` routes for experts held on other ranks)."""
    b, s, d = x.shape
    t = b * s
    if e_tot is None:
        e_tot = p.w_up.shape[0]          # includes zero-traffic pad experts
    g_n = max(1, math.gcd(n_groups, t))
    tg = t // g_n
    xg = x.reshape(g_n, tg, d)
    logits = torch.matmul(upcast(xg), p.router)                # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)     # (G, Tg, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = max(int(math.ceil(tg * top_k / n_experts * capacity_factor)), 1)

    # position of each (token, k) assignment within its (group, expert) slot
    flat_expert = gate_idx.reshape(g_n, tg * top_k)            # (G, Tg*k)
    onehot = F.one_hot(flat_expert, e_tot)                     # (G, ., E)
    pos_in_expert = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos_in_expert, 2, flat_expert[..., None])[..., 0]
    return {"probs": probs, "gate_vals": gate_vals, "gate_idx": gate_idx,
            "flat_expert": flat_expert, "pos": pos, "keep": pos < cap,
            "cap": cap}


def moe_block(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, n_groups: int = 1,
              buf_pspec: Optional[Sequence] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    Grouped capacity-bounded dispatch: tokens are split into `n_groups`
    groups, routing positions are computed within each group, and the
    dispatch buffer is (G, E, C, d) with per-group capacity
    C = ceil(Tg * top_k / E * capacity_factor) (:func:`route`).
    `buf_pspec` (a PartitionSpec) places a DTensor buffer, as the
    reference's ``with_sharding_constraint`` does (:func:`constrain`); a
    plain buffer stays as it is.
    """
    with _TRACER.span("moe.block", device=x.device):
        return _moe_block(p, x, n_experts=n_experts, top_k=top_k,
                          capacity_factor=capacity_factor, n_groups=n_groups,
                          buf_pspec=buf_pspec)


def _moe_block(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float, n_groups: int,
               buf_pspec: Optional[Sequence]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    t = b * s
    e_tot = p.w_up.shape[0]
    with _TRACER.span("moe.dispatch", device=x.device) as sp:
        r = route(p, x, n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor, n_groups=n_groups)
        flat_expert, pos, keep, cap = (r["flat_expert"], r["pos"], r["keep"],
                                       r["cap"])
        g_n, tk = flat_expert.shape
        xg = x.reshape(g_n, tk // top_k, d)

        # scatter tokens into the (G, E, C, d) dispatch buffer (group-local).
        # Dropped assignments go to slot (g, 0, 0) with a zeroed source and
        # are accumulated, as the reference's `.at[].add`: a plain indexed
        # write would let those zero rows overwrite the real occupant of
        # that slot.
        buf = torch.zeros((g_n, e_tot, cap, d), dtype=x.dtype,
                          device=x.device)
        src = xg.repeat_interleave(top_k, dim=1)               # (G, Tg*k, d)
        e_idx = torch.where(keep, flat_expert, 0)
        c_idx = torch.where(keep, pos, 0)
        src = torch.where(keep[..., None], src, 0)
        g_idx = torch.arange(g_n, device=x.device)[:, None].expand_as(e_idx)
        buf.index_put_((g_idx, e_idx, c_idx), src, accumulate=True)
        if sp.recording:     # assignments kept, made, and the GEMMs' rows
            sp.attrs.update(kept=keep.sum(), assigned=keep.numel(),
                            slots=g_n * e_tot * cap)
    buf = constrain(buf, buf_pspec)

    # expert FFN: one batched product over the (group, expert) dims
    gme = torch.einsum("gecd,edf->gecf", buf, p.w_gate)
    u = torch.einsum("gecd,edf->gecf", buf, p.w_up)
    h = F.silu(upcast(gme)).to(x.dtype) * u
    y = torch.einsum("gecf,efd->gecd", h, p.w_down)            # (G, E, C, d)

    # combine: gather each assignment's expert output, weight by the gate
    out_flat = y[g_idx, e_idx, c_idx]                          # (G, Tg*k, d)
    w = (r["gate_vals"].reshape(g_n, tk) * keep).to(x.dtype)
    out = (out_flat * w[..., None]).reshape(g_n, tk // top_k, top_k, d) \
        .sum(dim=2).reshape(b, s, d)

    # load-balancing auxiliary loss (Switch-style)
    me = r["probs"].reshape(t, -1).mean(dim=0)[:n_experts]
    flat = flat_expert.reshape(-1)
    ce = torch.zeros(e_tot, dtype=me.dtype, device=x.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=me.dtype))[:n_experts] \
        / (t * top_k)
    aux = n_experts * torch.sum(me * ce)

    if p.shared is not None:
        out = out + mlp(p.shared, x)
    return out, aux
