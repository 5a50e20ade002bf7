"""Expert-parallel MoE with explicit collectives: the production train and
prefill path.

The port's counterpart of ``repro.models.moe_shard``.  The dense dispatch
(:func:`repro_torch.models.moe.moe_block`) scatters at indices computed at
run time, which DTensor cannot split, so on a mesh the model runs it whole
on every rank (``Model._moe``'s ``moe_impl="dense"``).  Here each rank
runs its own part through ``local_map``:

* each (data shard, model rank) routes its own slice of ``per = t_loc /
  mp`` tokens: top-k, positions from a cumulative count, the scatter into
  an (E_tot, cap, d) buffer, all local;
* one all-to-all over the mesh's ``model`` group moves the capacity-bounded
  buffers to the ranks that hold their experts (the expert stacks are
  split on dim 0 over ``model``: expert parallelism);
* the rank's E_tot / mp experts run as a local batched product;
* a reverse all-to-all, the gate-weighted combine, and an all-gather of
  the token slices give every model rank its data shard's output.

The collectives are ``torch.distributed`` functional collectives on the
``model`` group (nccl on cards, gloo on the CPU).  Gradients are the
reference's ``jax.grad`` through its ``shard_map`` (``check_vma=False``):

* x and the experts get the true gradient of the block's output.  The
  output is replicated over ``model``, so each rank receives the whole
  cotangent, and the gather's backward keeps the rank's own slice
  (:class:`_GatherSlices`); an all-gather whose backward sums over the
  group would give mp times that.  x's and the router's gradients are
  ``Partial`` where the rank saw only its slice, the experts' over the
  data axes;
* the aux loss is the reference's quirk: its value is data shard 0's aux
  loss (``out_specs=P()`` keeps device 0's copy), its gradient that of the
  mean over data shards (the cotangent of a replicated output is divided
  by the axis size, and ``psum``'s transpose sums it back over
  ``model``).  Within a data shard the means over ``model`` are sums
  over its ranks (``models.dtensor._SumOverRanks``, whose backward passes
  the replicated cotangent) divided by their count.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import moe as M
from repro_torch.models.dtensor import (P, _call_local, _SumOverRanks,
                                        is_dtensor, module_view,
                                        to_placements)
from repro_torch.models.layers import mlp, upcast


def _local_dispatch(router: torch.Tensor, xs: torch.Tensor,
                    x_send: torch.Tensor, n_experts: int, e_tot: int,
                    top_k: int, capacity_factor: float):
    """Route a local token slice xs (t, d) and scatter `x_send` (the same
    values) by it: the (E_tot, cap, d) buffer, the combine's (expert,
    slot, gate) per assignment, and the aux loss's ``me`` / ``ce``.  The
    routing is :func:`moe.route`'s with one group (its cap, ceil(t k / E
    capacity_factor), is the reference's)."""
    t, d = xs.shape
    r = M.route(SimpleNamespace(router=router), xs[None],
                n_experts=n_experts, top_k=top_k,
                capacity_factor=capacity_factor, e_tot=e_tot)
    cap = r["cap"]
    flat_e, pos, keep = r["flat_expert"][0], r["pos"][0], r["keep"][0]
    e_idx = torch.where(keep, flat_e, 0)
    c_idx = torch.where(keep, pos, 0)
    src = torch.where(keep[:, None], x_send.repeat_interleave(top_k, dim=0),
                      0)
    # accumulated, as the reference's `.at[].add`: dropped assignments land
    # on slot (0, 0) with a zero source (see moe.moe_block)
    buf = torch.zeros((e_tot, cap, d), dtype=xs.dtype, device=xs.device)
    buf.index_put_((e_idx, c_idx), src, accumulate=True)
    gates = (r["gate_vals"][0].reshape(-1) * keep).to(xs.dtype)
    me = r["probs"][0].mean(dim=0)[:n_experts]
    ce = torch.zeros(e_tot, dtype=me.dtype, device=xs.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=me.dtype))[:n_experts] \
        / (t * top_k)
    return buf, (e_idx, c_idx, gates), (me, ce)


class _GatherSlices(torch.autograd.Function):
    """All-gather of each rank's (per, d) slice along dim 0.  Backward:
    the rank's own slice of the cotangent, which every rank of the group
    holds whole (the output is replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.per = rank, x.shape[0]
        return funcol.wait_tensor(funcol.all_gather_tensor(
            x.contiguous(), 0, group))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.rank * ctx.per, ctx.per), None, None


def _axis(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    if name not in names:
        raise ValueError(f"mesh axes {names} have no {name!r}")
    return names.index(name)


def _shard0_aux(aux: torch.Tensor, mesh, dp_axes: Sequence[str],
                dp_size: int) -> torch.Tensor:
    """Data shard 0's value of `aux` on every rank, with the gradient of
    the mean of `aux` over the data shards."""
    if dp_size == 1:
        return aux
    v = aux.detach().reshape(1)
    for a in dp_axes:
        if mesh.size(_axis(mesh, a)) > 1:
            v = funcol.wait_tensor(funcol.all_gather_tensor(
                v, 0, mesh.get_group(a)))[:1]
    return v[0] + (aux - aux.detach()) / dp_size


def moe_block_sharded(p: M.MoE, x: torch.Tensor, *, n_experts: int,
                      top_k: int, mesh, dp_axes: Tuple[str, ...],
                      model_axis: str = "model",
                      capacity_factor: float = 1.25
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel block on `mesh`: x (B, S, d) -> (out, aux loss).

    x is split over the data axes `dp_axes` and replicated over
    `model_axis` (a DTensor split on the sequence is gathered first, as
    every tensor-parallel block's input is); the expert stacks are split
    on dim 0 over `model_axis`.  Plain tensors count as replicated, and
    then plain tensors come back.  Sizes are the reference's: t_loc =
    (B / dp) S tokens a data shard, per = t_loc / mp a model rank, and
    cap = ceil(per k / E capacity_factor).  Raises ``ValueError`` where
    they do not hold (E_tot % mp, B % dp, t_loc != mp per)."""
    b, s, d = x.shape
    mp = mesh.size(_axis(mesh, model_axis))
    e_tot = p.w_up.shape[0]
    if e_tot % mp:
        raise ValueError(f"{e_tot} experts (w_up {tuple(p.w_up.shape)}) do "
                         f"not split over {model_axis!r} of size {mp}")
    dp_size = math.prod(mesh.size(_axis(mesh, a)) for a in dp_axes)
    if b % dp_size:
        raise ValueError(f"batch {b} of x {tuple(x.shape)} does not split "
                         f"over the data axes {tuple(dp_axes)} "
                         f"({dp_size} shards)")
    t_loc = (b // dp_size) * s
    per = max(t_loc // mp, 1)
    if t_loc != mp * per:
        raise ValueError(f"x {tuple(x.shape)}: {t_loc} tokens a data shard "
                         f"do not split into {mp} model ranks' slices")
    cap = max(int(math.ceil(per * top_k / n_experts * capacity_factor)), 1)
    e_loc = e_tot // mp
    group = mesh.get_group(model_axis)
    rank = mesh.get_local_rank(model_axis)

    def inner(xl, xl_send, router, wg, wu, wd):
        # xl: (b_loc, S, d), the same on every model rank
        xs, xs_send = (t.reshape(-1, d).narrow(0, rank * per, per)
                       for t in (xl, xl_send))
        buf, (e_idx, c_idx, gates), (me, ce) = _local_dispatch(
            router, xs, xs_send, n_experts, e_tot, top_k, capacity_factor)
        # dispatch: chunk j of dim 0 (E_loc experts) goes to model rank j,
        # and chunk j of what arrives came from rank j
        recv = funcol.all_to_all_single_autograd(
            buf.reshape(mp * e_loc * cap, d), None, None, group)
        # (a leading group dim of 1: moe_block's products, the same GEMMs
        # on a mesh of one)
        h_in = funcol.wait_tensor(recv).reshape(mp, e_loc, cap, d) \
            .transpose(0, 1).reshape(1, e_loc, mp * cap, d)
        g = torch.einsum("gecd,edf->gecf", h_in, wg)
        u = torch.einsum("gecd,edf->gecf", h_in, wu)
        hh = F.silu(upcast(g)).to(xl.dtype) * u
        y = torch.einsum("gecf,efd->gecd", hh, wd)     # (1, E_loc, mp cap, d)
        # reverse: each rank's slots go back to the rank that sent them
        yr = y.reshape(e_loc, mp, cap, d).transpose(0, 1) \
            .reshape(mp * e_loc * cap, d)
        back = funcol.wait_tensor(funcol.all_to_all_single_autograd(
            yr, None, None, group))
        y_buf = back.reshape(e_tot, cap, d)
        out_flat = y_buf[e_idx, c_idx] * gates[:, None]          # (per k, d)
        out_slice = out_flat.reshape(per, top_k, d).sum(dim=1)
        out = _GatherSlices.apply(out_slice, group, rank)        # (t_loc, d)
        # pmean over model: each rank's share of the mean gets the
        # replicated cotangent divided by mp
        aux = n_experts * torch.sum(
            _SumOverRanks.apply(me, [group]) / mp
            * (_SumOverRanks.apply(ce, [group]) / mp))
        return (out.reshape(xl.shape),
                _shard0_aux(aux, mesh, dp_axes, dp_size))

    plain = not is_dtensor(x)
    rep = (Replicate(),) * mesh.ndim

    def placed(t):
        return t if is_dtensor(t) else DTensor.from_local(t, mesh, rep,
                                                          run_check=False)
    names = tuple(mesh.mesh_dim_names)
    x_pl = to_placements(mesh, P(tuple(dp_axes), None, None), 3)
    # the shard_map's in-spec: the sequence gathered, batch rows split over
    # the data axes, whole (a pending sum reduced) over model
    xd = placed(x).redistribute(mesh, x_pl)
    x_grad = tuple(Partial() if n == model_axis else pl
                   for n, pl in zip(names, x_pl))
    w_pl = to_placements(mesh, P(model_axis, None, None), 3)
    w_grad = tuple(Partial() if n in dp_axes else pl
                   for n, pl in zip(names, w_pl))
    all_partial = (Partial(),) * mesh.ndim
    ws = (p.w_gate, p.w_up, p.w_down)
    # x enters twice, for the router and for the dispatch, as moe_block
    # reads it: autograd then sums x's gradients (router, dispatch, shared
    # expert) in moe_block's order, so that on a mesh of one the block's
    # gradients are moe_block's bit for bit
    out, aux = _call_local(
        inner, mesh, (xd, xd, placed(p.router), *map(placed, ws)),
        (x_pl, x_pl, rep, w_pl, w_pl, w_pl),
        (x_grad, x_grad, all_partial, w_grad, w_grad, w_grad), (x_pl, rep))
    if p.shared is not None:
        shared = p.shared if not plain else module_view(p.shared, {
            n: placed(t) for n, t in p.shared.named_parameters()})
        out = out + mlp(shared, xd)
    if plain:
        out, aux = out.full_tensor(), aux.full_tensor()
    return out, aux



def moe_block_grouped(p: M.MoE, x: torch.Tensor, *, n_experts: int,
                      top_k: int, n_groups: int, buf_pspec,
                      capacity_factor: float = 1.25):
    """:func:`moe.moe_block`'s output for a DTensor x (B, S, d), laid out
    as the reference lays out the dense dispatch's buffer with
    ``buf_pspec`` (P(data axes, model axis, None, None)): each rank routes
    its data shard's groups and runs the experts its model rank holds (the
    stacks split on dim 0: expert parallel) or every expert's slice of the
    FF dim (split there); its output is a partial sum over the model axis.
    No collective runs inside: x's batch rows stay on their data shard and
    the weights where they are.  The decode step's block (the reference's
    ``moe_groups`` are the data shards; the aux loss, which decode drops,
    is not computed).

    None where the layout does not hold (no `buf_pspec`, a batch or group
    count that the data shards do not split, or neither data nor model
    splitting anything): the caller then runs the block whole."""
    if buf_pspec is None or not is_dtensor(x):
        return None
    mesh = x.device_mesh
    b, s, d = x.shape
    dp = buf_pspec[0]
    dp_axes = () if dp is None else (dp,) if isinstance(dp, str) else dp
    model_axis = buf_pspec[1]
    dp_size = math.prod(mesh.size(_axis(mesh, a)) for a in dp_axes)
    g_n = max(1, math.gcd(n_groups, b * s))
    if b % dp_size or g_n % dp_size:
        return None
    m = _axis(mesh, model_axis) if model_axis is not None else None
    w_pl = p.w_up.placements if is_dtensor(p.w_up) else None
    split = (None if m is None or w_pl is None or mesh.size(m) == 1
             else w_pl[m])
    if split not in (None, Shard(0), Shard(2)):
        return None
    if dp_size == 1 and split is None:
        return None
    e_tot = p.w_up.shape[0]
    e_loc = e_tot // mesh.size(m) if split == Shard(0) else e_tot
    e0 = mesh.get_local_rank(m) * e_loc if split == Shard(0) else 0
    x_pl = to_placements(mesh, P(tuple(dp_axes), None, None), 3)
    out_pl = tuple(Partial() if i == m and split is not None else pl
                   for i, pl in enumerate(x_pl))
    rep = (Replicate(),) * mesh.ndim
    ws = (p.w_gate, p.w_up, p.w_down)
    w_in = tuple(w.placements if is_dtensor(w) else rep for w in ws)

    def local(xl, router, wg, wu, wd):
        bl = xl.shape[0]
        r = M.route(SimpleNamespace(router=router), xl, n_experts=n_experts,
                    top_k=top_k, capacity_factor=capacity_factor,
                    n_groups=g_n // dp_size, e_tot=e_tot)
        flat_e, pos, cap = r["flat_expert"], r["pos"], r["cap"]
        gl, tk = flat_e.shape
        mine = r["keep"] & (flat_e >= e0) & (flat_e < e0 + e_loc)
        e_idx = torch.where(mine, flat_e - e0, 0)
        c_idx = torch.where(mine, pos, 0)
        src = torch.where(mine[..., None], xl.reshape(gl, tk // top_k, d)
                          .repeat_interleave(top_k, dim=1), 0)
        g_idx = torch.arange(gl, device=xl.device)[:, None].expand_as(e_idx)
        # accumulated, as moe_block's scatter (dropped and other ranks'
        # assignments land on slot (g, 0, 0) with a zero source)
        buf = torch.zeros((gl, e_loc, cap, d), dtype=xl.dtype,
                          device=xl.device)
        buf.index_put_((g_idx, e_idx, c_idx), src, accumulate=True)
        g = torch.einsum("gecd,edf->gecf", buf, wg)
        u = torch.einsum("gecd,edf->gecf", buf, wu)
        h = F.silu(upcast(g)).to(xl.dtype) * u
        y = torch.einsum("gecf,efd->gecd", h, wd)
        w = (r["gate_vals"].reshape(gl, tk) * mine).to(xl.dtype)
        return (y[g_idx, e_idx, c_idx] * w[..., None]) \
            .reshape(gl, tk // top_k, top_k, d).sum(dim=2).reshape(bl, s, d)

    router = (p.router if is_dtensor(p.router) else
              DTensor.from_local(p.router, mesh, rep, run_check=False))
    out = _call_local(local, mesh, (x, router, *ws),
                      (x_pl, rep, *w_in), (x_pl, rep, *w_in), (out_pl,))
    if p.shared is not None:
        out = out + mlp(p.shared, x)
    return out
