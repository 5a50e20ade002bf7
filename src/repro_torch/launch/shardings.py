"""Partition specs for parameters, optimizer state, batches and caches,
and their DTensor placements.

The port's counterpart of ``repro.launch.shardings``, with the same
strategy and the same divisibility fall-backs:

* DP over ('pod', 'data') on batch dims;
* Megatron TP over 'model' on attention heads / d_ff / vocab and Mamba
  channel dims (the reference's rules leave RWKV's linears replicated:
  their keys are ``rwkv_<name>``, which no TP rule names);
* EP over 'model' for MoE expert stacks (falling back to TP on the expert
  FF dim when n_experts doesn't divide the axis, e.g. qwen2-moe's 60);
* SP (sequence sharding) for long_500k KV caches, for GQA caches whose
  kv-head count doesn't divide the model axis (flash-decode layout), and,
  through ``Model._constrain``, for residual streams.

A :class:`PartitionSpec` is the port's own: a tuple whose entries are
None, an axis name or a tuple of names, so ``tuple(spec)`` compares
directly with a ``jax.sharding.PartitionSpec``'s.  The port keeps one
module per layer (``models/convert.py``), so :func:`param_specs` walks
``Model.named_parameters()`` and each spec is the reference's spec of the
stacked leaf with its leading stack dims dropped: the rules address
trailing dims, and the parameter's name maps back to the reference's key
path (:func:`ref_keys`).  ``PartitionSpec`` and ``to_placements`` (a
spec's placements of a ``DTensor`` on a ``DeviceMesh``) live in
``models.dtensor``, which the model and the data pipeline read too, and
are re-exported here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.dtensor import (P, PartitionSpec,  # noqa: F401
                                        to_placements)


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def ref_keys(name: str) -> list:
    """The reference's key path of the port's parameter `name`: the layer
    (and Jamba sub-layer) indices dropped, and an RWKV layer's ``rwkv.<x>``
    back to its flat ``rwkv_<x>`` key (``layers.3.rwkv.r.w`` ->
    ``["layers", "rwkv_r", "w"]``)."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    if len(parts) > 2 and parts[0] == "layers" and parts[1] == "rwkv":
        parts = ["layers", "rwkv_" + parts[2]] + parts[3:]
    return parts


# ----------------------------------------------------------------- params
def _base_spec(keys, shape: Tuple[int, ...], model_size: int) -> Tuple:
    """Spec for a param leaf, by path rules + divisibility checks.

    Rules address trailing dims; the result is left-padded with None by
    the caller."""
    last = keys[-1]

    def has(*names):
        return any(n in keys for n in names)

    def m(dim_from_end: int):
        """'model' if that trailing dim divides the axis, else None."""
        d = shape[len(shape) - dim_from_end]
        return "model" if _div(d, model_size) else None

    # shared-expert MLP inside MoE blocks: ordinary TP rules (check first —
    # its leaves are also named w_gate/w_up/w_down)
    if has("shared"):
        if last in ("w_gate", "w_up"):
            return (None, m(1))
        if last == "w_down":
            return (m(2), None)
        return (None,) * min(len(shape), 1)

    # MoE expert stacks: (E, d, f) / (E, f, d) -> EP on E when divisible,
    # else TP on the expert FF dim
    if has("moe") and last in ("w_gate", "w_up", "w_down"):
        e_dim = shape[-3]
        if _div(e_dim, model_size):
            return ("model", None, None)
        if last == "w_down":
            return (None, m(2), None)
        return (None, None, m(1))
    if last == "router":
        return (None, None)

    # attention / rwkv / mamba linears
    if has("q", "k", "v", "g", "r", "w_proj", "cm_k", "in_proj") and last == "w":
        return (None, m(1))
    if has("q", "k", "v", "g", "r", "w_proj", "cm_k", "in_proj") and last == "b":
        return (m(1),)
    if has("o", "out", "cm_v", "out_proj", "x_proj") and last == "w":
        return (m(2), None)
    if has("o", "out", "cm_v", "out_proj", "x_proj") and last == "b":
        return (None,)
    if last == "conv_w":
        return (None, m(1))
    if last in ("conv_b", "dt_bias", "D"):
        return (m(1),)
    if last == "A_log":
        return (m(2), None)
    if last == "u":                       # rwkv bonus (H, hd)
        return (m(2), None)

    # MLP
    if last in ("w_gate", "w_up"):
        return (None, m(1))
    if last == "b_up":
        return (m(1),)
    if last == "w_down":
        return (m(2), None)
    if last == "b_down":
        return (None,)

    # embeddings / head: vocab-sharded when divisible, else d_model-sharded
    if last == "embed":
        if _div(shape[-2], model_size):
            return ("model", None)
        return (None, m(1))
    if has("lm_head") and last == "w":
        if _div(shape[-1], model_size):
            return (None, "model")
        return (m(2), None)
    if has("lm_head") and last == "b":
        return (m(1),)

    # norms, mixes, scalars
    return tuple([None] * len(shape))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def param_spec(name: str, leaf, model_size: int = 16) -> PartitionSpec:
    """The spec of the port's parameter `name` (a tensor, or anything
    with a ``shape``)."""
    shape = _shape(leaf)
    ndim = len(shape)
    tail = _base_spec(ref_keys(name), shape, model_size)
    tail = tuple(tail[-ndim:]) if len(tail) > ndim else tail
    return P(*([None] * (ndim - len(tail)) + list(tail)))


def _named(params) -> Mapping[str, Any]:
    """{name: tensor} of a module (its ``named_parameters()``) or a dict."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return params


def param_specs(params, model_size: int = 16) -> Dict[str, PartitionSpec]:
    """{name: spec} for a model or a {name: tensor} dict (meta tensors
    do)."""
    return {n: param_spec(n, p, model_size)
            for n, p in _named(params).items()}


# ----------------------------------------------------------------- batch
def batch_spec(cfg: ArchConfig, shape: ShapeConfig, dp, dp_size: int) -> Any:
    """Input-batch PartitionSpecs.  dp = data axes, dp_size = their product."""
    dp = tuple(dp)
    bdim = dp if _div(shape.global_batch, dp_size) and shape.global_batch > 1 \
        else None
    if shape.mode == "decode":
        tok = P(bdim)                     # (B,) one token per sequence
    else:
        tok = P(bdim, None)               # (B, S)
    out = {"tokens": tok, "labels": P(bdim, None)}
    if cfg.family == "vlm":
        out["embeds"] = P(bdim, None, "model")
    if cfg.family == "audio":
        out["frames"] = P(bdim, None, "model")
    return out


# ----------------------------------------------------------------- cache
def cache_spec(cfg: ArchConfig, shape: ShapeConfig, dp, dp_size: int,
               model_size: int) -> Any:
    """Decode-cache PartitionSpecs, in the port's cache layout
    (``Model.init_cache``): the KV caches stacked (L, B, S, kvH, hd) as
    the reference's; the ssm family's per-layer state and the hybrid
    family's per-block, per-Mamba-sub-layer states as lists, each entry
    the reference's stacked spec with the stack dims dropped.

    KV layout decision tree:
      * kv-heads divide the model axis -> shard heads (classic TP serving);
      * else -> shard the KV sequence over 'model' (flash-decode layout);
      * batch==1 (long_500k) -> the data axes also land on the sequence dim.
    """
    dp = tuple(dp)
    seq_sharded = shape.global_batch == 1
    b_ax = None if seq_sharded else (dp if _div(shape.global_batch, dp_size)
                                     else None)
    heads_ok = _div(cfg.n_kv_heads, model_size)
    s_parts = []
    if seq_sharded:
        s_parts.extend(dp)
    if not heads_ok:
        s_parts.append("model")
    s_ax = tuple(s_parts) if s_parts else None
    h_ax = "model" if heads_ok else None

    kv = P(None, b_ax, s_ax, h_ax, None)          # (L, B, S, kvH, hd)
    d_ax = "model" if _div(cfg.d_model, model_size) else None
    if cfg.family == "ssm":
        wkv_h = ("model" if _div(cfg.d_model // cfg.rwkv_head_size,
                                 model_size) else None)
        return {
            "layers": [{"tm": {"wkv": P(b_ax, wkv_h, None, None),
                               "shift": P(b_ax, None, d_ax)},
                        "cm": {"shift": P(b_ax, None, d_ax)}}
                       for _ in range(cfg.n_layers)],
            "len": P(),
        }
    if cfg.family == "hybrid":
        din_ax = "model" if _div(2 * cfg.d_model, model_size) else None
        per = cfg.attn_every
        return {
            "k": kv, "v": kv,
            "mamba": [[{"h": P(b_ax, din_ax, None),
                        "conv": P(b_ax, None, din_ax)}
                       for _ in range(per - 1)]
                      for _ in range(cfg.n_layers // per)],
            "len": P(),
        }
    out = {"k": kv, "v": kv, "len": P()}
    if cfg.family == "audio":
        out["enc"] = P(b_ax, None, d_ax)
    return out


def hidden_spec(dp) -> PartitionSpec:
    """Residual-stream constraint: Megatron sequence parallelism — batch
    over data axes AND sequence over model between blocks."""
    return P(tuple(dp), "model", None)


# ----------------------------------------------------------------- FSDP
def fsdp_param_spec(name: str, leaf, axes: Tuple[str, ...],
                    size: int) -> PartitionSpec:
    """ZeRO-3/FSDP layout: shard the largest dim divisible by the FULL
    device count over all mesh axes."""
    shape = _shape(leaf)
    if not shape:
        return P()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % size == 0 and shape[i] >= size:
            parts: list = [None] * len(shape)
            parts[i] = tuple(axes)
            return P(*parts)
    return P(*([None] * len(shape)))


def fsdp_param_specs(params, axes: Tuple[str, ...], size: int
                     ) -> Dict[str, PartitionSpec]:
    return {n: fsdp_param_spec(n, p, axes, size)
            for n, p in _named(params).items()}
