"""Step factories + abstract input specs + the sharding bundle for every
(arch x shape) cell.

The port's counterpart of ``repro.launch.steps``:

* :func:`input_specs` — meta-tensor stand-ins for every model input (no
  allocation);
* :func:`abstract_params` / :func:`abstract_cache` — the parameters and
  the decode cache built on the meta device;
* :func:`make_train_step` / :func:`make_prefill_step` /
  :func:`make_serve_step` — the step functions;
* :func:`shardings_for` — the (params, opt, batch, cache) PartitionSpec
  bundle for a mesh (or a :class:`~repro_torch.launch.mesh.MeshShape`),
  :func:`named` its placements on a mesh, and :func:`shard_model` the
  trainer's placement of a model's parameters as DTensors.

PyTorch runs eagerly, so a prefill or serve step is the model call under
``torch.no_grad``, and a train step is the loss, its backward and an
in-place AdamW update.  On DTensor parameters the same step is the
sharded one: the loss is global, each gradient arrives in its parameter's
placements, and the moments live in the ``opt`` tree's (ZeRO-1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import axis_size, data_axes, mesh_devices
from repro_torch.launch.shardings import PartitionSpec as P
from repro_torch.models.dtensor import is_dtensor
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, adamw_update

PyTree = Any


# ------------------------------------------------------------------ specs
def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta tensors with the reference's input shapes and dtypes: int32
    tokens and labels, bf16 embeds (vlm) and frames (audio)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    i32 = torch.int32
    if shape.mode == "decode":
        return {"tokens": meta((b,), i32)}
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        out["embeds"] = meta((b, s, cfg.d_model), torch.bfloat16)
    elif cfg.family == "audio":
        out["frames"] = meta((b, cfg.enc_ctx, cfg.d_model), torch.bfloat16)
        out["tokens"] = meta((b, s), i32)
    else:
        out["tokens"] = meta((b, s), i32)
    if shape.mode == "train":
        out["labels"] = meta((b, s), i32)
    return out


def _meta_model(model: Model) -> Model:
    return Model(model.cfg, dtype=model.dtype, device="meta",
                 moe_capacity=model.moe_capacity, remat=model.remat)


def abstract_params(model: Model) -> Dict[str, torch.Tensor]:
    """`model`'s parameters by name, built on the meta device."""
    return dict(_meta_model(model).named_parameters())


def abstract_cache(model: Model, cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    """``init_cache`` of the cell's decode shape on the meta device (the
    audio family's with a meta bf16 encoder output)."""
    enc = None
    if cfg.family == "audio":
        enc = torch.empty((shape.global_batch, cfg.enc_ctx, cfg.d_model),
                          dtype=torch.bfloat16, device="meta")
    return _meta_model(model).init_cache(shape.global_batch, shape.seq_len,
                                         enc_out=enc)


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The model's loss on `batch` (detached) and each parameter's
    gradient by name (zeros where the loss did not reach it, as
    ``jax.grad`` gives).  The parameters must require grad.  On DTensor
    parameters the loss is the global one, a plain tensor, and each
    gradient a DTensor in its parameter's placements."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    loss = loss.detach()
    if is_dtensor(loss):
        loss = loss.full_tensor()                 # the global loss
    return loss, {n: _grad(p) for n, p in model.named_parameters()}


def _grad(p: torch.Tensor) -> torch.Tensor:
    """p's gradient (zeros where the loss did not reach p); a DTensor's in
    p's placements (autograd may leave it partial, a sum still owed)."""
    if p.grad is None:
        return torch.zeros_like(p)
    if is_dtensor(p.grad) and p.grad.placements != p.placements:
        return p.grad.redistribute(p.device_mesh, p.placements)
    return p.grad


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_fn: Optional[Callable[[Dict[str, torch.Tensor]],
                                               Dict[str, torch.Tensor]]]
                    = None
                    ) -> Callable[[dict, Dict[str, torch.Tensor]],
                                  Tuple[dict, dict]]:
    """train_step(opt_state, batch) -> (opt_state, {"loss", "grad_norm",
    "lr"}): the loss and its gradients, `grad_fn` on them where given
    (the trainer's int8 compression), then one AdamW step that writes
    the model's parameters in place.  Turns on the parameters' gradients
    (the model is built without them); they are freed after the update."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(opt_state: dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[dict, dict]:
        loss, grads = loss_and_grads(model, batch)
        if grad_fn is not None:
            grads = grad_fn(grads)
        opt_state, metrics = adamw_update(opt_cfg, grads, opt_state, params)
        model.zero_grad(set_to_none=True)
        return opt_state, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(model: Model) -> Callable[[Dict[str, torch.Tensor]],
                                                torch.Tensor]:
    """The step takes the model's batch as it is: "tokens", or "embeds"
    in their place (vlm), and "frames" beside them (audio)."""
    @torch.no_grad()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return model.forward(batch)
    return prefill_step


def make_serve_step(model: Model) -> Callable[[Dict, torch.Tensor],
                                              Tuple[torch.Tensor, Dict]]:
    @torch.no_grad()
    def serve_step(cache: Dict, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
        return model.decode_step(cache, tokens)
    return serve_step


# ------------------------------------------------------------------ shardings
def _zero1_checked(spec: P, dp: Tuple[str, ...], dp_size: int,
                   shape: Tuple[int, ...], axis_sizes=None) -> P:
    """ZeRO-1 moment sharding: put the (still unused) data axes on the first
    unsharded dim whose size divides them (exact divisibility, and no axis
    used twice within one spec)."""
    used = set()
    for ax in spec:
        if ax is None:
            continue
        used.update((ax,) if isinstance(ax, str) else tuple(ax))
    avail = tuple(a for a in dp if a not in used)
    if not avail:
        return spec
    axis_sizes = axis_sizes or {"pod": 2, "data": 16, "model": 16}
    size = 1
    for a in avail:
        size *= axis_sizes.get(a, 1)
    parts = list(spec)
    while len(parts) < len(shape):
        parts.append(None)
    for i, ax in enumerate(parts):
        if ax is None and shape[i] % max(size, 1) == 0 and shape[i] >= size:
            parts[i] = avail if len(avail) > 1 else avail[0]
            return P(*parts)
    return spec


def shardings_for(mesh, model: Model, cfg: ArchConfig, shape: ShapeConfig,
                  zero1: bool = True, policy: str = "tp") -> Dict[str, PyTree]:
    """PartitionSpec trees for params / optimizer / batch / cache, keyed
    as the port keys them (parameters by ``named_parameters()`` name).

    policy:
      "tp"   — Megatron TP over 'model' + DP over data axes (default);
      "fsdp" — ZeRO-3 parameter sharding over ALL axes, batch over all axes;
      "dp"   — (MoE-aware) data parallelism: dense params replicated,
               expert stacks EP-sharded over 'model' when divisible,
               ZeRO-sharded moments.

    `mesh` is a ``DeviceMesh`` or a ``MeshShape``.  The moments' specs
    are ``_zero1_checked`` of each per-layer parameter's spec and shape:
    where the reference's stacked leaf puts the data axes on its layer
    dim, the port's per-layer leaf takes them on its first free dim that
    divides (ZeRO-1's memory saving either way).
    """
    dp = data_axes(mesh)
    dp_size = math.prod(axis_size(mesh, a) for a in dp)
    model_size = axis_size(mesh, "model")
    p_abs = abstract_params(model)
    if policy == "fsdp":
        all_axes = tuple(mesh.mesh_dim_names)
        total = mesh_devices(mesh)
        p_spec = SH.fsdp_param_specs(p_abs, all_axes, total)
        opt_spec = {"m": p_spec, "v": p_spec, "step": P()}
        bspec = SH.batch_spec(cfg, shape, all_axes, total)
        return {"params": p_spec, "opt": opt_spec, "batch": bspec,
                "hidden": None, "divisors": (total, 1)}
    if policy == "dp":
        all_axes = tuple(mesh.mesh_dim_names)
        total = mesh_devices(mesh)
        sizes = {a: axis_size(mesh, a) for a in all_axes}

        def pick(name, leaf):
            keys = SH.ref_keys(name)
            if "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down") \
                    and "shared" not in keys and leaf.dim() >= 3 \
                    and leaf.shape[-3] % max(model_size, 1) == 0 \
                    and leaf.shape[-3] >= model_size:
                parts = [None] * leaf.dim()
                parts[leaf.dim() - 3] = "model"
                return P(*parts)
            return P(*([None] * leaf.dim()))

        p_spec = {n: pick(n, l) for n, l in p_abs.items()}
        z = {n: _zero1_checked(p_spec[n], all_axes, total, tuple(l.shape),
                               sizes) for n, l in p_abs.items()}
        opt_spec = {"m": z, "v": dict(z), "step": P()}
        # MoE archs keep the model axis for EP, so the batch shards over the
        # data axes only; dense archs spread the batch over everything
        if cfg.n_experts:
            bspec = SH.batch_spec(cfg, shape, dp, dp_size)
            return {"params": p_spec, "opt": opt_spec, "batch": bspec,
                    "hidden": None, "divisors": (dp_size, 1)}
        bspec = SH.batch_spec(cfg, shape, all_axes, total)
        return {"params": p_spec, "opt": opt_spec, "batch": bspec,
                "hidden": None, "divisors": (total, 1)}
    if policy != "tp":
        raise ValueError(f"unknown policy {policy!r}; have 'tp', 'fsdp', "
                         f"'dp'")
    p_spec = SH.param_specs(p_abs, model_size)

    def z1(name):
        if not zero1:
            return p_spec[name]
        return _zero1_checked(p_spec[name], dp, dp_size,
                              tuple(p_abs[name].shape))

    opt_spec = {"m": {n: z1(n) for n in p_abs},
                "v": {n: z1(n) for n in p_abs}, "step": P()}
    out = {
        "params": p_spec,
        "opt": opt_spec,
        "batch": SH.batch_spec(cfg, shape, dp, dp_size),
        "hidden": SH.hidden_spec(dp),
        "divisors": (dp_size, model_size),
    }
    if shape.mode == "decode":
        out["cache"] = SH.cache_spec(cfg, shape, dp, dp_size, model_size)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what ``jax.sharding.NamedSharding`` is to the
    reference; ``placements`` are the DTensor's."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return SH.to_placements(self.mesh, self.spec)


def named(mesh, spec_tree: PyTree) -> PyTree:
    """`spec_tree` (nested dicts and lists of specs) with each spec made
    a :class:`NamedSharding` on `mesh`."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")


def shard_model(mesh, model: Model, cfg: ArchConfig, shape: ShapeConfig,
                zero1: bool = True, policy: str = "tp") -> Dict[str, PyTree]:
    """The trainer's placement, as the reference's ``train()`` does it:
    ``shardings_for`` on `mesh` (with `zero1` and `policy`), the model's
    ``hidden_pspec`` / ``hidden_divisors`` set from it, and the parameters
    placed.  Returns the :class:`NamedSharding` trees of the parameters
    (``"params"``) and of the moments (``"opt"``, for ``adamw_init`` and a
    restore)."""
    sh = shardings_for(mesh, model, cfg, shape, zero1=zero1, policy=policy)
    model.hidden_pspec = sh["hidden"]
    model.hidden_divisors = sh["divisors"]
    out = {"params": named(mesh, sh["params"]), "opt": named(mesh, sh["opt"])}
    # every rank holds each whole parameter (the same seed made it): each
    # keeps its own shard of its own copy, and nothing is sent
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        sharding = out["params"][name]
        mod_name, _, leaf = name.rpartition(".")
        dt = distribute_tensor(p.detach(), mesh, sharding.placements,
                               src_data_rank=None)
        model.get_submodule(mod_name)._parameters[leaf] = nn.Parameter(
            dt, requires_grad=p.requires_grad)
    return out
