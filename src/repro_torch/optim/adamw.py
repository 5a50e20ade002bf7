"""AdamW + cosine schedule + global-norm clipping over a parameter dict.

The port's counterpart of ``repro.optim.adamw``.  Parameters, gradients
and moments are plain ``Dict[str, Tensor]`` keyed as ``named_parameters()``
keys them; the state is ``{"m", "v"}`` (fp32 dicts) plus ``"step"`` (a
0-d int32 tensor), as the reference's pytree is.  The update follows the
reference's order: clip by the global norm, bias-correct, then add
``weight_decay * p`` to the step after the division (no decoupled lr
factor), which is why ``torch.optim.AdamW`` (decay applied as
``p *= 1 - lr * wd`` before the step) is not used.  JAX's update returns
new arrays; this one writes the parameters and moments in place, which
saves a copy of each at full width.

On a mesh the parameters, gradients and moments are DTensors: each moment
in its ``opt`` spec's placements (ZeRO-1: the data axes on its first free
dim that divides), each gradient redistributed to its moment's placements
(a local slice), the element-wise update done on the local shards, and
the parameter written back in its own placements.  The global norm sums
each gradient's sum of squares over its shards first; on a mesh of one
every step is the plain one's, bit for bit.

While the process tracer records (:data:`repro_torch.obs.PROCESS_TRACER`),
:func:`adamw_update` is the device span ``optim.adamw``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.obs.trace import PROCESS_TRACER as _TRACER

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine decay to 0 at ``total_steps``; fp32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def _zeros(p: torch.Tensor, sharding) -> torch.Tensor:
    if sharding is None:
        return torch.zeros_like(p, dtype=torch.float32)
    from torch.distributed.tensor import zeros
    return zeros(tuple(p.shape), dtype=torch.float32,
                 device_mesh=sharding.mesh, placements=sharding.placements)


def adamw_init(params: Tensors, shardings: Optional[dict] = None) -> dict:
    """Zero fp32 moments beside each parameter, and step 0 (a plain 0-d
    tensor).  `shardings` (``named(mesh, shardings_for(...)["opt"])``)
    places each moment as a DTensor with its ``"m"`` / ``"v"``
    sharding's placements."""
    def zeros(which):
        return {n: _zeros(p, None if shardings is None
                          else shardings[which][n])
                for n, p in params.items()}
    p0 = next(iter(params.values()))
    dev = p0.device_mesh.device_type if isinstance(p0, DTensor) else p0.device
    return {"m": zeros("m"), "v": zeros("v"),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(x.float()))
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32 (a DTensor's
    sum over its shards first)."""
    total = sum(_sum_squares(x) for x in tensors.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _local(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x's shard in `like`'s placements (x itself off a mesh)."""
    if not isinstance(like, DTensor):
        return x
    return x.redistribute(like.device_mesh, like.placements).to_local()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tensors, opt_state: dict,
                 params: Tensors) -> Tuple[dict, dict]:
    """One AdamW step: writes `params` and the moments in place; returns
    the new state and ``{"grad_norm", "lr"}`` (0-d fp32 tensors)."""
    with _TRACER.span("optim.adamw", device=opt_state["step"].device):
        return _update(cfg, grads, opt_state, params)


def _update(cfg: AdamWConfig, grads: Tensors, opt_state: dict,
            params: Tensors) -> Tuple[dict, dict]:
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=sf.device), sf)
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in params.items():
        m_d, v_d = m_all[name], v_all[name]
        m, v = _local(m_d, m_d), _local(v_d, v_d)
        g = _local(grads[name], m_d).float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        pf = _local(p, m_d).float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        new = pf - lr * delta
        if isinstance(p, DTensor):
            new = DTensor.from_local(new.to(p.dtype), m_d.device_mesh,
                                     m_d.placements, run_check=False,
                                     shape=p.shape, stride=p.stride())
        p.copy_(new)
    return ({"m": m_all, "v": v_all, "step": step},
            {"grad_norm": gnorm, "lr": lr})
