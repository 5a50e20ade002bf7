"""Model primitives: norms, RoPE, MLPs, linear layers.

The port's counterpart of ``repro.models.layers``.  Layers are
``nn.Module``s holding their parameters under the reference's names and
layouts; the math lives in plain functions on tensors, as in the
reference.  A linear weight is stored as the reference stores it,
``(d_in, d_out)``, and applied as ``x @ w``, so a parameter pytree carried
over from JAX loads without transposes.  Norm math runs in fp32 whatever
the activation dtype (fp64 in an fp64 model, which the tests use as a
rounding-free witness; :func:`upcast`).

Parameters are created empty on the module's device, and without
``requires_grad`` (every inference path needs none); the owning model
fills them from an explicit ``torch.Generator`` (:meth:`init_weights`).
A trainer turns gradients on with ``model.requires_grad_()``, as
``launch.steps.make_train_step`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.dtensor import add_bias, gather_seq, replicated_like


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in fp64 if it is fp64: the reference's fp32 casts,
    which never narrow."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(w: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def layer_norm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = upcast(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * w.float() + b.float()
    return out.to(x.dtype)


# --------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., :, None].float() * freqs             # (..., seq, hd/2)
    cos = replicated_like(x, torch.cos(ang)[..., :, None, :])  # (..., seq, 1, hd/2)
    sin = replicated_like(x, torch.sin(ang)[..., :, None, :])
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- modules
def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` shaped ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = empty_param((d_in, d_out), dtype, device)
        self.b = empty_param((d_out,), dtype, device) if bias else None

    def init_weights(self, gen: torch.Generator) -> None:
        self.w.normal_(0.0, 1.0 / math.sqrt(self.w.shape[0]), generator=gen)
        if self.b is not None:
            self.b.zero_()


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p.w)
    if p.b is not None:
        y = add_bias(y, p.b)
    return y


class MLP(nn.Module):
    """Gated (SiLU) or plain (GELU) MLP: ``w_up``, ``w_down`` (+ ``w_gate``,
    + ``b_up``/``b_down``), the reference's names and layouts."""

    def __init__(self, d_model: int, d_ff: int, gated: bool,
                 bias: bool = False, *, dtype=torch.float32, device=None):
        super().__init__()
        self.gated = gated
        self.w_up = empty_param((d_model, d_ff), dtype, device)
        self.w_down = empty_param((d_ff, d_model), dtype, device)
        self.w_gate = (empty_param((d_model, d_ff), dtype, device) if gated
                       else None)
        self.b_up = empty_param((d_ff,), dtype, device) if bias else None
        self.b_down = empty_param((d_model,), dtype, device) if bias else None

    def init_weights(self, gen: torch.Generator) -> None:
        d_model, d_ff = self.w_up.shape
        self.w_up.normal_(0.0, 1.0 / math.sqrt(d_model), generator=gen)
        self.w_down.normal_(0.0, 1.0 / math.sqrt(d_ff), generator=gen)
        if self.w_gate is not None:
            self.w_gate.normal_(0.0, 1.0 / math.sqrt(d_model), generator=gen)
        for b in (self.b_up, self.b_down):
            if b is not None:
                b.zero_()


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    x = gather_seq(x)
    if p.gated:
        g = torch.matmul(x, p.w_gate)
        u = torch.matmul(x, p.w_up)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = torch.matmul(x, p.w_up)
        if p.b_up is not None:
            h = h + p.b_up
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    out = torch.matmul(h, p.w_down)
    if p.b_down is not None:
        out = out + p.b_down
    return out
