"""Int8 gradient compression with error feedback.

The port's counterpart of ``repro.optim.compress``: before the
data-parallel reduction each gradient is quantized to int8 with one scale
per row (the leading dim; a vector or scalar is one row), and the
quantization residual is carried in an error-feedback buffer so the
compression is unbiased over time.  Gradients and buffers are
``Dict[str, Tensor]`` keyed by parameter name; a compressed gradient is
``{"q": int8 (rows, cols), "scale": fp32 (rows, 1)}``.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def ef_init(params: Tensors) -> Tensors:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(x.shape[0], -1) if x.dim() > 1 else x.reshape(1, -1)
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def compress_grads(grads: Tensors, ef: Tensors
                   ) -> Tuple[Dict[str, Tensors], Tensors]:
    """Returns (compressed {name: {q, scale}}, new error-feedback buffers)."""
    comp, new_ef = {}, {}
    for name, g in grads.items():
        total = g.to(torch.float32) + ef[name]
        q, s = _quant(total)
        comp[name] = {"q": q, "scale": s}
        new_ef[name] = total - _dequant(q, s, g.shape)
    return comp, new_ef


def decompress_grads(comp: Dict[str, Tensors], like: Tensors) -> Tensors:
    """fp32 gradients of `like`'s shapes from their compressed form."""
    return {name: _dequant(c["q"], c["scale"], like[name].shape)
            for name, c in comp.items()}
