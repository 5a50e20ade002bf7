"""RWKV6 ("Finch") time-mix with data-dependent decay, and channel-mix.

The port's counterpart of the RWKV6 half of ``repro.models.ssm`` (the
Mamba half comes with the hybrid family).  In a forward pass (no carried
state) the WKV recurrence goes through the ``rwkv6_scan`` kernel on a CUDA
tensor and its plain version on a CPU tensor; in decode (a carried state)
:func:`wkv6_scan` runs it in torch ops, since the kernel starts from a
zero state and returns none.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.layers import Linear, empty_param, linear, upcast


class RWKV(nn.Module):
    """One RWKV6 layer's time-mix and channel-mix parameters, under the
    reference's names (``init_rwkv``)."""

    def __init__(self, d_model: int, head_size: int, d_ff: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        h = d_model // head_size
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
                     "cm_mix_k"):
            setattr(self, name, empty_param((d_model,), **kw))
        for name in ("r", "k", "v", "g", "w_proj", "out"):
            setattr(self, name, Linear(d_model, d_model, **kw))
        self.w_bias = empty_param((d_model,), **f32)
        self.u = empty_param((h, head_size), **f32)
        self.ln_x_w = empty_param((d_model,), **f32)
        self.cm_k = Linear(d_model, d_ff, **kw)
        self.cm_v = Linear(d_ff, d_model, **kw)

    def init_weights(self, gen: torch.Generator) -> None:
        init_rwkv(self, gen)


def init_rwkv(p: RWKV, gen: torch.Generator) -> None:
    for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "cm_mix_k"):
        getattr(p, name).fill_(0.5)
    for name in ("r", "k", "v", "g", "w_proj", "out", "cm_k", "cm_v"):
        getattr(p, name).init_weights(gen)
    p.w_bias.fill_(-6.0)
    p.u.normal_(0.0, 0.1, generator=gen)
    p.ln_x_w.fill_(1.0)


def wkv6_scan(r, k, v, w, u, s0=None):
    """RWKV6 recurrence. r,k,v: (B, L, H, hd); w: (B, L, H, hd) decay in (0,1);
    u: (H, hd) bonus. State s: (B, H, hd, hd). Returns (out (B,L,H,hd) fp32,
    s); fp64 inputs stay fp64."""
    b, L, h, hd = r.shape
    rf, kf, vf, wf = (upcast(a) for a in (r, k, v, w))
    s = (s0 if s0 is not None
         else torch.zeros((b, h, hd, hd), dtype=rf.dtype, device=r.device))
    ys = []
    for t in range(L):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               s + u[None, :, :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _token_shift(x: torch.Tensor, state: Optional[Dict]) -> torch.Tensor:
    b, _, d = x.shape
    prev = (state["shift"] if state is not None
            else torch.zeros((b, 1, d), dtype=x.dtype, device=x.device))
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv_time_mix(p: RWKV, x: torch.Tensor, head_size: int,
                  state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Returns (out, {"wkv", "shift"}).  Without a carried state the scan
    is the ``rwkv6_scan`` kernel, which returns no state: ``wkv`` is then
    None."""
    b, L, d = x.shape
    h = d // head_size
    xs = _token_shift(x, state)
    new_shift = x[:, -1:, :]

    def mix(m):
        return x * m + xs * (1 - m)

    r = linear(p.r, mix(p.mix_r)).reshape(b, L, h, head_size)
    k = linear(p.k, mix(p.mix_k)).reshape(b, L, h, head_size)
    v = linear(p.v, mix(p.mix_v)).reshape(b, L, h, head_size)
    g = linear(p.g, mix(p.mix_g))
    # data-dependent decay (the Finch contribution)
    w_ = upcast(linear(p.w_proj, mix(p.mix_w)))
    w = torch.exp(-torch.exp(w_ + p.w_bias)).reshape(b, L, h, head_size)

    if state is None:
        # fp32 in, fp32 out, as the reference's scan casts its inputs
        y = rwkv6_scan(upcast(r).contiguous(), upcast(k).contiguous(),
                       upcast(v).contiguous(), w.contiguous(), p.u)
        s = None
    else:
        y, s = wkv6_scan(r, k, v, w, p.u, state["wkv"])
    # group norm over heads (approximated by rms over head groups)
    yf = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-5)
    y = (yf.reshape(b, L, d) * p.ln_x_w).to(x.dtype)
    y = y * F.silu(upcast(g)).to(x.dtype)
    out = linear(p.out, y)
    return out, {"wkv": s, "shift": new_shift}


def rwkv_channel_mix(p: RWKV, x: torch.Tensor,
                     state: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    xs = _token_shift(x, state)
    m = p.cm_mix_k
    xk = x * m + xs * (1 - m)
    hdn = linear(p.cm_k, xk)
    hdn = torch.square(torch.relu(upcast(hdn))).to(x.dtype)
    out = linear(p.cm_v, hdn)
    return out, {"shift": x[:, -1:, :]}


def rwkv_init_state(b: int, d_model: int, head_size: int,
                    dtype=torch.float32, device=None) -> Dict:
    h = d_model // head_size
    return {
        "tm": {"wkv": torch.zeros((b, h, head_size, head_size),
                                  dtype=torch.promote_types(
                                      dtype, torch.float32),
                                  device=device),
               "shift": torch.zeros((b, 1, d_model), dtype=dtype,
                                    device=device)},
        "cm": {"shift": torch.zeros((b, 1, d_model), dtype=dtype,
                                    device=device)},
    }
