"""State-space / linear-recurrence layers: the Mamba selective scan and
the RWKV6 ("Finch") time-mix with data-dependent decay, and channel-mix.

The port's counterpart of ``repro.models.ssm``.  In a forward pass (no
carried state) the Mamba scan goes through the ``ssm_scan`` kernel and the
RWKV6 WKV recurrence through the ``rwkv6_scan`` kernel on a CUDA tensor,
and through their plain versions on a CPU tensor (on DTensors, either
on each rank's local shards: ``models.dtensor``), or, inside
``models.attention.kernel_route`` (the dry run's trace), through each
scan's counted op (``ssm_scan_counted``, ``rwkv6_scan_counted``: the
plain version as one op forward and one backward); in decode (a carried
state) :func:`_selective_scan` and :func:`wkv6_scan` run them in torch
ops, since the kernels start from a zero state and return none.

The RWKV layer has two layouts (:class:`RWKV`): the repository's, which
the reference defines, and Finch's published one (data-dependent token
shift and decay through LoRAs, GroupNorm with a bias, a receptance-gated
channel mix), which the config's ``rwkv_mix_lora`` / ``rwkv_decay_lora``
select.  Both run the same scans.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_counted
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_counted
from repro_torch.models.attention import in_kernel_route
from repro_torch.models.dtensor import (channel_kernel, chunk_last,
                                        gather_seq, is_dtensor, local_einsum,
                                        pinned, rwkv_kernel, split_heads,
                                        ssm_kernel)
from repro_torch.models.layers import Linear, empty_param, linear, upcast
from repro_torch.obs.trace import PROCESS_TRACER as _TRACER


# =====================================================================
# Mamba (selective scan), expansion factor 2
# =====================================================================

class Mamba(nn.Module):
    """One Mamba block's parameters, under the reference's names
    (``init_mamba``)."""

    def __init__(self, d_model: int, d_state: int, d_conv: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        d_in = 2 * d_model
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = Linear(d_model, 2 * d_in, **kw)
        self.conv_w = empty_param((d_conv, d_in), **kw)
        self.conv_b = empty_param((d_in,), **kw)
        self.x_proj = Linear(d_in, d_state * 2 + 1, **kw)
        self.dt_bias = empty_param((d_in,), **f32)
        self.A_log = empty_param((d_in, d_state), **f32)
        self.D = empty_param((d_in,), **f32)
        self.out_proj = Linear(d_in, d_model, **kw)

    def init_weights(self, gen: torch.Generator) -> None:
        init_mamba(self, gen)


def init_mamba(p: Mamba, gen: torch.Generator) -> None:
    d_conv, d_in = p.conv_w.shape
    p.in_proj.init_weights(gen)
    p.conv_w.normal_(0.0, 1.0 / math.sqrt(d_conv), generator=gen)
    p.conv_b.zero_()
    p.x_proj.init_weights(gen)
    p.dt_bias.zero_()
    n = p.A_log.shape[1]
    states = torch.arange(1, n + 1, dtype=torch.float32,
                          device=p.A_log.device)
    p.A_log.copy_(torch.log(states).expand(d_in, n))
    p.D.fill_(1.0)
    p.out_proj.init_weights(gen)


def _selective_scan(u, dt, A, B, C, D, h0=None):
    """u: (B, L, d_in); dt: (B, L, d_in); A: (d_in, N); B, C: (B, L, N).

    h_t = exp(dt*A) h_{t-1} + dt * B_t * u_t ;  y_t = C_t . h_t + D*u_t
    Loop over time, state (B, d_in, N) fp32 (fp64 for fp64 inputs).
    Returns (y fp32, h)."""
    bsz, L, d_in = u.shape
    uf, dtf, Bf, Cf = (upcast(x) for x in (u, dt, B, C))
    h = (h0 if h0 is not None
         else torch.zeros((bsz, d_in, A.shape[1]), dtype=uf.dtype,
                          device=u.device))
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t, :, None] * A[None])          # (B, d, N)
        dBu = dtf[:, t, :, None] * Bf[:, t, None, :] * uf[:, t, :, None]
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + D[None, None, :] * uf
    return y, h


def mamba_block(p: Mamba, x: torch.Tensor, state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, L, d).  state (decode): {"h": (B, d_in, N), "conv": (B,
    d_conv-1, d_in)}.  Returns (y, new_state).  Without a carried state
    the scan is the ``ssm_scan`` kernel, which returns no state: ``h`` is
    then None.  A sequence-parallel input is gathered first
    (``gather_seq``)."""
    b, L, _ = x.shape
    x = gather_seq(x)
    d_conv, d_in = p.conv_w.shape
    n = p.A_log.shape[1]

    xz = linear(p.in_proj, x)                              # (B, L, 2*d_in)
    u, z = chunk_last(xz, 2)

    # causal depthwise conv1d (a zero history placed as u is)
    prev = (state["conv"] if state is not None
            else torch.zeros_like(u[:, :1]).expand(b, d_conv - 1, d_in))
    upad = torch.cat([prev, u], dim=1)                     # (B, L+dc-1, d_in)
    new_conv = upad[:, -(d_conv - 1):, :] if d_conv > 1 else prev
    conv = sum(upad[:, i:i + L, :] * p.conv_w[i][None, None]
               for i in range(d_conv)) + p.conv_b
    u = F.silu(upcast(conv)).to(x.dtype)

    proj = pinned(linear(p.x_proj, u))                     # (B, L, 2N+1)
    Bm, Cm, dt_raw = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n:]
    # (B, L, 1) + (d_in,): dt is (B, L, d_in), contiguous
    dt = (channel_kernel(_dt, u, dt_raw, p.dt_bias) if is_dtensor(u)
          else _dt(dt_raw, p.dt_bias))
    A = -torch.exp(p.A_log)

    if state is None:
        # fp32 in, fp32 out, as the reference's scan casts its inputs
        uf = upcast(u)
        args = (uf, dt.to(uf.dtype), A, upcast(Bm), upcast(Cm))
        y = (ssm_kernel(_ssm_local, *args) if is_dtensor(uf)
             else _ssm_local(*args))
        y = y + p.D[None, None, :] * uf
        h = None
    else:
        y, h = _selective_scan(u, dt, A, Bm, Cm, p.D, state["h"])
    y = y.to(x.dtype) * F.silu(upcast(z)).to(x.dtype)
    out = linear(p.out_proj, y)
    return out, {"h": h, "conv": new_conv}


def _dt(dt_raw, dt_bias):
    return F.softplus(upcast(dt_raw) + dt_bias[None, None])


def _ssm_local(u, dt, a, b, c):
    scan = (ssm_scan_counted if u.device.type == "cpu" and in_kernel_route()
            else ssm_scan)
    return scan(u.contiguous(), dt.contiguous(), a, b.contiguous(),
                c.contiguous())


def mamba_init_state(b: int, d_model: int, d_state: int, d_conv: int,
                     dtype=torch.float32, device=None) -> Dict:
    d_in = 2 * d_model
    return {"h": torch.zeros((b, d_in, d_state),
                             dtype=torch.promote_types(dtype, torch.float32),
                             device=device),
            "conv": torch.zeros((b, d_conv - 1, d_in), dtype=dtype,
                                device=device)}


# =====================================================================
# RWKV6 "Finch": time-mix with data-dependent decay + channel-mix
# =====================================================================

class RWKV(nn.Module):
    """One RWKV6 layer's time-mix and channel-mix parameters.  By default
    the repository's layer, under the reference's names (``init_rwkv``);
    with `mix_lora` and `decay_lora` (both set) Finch's published layer
    (``RWKV_Tmix_x060`` / ``RWKV_CMix_x060``, :func:`init_finch`):

    - ``maa_x``, ``maa_w``, ``maa_k``, ``maa_v``, ``maa_r``, ``maa_g``
      (d,): the token-shift interpolations, ``maa_w1`` (d, 5 R) and
      ``maa_w2`` (5, R, d) the LoRA that makes the last five data
      dependent (slots in the order w, k, v, r, g);
    - ``w_bias`` (d,), ``decay_w1`` (d, D) and ``decay_w2`` (D, d): the
      decay ``exp(-exp(w_bias + tanh(xw @ decay_w1) @ decay_w2))``;
    - ``u`` (H, hd) the bonus; ``ln_x_w``, ``ln_x_b`` (d,) the GroupNorm
      over the heads after the scan;
    - ``cm_maa_k``, ``cm_maa_r`` (d,), ``cm_k``, ``cm_v`` and ``cm_r``: the
      channel mix with its receptance gate.

    Both layouts share ``r``, ``k``, ``v``, ``g``, ``out``, ``cm_k`` and
    ``cm_v`` (no bias)."""

    def __init__(self, d_model: int, head_size: int, d_ff: int, *,
                 mix_lora: int = 0, decay_lora: int = 0,
                 dtype=torch.float32, device=None):
        super().__init__()
        h = d_model // head_size
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.finch = mix_lora > 0
        if not self.finch:
            for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
                         "cm_mix_k"):
                setattr(self, name, empty_param((d_model,), **kw))
        linears = (("r", "k", "v", "g", "out") if self.finch
                   else ("r", "k", "v", "g", "w_proj", "out"))
        for name in linears:
            setattr(self, name, Linear(d_model, d_model, **kw))
        self.w_bias = empty_param((d_model,), **f32)
        self.u = empty_param((h, head_size), **f32)
        self.ln_x_w = empty_param((d_model,), **f32)
        self.cm_k = Linear(d_model, d_ff, **kw)
        self.cm_v = Linear(d_ff, d_model, **kw)
        if self.finch:
            for name in FINCH_MIXES:
                setattr(self, name, empty_param((d_model,), **kw))
            self.maa_w1 = empty_param((d_model, 5 * mix_lora), **kw)
            self.maa_w2 = empty_param((5, mix_lora, d_model), **kw)
            self.decay_w1 = empty_param((d_model, decay_lora), **kw)
            self.decay_w2 = empty_param((decay_lora, d_model), **kw)
            self.ln_x_b = empty_param((d_model,), **f32)
            self.cm_r = Linear(d_model, d_model, **kw)

    def init_weights(self, gen: torch.Generator) -> None:
        (init_finch if self.finch else init_rwkv)(self, gen)


# Finch's token-shift interpolations (x + (shift(x) - x) * maa), the first
# of the time mix's and the two of its channel mix
FINCH_MIXES = ("maa_x", "maa_w", "maa_k", "maa_v", "maa_r", "maa_g",
               "cm_maa_k", "cm_maa_r")
# Finch's GroupNorm after the scan: eps 1e-5 x head_size_divisor^2, the
# divisor 8 (upstream divides y by it before a norm at eps 1e-5)
FINCH_GROUP_NORM_EPS = 1e-5 * 8 ** 2


def init_rwkv(p: RWKV, gen: torch.Generator) -> None:
    for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "cm_mix_k"):
        getattr(p, name).fill_(0.5)
    for name in ("r", "k", "v", "g", "w_proj", "out", "cm_k", "cm_v"):
        getattr(p, name).init_weights(gen)
    p.w_bias.fill_(-6.0)
    p.u.normal_(0.0, 0.1, generator=gen)
    p.ln_x_w.fill_(1.0)


def init_finch(p: RWKV, gen: torch.Generator) -> None:
    """Finch's layer after upstream's regime, simplified: the mixes 0.5,
    both LoRAs' inner ends zero and outer ends uniform in +-0.01 (the
    mixes and the decay start static), a decay ramp from -6 to -1 over
    the channels, the bonus 0.5, the GroupNorm's weight 1 and bias 0."""
    for name in FINCH_MIXES:
        getattr(p, name).fill_(0.5)
    for name in ("r", "k", "v", "g", "out", "cm_k", "cm_v", "cm_r"):
        getattr(p, name).init_weights(gen)
    for w1, w2 in ((p.maa_w1, p.maa_w2), (p.decay_w1, p.decay_w2)):
        w1.zero_()
        w2.uniform_(-0.01, 0.01, generator=gen)
    d = p.w_bias.shape[0]
    p.w_bias.copy_(torch.linspace(-6.0, -1.0, d, device=p.w_bias.device))
    p.u.fill_(0.5)
    p.ln_x_w.fill_(1.0)
    p.ln_x_b.zero_()


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
        ys.append(local_einsum("bhk,bhkv->bhv", rf[:, t],
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
    None.

    While the process tracer records, the whole is the device span
    ``rwkv.time_mix`` and, in Finch's layout, the token shift, the mixes'
    LoRA, the five interpolations and the decay LoRA the device span
    ``rwkv.lora`` inside it; both carry the ``tokens`` and ``heads`` they
    cover."""
    b, L, d = x.shape
    h = d // head_size
    with _TRACER.span("rwkv.time_mix", device=x.device, tokens=b * L,
                      heads=h):
        if p.finch:
            with _TRACER.span("rwkv.lora", device=x.device, tokens=b * L,
                              heads=h):
                xr, xk, xv, xg, w_ = _finch_mixes(p, x,
                                                  _token_shift(x, state))
        else:
            xs = _token_shift(x, state)

            def mix(m):
                return x * m + xs * (1 - m)
            xr, xk, xv, xg = (mix(m) for m in (p.mix_r, p.mix_k, p.mix_v,
                                                p.mix_g))
            # data-dependent decay (the Finch contribution)
            w_ = torch.exp(-torch.exp(upcast(linear(p.w_proj, mix(p.mix_w)))
                                      + p.w_bias))
        r = split_heads(linear(p.r, xr), h, head_size)
        k = split_heads(linear(p.k, xk), h, head_size)
        v = split_heads(linear(p.v, xv), h, head_size)
        g = linear(p.g, xg)
        w = split_heads(w_, h, head_size)

        if state is None:
            # fp32 in, fp32 out, as the reference's scan casts its inputs
            args = (upcast(r), upcast(k), upcast(v), w, p.u)
            y = (rwkv_kernel(_rwkv_local, *args) if is_dtensor(w)
                 else _rwkv_local(*args))
            s = None
        else:
            y, s = wkv6_scan(r, k, v, w, p.u, state["wkv"])
        if p.finch:
            # GroupNorm over each head, with its weight and bias
            mu = torch.mean(y, dim=-1, keepdim=True)
            var = torch.var(y, dim=-1, unbiased=False, keepdim=True)
            yf = (y - mu) * torch.rsqrt(var + FINCH_GROUP_NORM_EPS)
            y = (yf.reshape(b, L, d) * p.ln_x_w + p.ln_x_b).to(x.dtype)
        else:
            # group norm over heads (approximated by rms over head groups)
            yf = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True)
                                 + 1e-5)
            y = (yf.reshape(b, L, d) * p.ln_x_w).to(x.dtype)
        y = y * F.silu(upcast(g)).to(x.dtype)
        out = linear(p.out, y)
    return out, {"wkv": s, "shift": x[:, -1:, :]}


def _finch_mixes(p: RWKV, x: torch.Tensor, xs: torch.Tensor):
    """Finch's data-dependent token shift of x (B, L, d) and its shifted
    copy xs: (xr, xk, xv, xg, w), w the decay in (0, 1), fp32."""
    b, L, d = x.shape
    xx = xs - x
    xxx = x + xx * p.maa_x
    rank = p.maa_w2.shape[1]
    m = torch.tanh(torch.matmul(xxx, p.maa_w1))              # (B, L, 5R)
    m = torch.bmm(m.reshape(b * L, 5, rank).transpose(0, 1), p.maa_w2)
    mw, mk, mv, mr, mg = m.reshape(5, b, L, d).unbind(0)
    xw = x + xx * (p.maa_w + mw)
    xk = x + xx * (p.maa_k + mk)
    xv = x + xx * (p.maa_v + mv)
    xr = x + xx * (p.maa_r + mr)
    xg = x + xx * (p.maa_g + mg)
    ww = torch.matmul(torch.tanh(torch.matmul(xw, p.decay_w1)), p.decay_w2)
    w = torch.exp(-torch.exp(upcast(ww) + p.w_bias))
    return xr, xk, xv, xg, w


def _rwkv_local(r, k, v, w, u):
    scan = (rwkv6_scan_counted
            if r.device.type == "cpu" and in_kernel_route() else rwkv6_scan)
    return scan(r.contiguous(), k.contiguous(), v.contiguous(),
                w.contiguous(), u)


def rwkv_channel_mix(p: RWKV, x: torch.Tensor,
                     state: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """The squared-ReLU FFN of the token-shifted x; in Finch's layout
    gated by the sigmoid of its receptance."""
    xs = _token_shift(x, state)
    if p.finch:
        xx = xs - x
        xk = x + xx * p.cm_maa_k
    else:
        m = p.cm_mix_k
        xk = x * m + xs * (1 - m)
    hdn = linear(p.cm_k, xk)
    hdn = torch.square(torch.relu(upcast(hdn))).to(x.dtype)
    out = linear(p.cm_v, hdn)
    if p.finch:
        rr = linear(p.cm_r, x + xx * p.cm_maa_r)
        out = torch.sigmoid(upcast(rr)).to(x.dtype) * out
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
