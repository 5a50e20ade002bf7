"""Plain PyTorch reference of RWKV-6 "Finch" (arXiv:2404.05892), the layer
of the upstream ``RWKV_Tmix_x060`` / ``RWKV_CMix_x060`` and of the HF
``modeling_rwkv6.py``, with C = d_model, H = C / hd and shift(x) the
previous token (zero at t = 0):

- block i: ``x = LN0(x)`` if i == 0, ``x = x + TimeMix(LN1(x))``,
  ``x = x + ChannelMix(LN2(x))``; after the stack ``LN_out`` and the head.
  Every LN is a LayerNorm with a weight and a bias; no linear has a bias.
- TimeMix(x): ``xx = shift(x) - x``, ``m = tanh((x + xx maa_x) @ maa_w1)``
  viewed (B, T, 5, R) and multiplied slot by slot with ``maa_w2`` (5, R,
  C) into mw, mk, mv, mr, mg; ``x* = x + xx (maa_* + m*)``; r, k, v from
  their products, ``g = silu(xg @ Wg)``, the decay ``w = exp(-exp(w_bias
  + tanh(xw @ decay_w1) @ decay_w2))``; per head ``y_t = r_t (S_{t-1} +
  diag(u) k_t^T v_t)``, ``S_t = diag(w_t) S_{t-1} + k_t^T v_t``; a
  GroupNorm of H groups with a weight and a bias at eps 1e-5 x
  head_size_divisor^2; ``out = (y g) @ Wo``.
- ChannelMix(x): ``xx = shift(x) - x``, ``out = sigmoid((x + xx cm_maa_r)
  @ Wr') (relu((x + xx cm_maa_k) @ Wk')^2 @ Wv')``.

Weights are keyed as the port keys Finch's layout (:func:`param_spec`).
This file imports torch alone: no kernel, nothing of the program.  The
recurrence is stepped one token at a time in fp32, forward and back, its
bonus term ``(r_t . (u k_t)) v_t`` taken for all steps at once; under a
gradient every layer is recomputed in the backward and the scan keeps the
state at every :data:`SEGMENT` steps only, so that a step at the cell's
size fits beside the program's freed memory.  Every
product runs in fp32 with TF32 off, unless ``precision("tf32")`` asks for
the control (on a CUDA tensor the tensor cores' TF32, on a CPU tensor each
product's inputs rounded to TF32's 10 mantissa bits).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]

# published config key -> the ``model`` field it sets (all compared)
PUBLISHED = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
             "vocab_size": "vocab", "head_size": "rwkv_head_size",
             "layer_norm_epsilon": "norm_eps",
             "tie_word_embeddings": "tie_embeddings"}
# the published divisor of the GroupNorm's eps (no field of the model)
HEAD_SIZE_DIVISOR = 8
GROUP_NORM_EPS = 1e-5 * HEAD_SIZE_DIVISOR ** 2
SEGMENT = 256          # scan steps whose states the backward recomputes

MIXES = ("maa_x", "maa_w", "maa_k", "maa_v", "maa_r", "maa_g")
CM_MIXES = ("cm_maa_k", "cm_maa_r")
GAINS = ("ln0", "ln1", "ln2", "final_norm", "ln_x_w")
BIASES = ("ln0_b", "ln1_b", "ln2_b", "final_norm_b", "ln_x_b")
SMALL_MATRICES = ("maa_w1", "maa_w2", "decay_w1", "decay_w2", "rwkv.out.w",
                  "rwkv.cm_v.w")


def param_spec(a: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight of the model `a` (a configuration's
    ``model`` dict), in a fixed order.  Linear weights are (d_in, d_out),
    applied as ``x @ w``."""
    c, f, hd = a["d_model"], a["d_ff"], a["rwkv_head_size"]
    rm, rd = a["rwkv_mix_lora"], a["rwkv_decay_lora"]
    spec: List[Tuple[str, Tuple[int, ...]]] = [
        ("embed", (a["vocab"], c)), ("ln0", (c,)), ("ln0_b", (c,))]
    for i in range(a["n_layers"]):
        p = f"layers.{i}."
        t = p + "rwkv."
        spec += [(p + n, (c,)) for n in ("ln1", "ln1_b", "ln2", "ln2_b")]
        spec += [(t + n, (c,)) for n in MIXES]
        spec += [(t + "maa_w1", (c, 5 * rm)), (t + "maa_w2", (5, rm, c)),
                 (t + "decay_w1", (c, rd)), (t + "decay_w2", (rd, c)),
                 (t + "w_bias", (c,)), (t + "u", (c // hd, hd))]
        spec += [(t + f"{n}.w", (c, c)) for n in ("r", "k", "v", "g", "out")]
        spec += [(t + "ln_x_w", (c,)), (t + "ln_x_b", (c,))]
        spec += [(t + n, (c,)) for n in CM_MIXES]
        spec += [(t + "cm_k.w", (c, f)), (t + "cm_v.w", (f, c)),
                 (t + "cm_r.w", (c, c))]
    spec += [("final_norm", (c,)), ("final_norm_b", (c,)),
             ("lm_head.w", (c, a["vocab"]))]
    return spec


def init_leaf(name: str, t: torch.Tensor) -> None:
    """Scale a unit normal leaf in place to its role, after upstream's
    regime: norm gains 1 +/- 0.1 and biases 0.1; the token-shift mixes
    0.5 +/- 0.1, clipped to [0, 1]; the decay a ramp over the channels
    from -6 to -1, +/- 0.1; the bonus 0.5 +/- 0.1; both LoRAs' matrices
    0.1 / sqrt(fan in) (small, as upstream's zero and +-0.01, and non-zero
    so that every leaf has a gradient); the time mix's output and the
    channel mix's value 0.1 / sqrt(fan in) (upstream starts both at zero,
    each block near the identity: at 1 / sqrt(fan in) sixteen random
    blocks amplify round-off in the first layers' gradients ~1e3-fold);
    every other matrix 1 / sqrt(fan in), the embedding 1."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith(SMALL_MATRICES):
        t.mul_(0.1 / math.sqrt(t.shape[-2]))
    elif leaf in GAINS:
        t.mul_(0.1).add_(1.0)
    elif leaf in BIASES:
        t.mul_(0.1)
    elif leaf in MIXES or leaf in CM_MIXES:
        t.mul_(0.1).add_(0.5).clamp_(0.0, 1.0)
    elif leaf == "w_bias":
        ramp = torch.linspace(-6.0, -1.0, t.shape[0], dtype=t.dtype,
                              device=t.device)
        t.mul_(0.1).add_(ramp)
    elif leaf == "u":
        t.mul_(0.1).add_(0.5)
    elif leaf == "w":
        t.mul_(1.0 / math.sqrt(t.shape[-2]))
    elif leaf != "embed":
        raise KeyError(f"init_leaf: no role for {name!r}")


# ------------------------------------------------------------- precision
_PRECISION = ["fp32"]


@contextlib.contextmanager
def precision(mode: str):
    """Products inside the block run in `mode`: "fp32" (TF32 off) or
    "tf32" (the control)."""
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"precision {mode!r}: 'fp32' or 'tf32'")
    saved = (_PRECISION[0], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _PRECISION[0] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_PRECISION[0], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to nearest, ties away, to TF32's 10 mantissa bits
    (the gradient passes through unrounded)."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the block's precision."""
    if _PRECISION[0] == "tf32" and not x.is_cuda:
        return torch.matmul(round_tf32(x), round_tf32(w))
    return torch.matmul(x, w)


# ------------------------------------------------------------- blocks
def layer_norm(w: Weights, name: str, x: torch.Tensor, eps: float
               ) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[name], w[name + "_b"], eps)


def shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's x (B, T, C), zero at t = 0."""
    return F.pad(x, (0, 0, 1, -1))


class _Recurrence(torch.autograd.Function):
    """r_t S_{t-1} for every step of (B, T, H, hd) r, k, v and decay, the
    state stepped one token at a time from zero, S_t = diag(w_t) S_{t-1}
    + k_t^T v_t (one update a step; the outer products made a segment at
    a time and the outputs read from the states kept, in one product).

    Its gradient is the same recurrence run back, one step at a time:
    G_{t-1} = diag(w_t) G_t + r_t^T dy_t from G_T = 0 (G_t = dL/dS_t),
    then dr_t = S_{t-1} dy_t, dk_t = G_t v_t, dv_t = G_t^T k_t and dw_t =
    rowsum(G_t * S_{t-1}) in products over each segment.  Only each
    segment's incoming state is kept; the backward steps the states of a
    segment forward again before walking it back."""

    @staticmethod
    def forward(ctx, r, k, v, dec):
        b, t, h, hd = r.shape
        s = torch.zeros((b, h, hd, hd), dtype=r.dtype, device=r.device)
        starts, ys = [], []
        for t0 in range(0, t, SEGMENT):
            starts.append(s)
            sl = slice(t0, t0 + SEGMENT)
            before, s = _states(k[:, sl], v[:, sl], dec[:, sl], s)
            ys.append(mm(r[:, sl, :, None, :], before)[..., 0, :])
        ctx.save_for_backward(r, k, v, dec, *starts)
        return torch.cat(ys, dim=1)

    @staticmethod
    def backward(ctx, dy):
        r, k, v, dec, *starts = ctx.saved_tensors
        g = torch.zeros_like(starts[0])
        grads = [[], [], [], []]
        for i in range(len(starts) - 1, -1, -1):
            sl = slice(i * SEGMENT, (i + 1) * SEGMENT)
            kk, vv, ww, rr, dd = (z[:, sl] for z in (k, v, dec, r, dy))
            before, _ = _states(kk, vv, ww, starts[i])
            rdy = rr[..., :, None] * dd[..., None, :]
            after = []
            for rdy_t, w_t in zip(reversed(rdy.unbind(1)),
                                  reversed(ww.unbind(1))):
                after.append(g)
                g = torch.addcmul(rdy_t, w_t[..., None], g)
            after = torch.stack(after[::-1], dim=1)          # G_t, (B, L, H, hd, hd)
            grads[0].append(torch.matmul(before, dd[..., None])[..., 0])
            grads[1].append(torch.matmul(after, vv[..., None])[..., 0])
            grads[2].append(torch.matmul(kk[..., None, :], after)[..., 0, :])
            grads[3].append((after * before).sum(-1))
        return tuple(torch.cat(x[::-1], dim=1) for x in grads)


def _states(k, v, dec, s):
    """(S_{t-1} for each step of a segment, stacked (B, L, H, hd, hd); the
    segment's last state) from its incoming state s."""
    kv = k[..., :, None] * v[..., None, :]
    before = []
    for kv_t, w_t in zip(kv.unbind(1), dec.unbind(1)):
        before.append(s)
        s = torch.addcmul(kv_t, w_t[..., None], s)
    return torch.stack(before, dim=1), s


def wkv(r, k, v, dec, u, hd: int) -> torch.Tensor:
    """The WKV recurrence of (B, T, C) r, k, v and decay from a zero state,
    one step at a time in fp32: y_t = r_t S_{t-1} + (r_t . (u k_t)) v_t,
    S_t = diag(w_t) S_{t-1} + k_t^T v_t per head (:class:`_Recurrence`;
    the bonus term for every step at once)."""
    b, t, c = r.shape
    r, k, v, dec = (z.reshape(b, t, c // hd, hd) for z in (r, k, v, dec))
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    return (_Recurrence.apply(r, k, v, dec) + bonus).reshape(b, t, c)


def time_mix(w: Weights, p: str, x: torch.Tensor, a: dict) -> torch.Tensor:
    b, t, c = x.shape
    hd, rank = a["rwkv_head_size"], a["rwkv_mix_lora"]
    xx = shift(x) - x
    m = torch.tanh(mm(x + xx * w[p + "maa_x"], w[p + "maa_w1"]))
    m = mm(m.reshape(b, t, 5, rank).permute(2, 0, 1, 3),
           w[p + "maa_w2"][:, None])                       # (5, B, T, C)
    xw, xk, xv, xr, xg = (x + xx * (w[p + n] + m[j]) for j, n in
                          enumerate(("maa_w", "maa_k", "maa_v", "maa_r",
                                     "maa_g")))
    r = mm(xr, w[p + "r.w"])
    k = mm(xk, w[p + "k.w"])
    v = mm(xv, w[p + "v.w"])
    g = F.silu(mm(xg, w[p + "g.w"]))
    dec = torch.exp(-torch.exp(w[p + "w_bias"] + mm(
        torch.tanh(mm(xw, w[p + "decay_w1"])), w[p + "decay_w2"])))
    y = wkv(r, k, v, dec, w[p + "u"], hd)
    y = F.group_norm(y.reshape(b * t, c), c // hd, w[p + "ln_x_w"],
                     w[p + "ln_x_b"], GROUP_NORM_EPS).reshape(b, t, c)
    return mm(y * g, w[p + "out.w"])


def channel_mix(w: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    xx = shift(x) - x
    kk = torch.relu(mm(x + xx * w[p + "cm_maa_k"], w[p + "cm_k.w"])) ** 2
    rr = torch.sigmoid(mm(x + xx * w[p + "cm_maa_r"], w[p + "cm_r.w"]))
    return rr * mm(kk, w[p + "cm_v.w"])


def layer(w: Weights, i: int, h: torch.Tensor, a: dict) -> torch.Tensor:
    p, eps = f"layers.{i}.", a["norm_eps"]
    h = h + time_mix(w, p + "rwkv.", layer_norm(w, p + "ln1", h, eps), a)
    return h + channel_mix(w, p + "rwkv.", layer_norm(w, p + "ln2", h, eps))


def hidden(w: Weights, tokens: torch.Tensor, a: dict, remat: bool = False
           ) -> torch.Tensor:
    """The output norm's output (B, S, C) for tokens (B, S).  With `remat`
    each layer is recomputed in the backward (so a gradient fits)."""
    eps = a["norm_eps"]
    h = layer_norm(w, "ln0", w["embed"][tokens], eps)
    for i in range(a["n_layers"]):
        if remat:
            h = checkpoint(layer, w, i, h, a, use_reentrant=False)
        else:
            h = layer(w, i, h, a)
    return layer_norm(w, "final_norm", h, eps)


@torch.no_grad()
def logits(w: Weights, tokens: torch.Tensor, a: dict,
           routes: Optional[dict] = None) -> torch.Tensor:
    """Logits (B, S, vocab) of a prefill of tokens (B, S); `routes` must
    be None (the model has no experts)."""
    if routes is not None:
        raise ValueError("rwkv6 has no experts to route")
    return mm(hidden(w, tokens, a), w["lm_head.w"])


def loss(w: Weights, tokens: torch.Tensor, labels: torch.Tensor, a: dict
         ) -> torch.Tensor:
    """Mean next-token NLL (fp32 log-softmax) over the positions whose
    label is >= 0, layers recomputed in the backward."""
    x = hidden(w, tokens, a, remat=True)
    logp = torch.log_softmax(mm(x, w["lm_head.w"]), dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# ------------------------------------------------------------- training
def cosine_lr(o: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to 0 at ``total_steps``."""
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * prog))


def train_steps(w: Weights, batches, a: dict, o: dict) -> dict:
    """AdamW steps over `batches` ((tokens, labels) pairs), each: the loss
    and its gradients, clipping by the global norm, bias-corrected moments,
    and p <- p - lr (m_hat / (sqrt(v_hat) + eps) + weight_decay p), with
    the parameters updated in place.  Returns the losses and, per step,
    every leaf's clipped gradient norm (float64 host numbers)."""
    names = list(w)
    for n in names:
        w[n].requires_grad_(True)
    state = {"m": {n: torch.zeros_like(w[n]) for n in names},
             "v": {n: torch.zeros_like(w[n]) for n in names}, "step": 0}
    out = {"loss": [], "leaf_grad": []}
    for tokens, labels in batches:
        for n in names:
            w[n].grad = None
        lv = loss(w, tokens, labels, a)
        lv.backward()
        grads = {n: (w[n].grad if w[n].grad is not None
                     else torch.zeros_like(w[n])) for n in names}
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / (gnorm + 1e-9), max=1.0)
        state["step"] += 1
        t = state["step"]
        lr = cosine_lr(o, t)
        bc1, bc2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
        leaf = {}
        with torch.no_grad():
            for n in names:
                g = grads[n] * scale
                leaf[n] = float(torch.linalg.vector_norm(g.double()))
                m, v = state["m"][n], state["v"][n]
                m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
                step = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"]) \
                    + o["weight_decay"] * w[n]
                w[n].sub_(lr * step)
                w[n].grad = None
        out["loss"].append(float(lv.detach()))
        out["leaf_grad"].append(leaf)
        del grads, lv
    for n in names:
        w[n].requires_grad_(False)
    return out
