"""Plain PyTorch reference of the decoder-only LMs the benchmark runs.

The model is the one the repository defines (its JAX package and the port
compute the same function): pre-norm decoder layers of RMSNorm, GQA
attention with a QKV bias and rotate-half RoPE, then either a gated SiLU
MLP or the top-k MoE block, a final RMSNorm and an untied head.  Where that
departs from the published Qwen models, the configuration file says so.

This file imports torch alone: no kernel, no cache, no batching of
requests, nothing of the program.  Attention materialises its scores, the
MoE block loops over the experts, and every product runs in fp32 with TF32
off, unless ``precision="tf32"`` asks for the lower precision (the
comparison's control: on a CUDA tensor the tensor cores' TF32, on a CPU
tensor each product's inputs rounded to TF32's 10 mantissa bits).

Weights are a dict of tensors keyed as :func:`param_spec` lists them; the
benchmark makes them from the seed (each leaf scaled by :func:`init_leaf`)
and hands the same dict to the program.  A configuration names this module
by ``"reference": "lm"``; :data:`PUBLISHED` and :data:`PUBLISHED_WHEN`
say which of its published keys set which field of its ``model``.
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
PUBLISHED = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab",
             "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
             "num_hidden_layers": "n_layers", "intermediate_size": "d_ff"}
# compared too where the model sets ``n_experts``: the routed experts and
# the shared expert, one gated MLP of width ``d_ff``
PUBLISHED_WHEN = {"n_experts": {
    "num_experts": "n_experts", "num_experts_per_tok": "top_k",
    "moe_intermediate_size": "expert_ff",
    "shared_expert_intermediate_size": "d_ff"}}


def param_spec(a: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight of the model `a` (a configuration's
    ``model`` dict), in a fixed order.  Linear weights are stored (d_in,
    d_out) and applied as ``x @ w``; the experts are stacked, with
    ``expert_pad`` extra experts that the router never selects."""
    d, hd = a["d_model"], a["head_dim"]
    h, kvh = a["n_heads"], a["n_kv_heads"]
    spec: List[Tuple[str, Tuple[int, ...]]] = [("embed", (a["vocab"], d))]
    for i in range(a["n_layers"]):
        p = f"layers.{i}."
        spec += [(p + "ln1", (d,)), (p + "ln2", (d,))]
        for nm, width in (("q", h * hd), ("k", kvh * hd), ("v", kvh * hd)):
            spec.append((p + f"attn.{nm}.w", (d, width)))
            if a.get("qkv_bias"):
                spec.append((p + f"attn.{nm}.b", (width,)))
        spec.append((p + "attn.o.w", (h * hd, d)))
        if a.get("n_experts"):
            e = a["n_experts"] + a.get("expert_pad", 0)
            f = a["expert_ff"]
            spec += [(p + "moe.router", (d, a["n_experts"])),
                     (p + "moe.w_gate", (e, d, f)), (p + "moe.w_up", (e, d, f)),
                     (p + "moe.w_down", (e, f, d))]
            if a.get("n_shared_experts"):
                spec += _mlp_spec(p + "moe.shared.", d, a["d_ff"])
        else:
            spec += _mlp_spec(p + "mlp.", d, a["d_ff"])
    spec += [("final_norm", (d,)), ("lm_head.w", (d, a["vocab"]))]
    return spec


def _mlp_spec(p: str, d: int, f: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(p + "w_up", (d, f)), (p + "w_down", (f, d)),
            (p + "w_gate", (d, f))]


def init_leaf(name: str, t: torch.Tensor) -> None:
    """Scale a unit normal leaf in place to its role: norm gains 1 +/- 0.1,
    biases 0.1, the embedding 1, a matrix 1 / sqrt(fan in), so that every
    layer's output and the logits stay of order one."""
    if name.endswith(("ln1", "ln2", "final_norm")):
        t.mul_(0.1).add_(1.0)
    elif name.endswith(".b"):
        t.mul_(0.1)
    elif name != "embed":
        t.mul_(1.0 / math.sqrt(t.shape[-2]))


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
def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x (B, S, H, hd) at positions 0..S-1, the angles
    in fp32 as the published model computes them."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(s, device=x.device).float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(w: Weights, p: str, x: torch.Tensor, a: dict) -> torch.Tensor:
    """Causal GQA self-attention of x (B, S, d), scores materialised."""
    b, s, _ = x.shape
    h, kvh, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]

    def proj(nm, heads):
        y = mm(x, w[p + f"attn.{nm}.w"])
        if (p + f"attn.{nm}.b") in w:
            y = y + w[p + f"attn.{nm}.b"]
        return y.reshape(b, s, heads, hd)
    q = rope(proj("q", h), a["rope_theta"])
    k = rope(proj("k", kvh), a["rope_theta"])
    v = proj("v", kvh)
    rep = h // kvh
    q = q.permute(0, 2, 1, 3)                                   # (B, H, S, hd)
    k = k.permute(0, 2, 3, 1).repeat_interleave(rep, dim=1)     # (B, H, hd, S)
    v = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)     # (B, H, S, hd)
    scores = mm(q, k) * (1.0 / math.sqrt(hd))
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(probs, v).permute(0, 2, 1, 3).reshape(b, s, h * hd)
    return mm(o, w[p + "attn.o.w"])


def gated_mlp(w: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(x, w[p + "w_gate"])) * mm(x, w[p + "w_up"]),
              w[p + "w_down"])


def moe(w: Weights, p: str, x: torch.Tensor, a: dict, routes: dict
        ) -> torch.Tensor:
    """Top-k MoE of x (B, S, d): softmax router, the k largest
    probabilities renormalised to sum 1, capacity ceil(T k / E x factor)
    per expert (the factor ``routes["capacity"]``) with the earlier
    (token, k) assignment winning a slot and the overflow dropped, plus
    the always-on shared gated MLP.

    `routes` is one layer's view of :func:`logits`'s.  It appends to
    ``routes["own"]`` the experts it would choose, (B, S, k), and to
    ``routes["margins"]`` each token's gap between its k-th and (k+1)-th
    router probability over the k-th, (B, S): where that is within
    rounding two implementations may route a token apart.  Where
    ``routes["follow"]`` is given, (B, S, k), the tokens go to those
    experts instead, with their own probabilities renormalised."""
    b, s, d = x.shape
    t, e, k = b * s, a["n_experts"], a["top_k"]
    xt = x.reshape(t, d)
    probs = torch.softmax(mm(xt, w[p + "moe.router"]), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                    # (T, k)
    top = torch.topk(probs, k + 1, dim=-1).values
    routes["margins"].append(((top[:, k - 1] - top[:, k])
                              / top[:, k - 1]).reshape(b, s))
    routes["own"].append(idx.reshape(b, s, k))
    if routes["follow"] is not None:
        idx = routes["follow"].reshape(t, k).to(x.device)
        gate = probs.gather(1, idx)
    gate = gate / gate.sum(-1, keepdim=True)
    cap = max(math.ceil(t * k / e * routes["capacity"]), 1)
    flat = idx.reshape(-1)                                      # (T k,)
    slot = torch.cumsum(F.one_hot(flat, e), dim=0).gather(
        1, flat[:, None])[:, 0] - 1
    keep = slot < cap
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    out = torch.zeros_like(xt)
    for ex in range(e):
        sel = torch.nonzero((flat == ex) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        rows = xt[tok[sel]]
        y = mm(F.silu(mm(rows, w[p + "moe.w_gate"][ex]))
               * mm(rows, w[p + "moe.w_up"][ex]), w[p + "moe.w_down"][ex])
        out.index_add_(0, tok[sel], y * gate.reshape(-1)[sel][:, None])
    if (p + "moe.shared.w_up") in w:
        out = out + gated_mlp(w, p + "moe.shared.", xt)
    return out.reshape(b, s, d)


def layer(w: Weights, i: int, h: torch.Tensor, a: dict,
          routes: Optional[dict] = None) -> torch.Tensor:
    p = f"layers.{i}."
    eps = a["norm_eps"]
    h = h + attention(w, p, rms_norm(w[p + "ln1"], h, eps), a)
    x = rms_norm(w[p + "ln2"], h, eps)
    if a.get("n_experts"):
        if routes is None:
            raise ValueError("a model with experts takes `routes` (its "
                             "capacity factor and the lists to fill)")
        return h + moe(w, p, x, a, routes)
    return h + gated_mlp(w, p + "mlp.", x)


def _layer_routes(routes: Optional[dict], i: int) -> Optional[dict]:
    """Layer i's view of `routes`: its capacity, its lists, and its
    experts to follow."""
    if routes is None:
        return None
    follow = routes["follow"]
    return {"capacity": routes["capacity"], "own": routes["own"],
            "margins": routes["margins"],
            "follow": None if follow is None else follow[i]}


def hidden(w: Weights, tokens: torch.Tensor, a: dict, remat: bool = False,
           routes: Optional[dict] = None) -> torch.Tensor:
    """The final norm's output (B, S, d) for tokens (B, S).  With `remat`
    each layer is recomputed in the backward (so a gradient fits)."""
    h = w["embed"][tokens]
    for i in range(a["n_layers"]):
        if remat:
            h = checkpoint(layer, w, i, h, a, use_reentrant=False)
        else:
            h = layer(w, i, h, a, _layer_routes(routes, i))
    return rms_norm(w["final_norm"], h, a["norm_eps"])


@torch.no_grad()
def logits(w: Weights, tokens: torch.Tensor, a: dict,
           routes: Optional[dict] = None) -> torch.Tensor:
    """Logits (B, S, vocab) of a prefill of tokens (B, S).  `routes`, for
    a model with experts: ``{"capacity": the capacity factor, "own": [],
    "margins": [], "follow": None or one (B, S, k) tensor of experts a
    layer}``; :func:`moe` fills the two lists, one entry a layer."""
    return mm(hidden(w, tokens, a, routes=routes), w["lm_head.w"])


def loss(w: Weights, tokens: torch.Tensor, labels: torch.Tensor, a: dict
         ) -> torch.Tensor:
    """Mean next-token NLL (fp32 log-softmax) over the positions whose
    label is >= 0, layers recomputed in the backward (a dense model: no
    MoE auxiliary loss)."""
    if a.get("n_experts"):
        raise NotImplementedError("the reference's loss covers dense models")
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
