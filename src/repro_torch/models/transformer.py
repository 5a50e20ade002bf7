"""Model assembly for every architecture family: ``dense``, ``moe``
(shared experts; Arctic's dense residual), ``vlm`` (precomputed input
embeddings), ``audio`` (Whisper's encoder-decoder), ``ssm`` (RWKV6, in the
repository's layout or Finch's published one: ``models.ssm``) and
``hybrid`` (Jamba).

The port's counterpart of ``repro.models.transformer``.  :func:`build_model`
-> :class:`Model`, an ``nn.Module`` exposing

* ``init_weights(generator)``       -> fills every parameter (seeded)
* ``forward(batch, collect_aux)``   -> logits (prefill) [, MoE aux loss]
* ``loss(batch)``                   -> scalar LM loss (+ MoE aux)
* ``encode(frames)``                -> the audio encoder's output
* ``init_cache(batch, max_len, enc_out)`` -> decode cache
* ``decode_step(cache, tokens)``    -> (logits, cache)

Layers are an ``nn.ModuleList`` (the reference scans over stacked
parameters); :func:`repro_torch.models.convert.params_from_jax` unstacks a
reference pytree into this layout.  With ``remat`` (the reference's
default) each layer body runs under ``torch.utils.checkpoint`` while grad
mode is on, as the reference's scan body runs under ``jax.checkpoint``:
its activations are recomputed in the backward instead of kept.  Under
``torch.no_grad`` (prefill, decode, serve) it runs as is.

Under a mesh the parameters and the batch are DTensors
(``launch.train``) and the same code runs on them: plain tensors made
inside (positions, zero states) count as replicated, the kernels run on
each rank's local shards (``models.dtensor``), and ``hidden_pspec`` /
``hidden_divisors`` (set by the launcher, as the reference's are)
redistribute the residual stream between blocks (:meth:`Model._constrain`,
Megatron sequence parallelism).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import moe_shard as MS
from repro_torch.models import ssm as S
from repro_torch.models.dtensor import (gather_rows, gather_seq, is_dtensor,
                                        local_nll, module_view,
                                        plain_as_replicated, replicated_call,
                                        to_placements, vocab_parallel_nll,
                                        vocab_split_dims)
from repro_torch.models.layers import (MLP, Linear, empty_param, layer_norm,
                                       linear, mlp, rms_norm)

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def _attention(cfg: ArchConfig, dtype, device) -> A.Attention:
    return A.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.qkv_bias, dtype=dtype, device=device)


class DecoderLayer(nn.Module):
    """``_init_decoder_layer``: ``ln1``/``attn``, with ``ln_x``/``xattn``
    (cross-attention) in the audio family, ``ln2`` and the FFN: ``moe``
    when the config has experts (plus Arctic's ``mlp`` beside it with
    ``dense_residual``), else ``mlp``."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = empty_param((d,), torch.float32, device)
        self.ln2 = empty_param((d,), torch.float32, device)
        self.attn = _attention(cfg, dtype, device)
        self.ln_x = self.xattn = None
        if cfg.family == "audio":
            self.ln_x = empty_param((d,), torch.float32, device)
            self.xattn = _attention(cfg, dtype, device)
        self.moe = self.mlp = None
        if cfg.n_experts:
            self.moe = M.MoE(d, cfg.expert_ff, cfg.n_experts,
                             n_shared=cfg.n_shared_experts,
                             shared_ff=cfg.d_ff, expert_pad=cfg.expert_pad,
                             dtype=dtype, device=device)
        if not cfg.n_experts or cfg.dense_residual:
            self.mlp = MLP(d, cfg.d_ff, cfg.gated_mlp, dtype=dtype,
                           device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        for ln in (self.ln1, self.ln2, self.ln_x):
            if ln is not None:
                ln.fill_(1.0)
        for sub in (self.attn, self.xattn, self.moe, self.mlp):
            if sub is not None:
                sub.init_weights(gen)


class EncoderLayer(nn.Module):
    """``_init_encoder_layer``: ``ln1``/``attn`` (non-causal, no RoPE) and
    ``ln2``/``mlp`` (plain GELU)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = empty_param((d,), torch.float32, device)
        self.ln2 = empty_param((d,), torch.float32, device)
        self.attn = _attention(cfg, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, gated=False, dtype=dtype, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init_weights(gen)
        self.mlp.init_weights(gen)


class RWKVLayer(nn.Module):
    """``ln1`` / the time mix and ``ln2`` / the channel mix; in Finch's
    layout (``cfg.rwkv_finch``) the norms are LayerNorms with the biases
    ``ln1_b`` and ``ln2_b``."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = empty_param((d,), torch.float32, device)
        self.ln2 = empty_param((d,), torch.float32, device)
        self.ln1_b = self.ln2_b = None
        if cfg.rwkv_finch:
            self.ln1_b = empty_param((d,), torch.float32, device)
            self.ln2_b = empty_param((d,), torch.float32, device)
        self.rwkv = S.RWKV(d, cfg.rwkv_head_size, cfg.d_ff,
                           mix_lora=cfg.rwkv_mix_lora,
                           decay_lora=cfg.rwkv_decay_lora, dtype=dtype,
                           device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        for b in (self.ln1_b, self.ln2_b):
            if b is not None:
                b.zero_()
        self.rwkv.init_weights(gen)


class JambaBlock(nn.Module):
    """One Jamba period of ``attn_every`` sub-layers (``_init_jamba_block``):
    sub-layer 0 is attention, the rest are Mamba; the FFN after sub-layer
    i is MoE for even i and a gated MLP for odd i.  ``mamba_ln`` (per-1, d)
    and ``ffn_ln`` (per, d) stay stacked, as the reference keeps them."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, per = cfg.d_model, cfg.attn_every
        self.attn = _attention(cfg, dtype, device)
        self.attn_ln = empty_param((d,), torch.float32, device)
        self.mamba = nn.ModuleList(
            S.Mamba(d, cfg.d_state, cfg.d_conv, dtype=dtype, device=device)
            for _ in range(per - 1))
        self.mamba_ln = empty_param((per - 1, d), torch.float32, device)
        self.moe = nn.ModuleList(
            M.MoE(d, cfg.expert_ff, cfg.n_experts, expert_pad=cfg.expert_pad,
                  dtype=dtype, device=device)
            for _ in range(per // 2))
        self.mlp = nn.ModuleList(
            MLP(d, cfg.d_ff, gated=True, dtype=dtype, device=device)
            for _ in range(per - per // 2))
        self.ffn_ln = empty_param((per, d), torch.float32, device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.attn.init_weights(gen)
        for ln in (self.attn_ln, self.mamba_ln, self.ffn_ln):
            ln.fill_(1.0)
        for sub in (*self.mamba, *self.moe, *self.mlp):
            sub.init_weights(gen)


class Model(nn.Module):
    """One architecture's LM, parameters empty until :meth:`init_weights`
    or ``load_state_dict``.  ``device=None`` means the CUDA device.
    ``moe_capacity`` is the MoE token-dropping capacity factor; set it to
    ``n_experts`` to disable drops.  ``remat`` recomputes each layer's
    activations in the backward (see the module docstring).
    ``hidden_pspec`` (a PartitionSpec for the residual stream) and
    ``hidden_divisors`` ((dp_size, model_size)) are the launcher's.

    The MoE fields are the reference's: ``moe_groups`` (the dense
    dispatch's group count, the launcher's DP degree) and
    ``moe_buf_pspec`` (its buffer's PartitionSpec); ``moe_impl``
    ``"dense"`` (:func:`moe.moe_block`, run whole on every rank under a
    mesh) or ``"shard_map"`` (:func:`moe_shard.moe_block_sharded`, expert
    parallel on ``moe_mesh`` with ``moe_dp_axes`` as the data axes; train
    and prefill only, decode always takes the dense block)."""

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16,
                 device: DeviceLike = None, moe_capacity: float = 1.25,
                 remat: bool = True, moe_groups: int = 1,
                 moe_buf_pspec=None, moe_impl: str = "dense",
                 moe_mesh=None, moe_dp_axes: Tuple[str, ...] = ("data",)):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); "
                             f"the families are {FAMILIES}")
        self.cfg = cfg
        self.dtype = dtype
        self.moe_capacity = moe_capacity
        self.remat = remat
        if moe_impl not in ("dense", "shard_map"):
            raise ValueError(f"moe_impl {moe_impl!r}: 'dense' or 'shard_map'")
        self.moe_groups = moe_groups
        self.moe_buf_pspec = moe_buf_pspec
        self.moe_impl = moe_impl
        self.moe_mesh = moe_mesh
        self.moe_dp_axes = tuple(moe_dp_axes)
        self.hidden_pspec = None
        self.hidden_divisors = None
        self.device = resolve_device(device)
        dev = self.device
        self.embed = empty_param((cfg.vocab, cfg.d_model), dtype, dev)
        self.final_norm = empty_param((cfg.d_model,), torch.float32, dev)
        # Finch's LayerNorm biases, and its ln0 on the embedding
        self.final_norm_b = self.ln0 = self.ln0_b = None
        if cfg.family == "ssm" and cfg.rwkv_finch:
            self.final_norm_b = empty_param((cfg.d_model,), torch.float32,
                                            dev)
            self.ln0 = empty_param((cfg.d_model,), torch.float32, dev)
            self.ln0_b = empty_param((cfg.d_model,), torch.float32, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else Linear(cfg.d_model, cfg.vocab, dtype=dtype,
                                    device=dev))
        if cfg.family == "hybrid":
            layer, n = JambaBlock, cfg.n_layers // cfg.attn_every
        else:
            layer = RWKVLayer if cfg.family == "ssm" else DecoderLayer
            n = cfg.n_layers
        self.layers = nn.ModuleList(layer(cfg, dtype, dev) for _ in range(n))
        self.enc_layers = self.enc_norm = None
        if cfg.family == "audio":
            self.enc_layers = nn.ModuleList(
                EncoderLayer(cfg, dtype, dev) for _ in range(cfg.enc_layers))
            self.enc_norm = empty_param((cfg.d_model,), torch.float32, dev)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Fill every parameter from `gen` (a generator on the model's
        device), in a fixed order."""
        self.embed.normal_(0.0, 0.02, generator=gen)
        self.final_norm.fill_(1.0)
        if self.ln0 is not None:
            self.ln0.fill_(1.0)
            self.final_norm_b.zero_()
            self.ln0_b.zero_()
        if self.lm_head is not None:
            self.lm_head.init_weights(gen)
        for lyr in self.layers:
            lyr.init_weights(gen)
        if self.enc_layers is not None:
            for lyr in self.enc_layers:
                lyr.init_weights(gen)
            self.enc_norm.fill_(1.0)

    # ==================================================================
    # forward (prefill)
    # ==================================================================
    def forward(self, batch: Dict[str, torch.Tensor],
                collect_aux: bool = False):
        """batch["tokens"]: (B, S) integer, or batch["embeds"]: (B, S, d)
        precomputed input embeddings in its place (the vlm stub input);
        the audio family also reads batch["frames"]: (B, enc_ctx, d).
        -> logits (B, S, vocab), and the summed MoE aux loss (fp32 scalar)
        with `collect_aux`."""
        with plain_as_replicated(self.embed):
            return self._forward(batch, collect_aux)

    def _forward(self, batch: Dict[str, torch.Tensor], collect_aux: bool):
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            x = self._embed(batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "ssm":
            x = self._rwkv_stack(self._ln0(x))
        elif cfg.family == "hybrid":
            x, aux = self._jamba_stack(x)
        else:
            enc = (self.encode(batch["frames"]) if cfg.family == "audio"
                   else None)
            x, aux = self._decoder_stack(x, enc)
        x = self._norm(self.final_norm, self.final_norm_b, x)
        # the sequence gathered before the column-parallel head, as before
        # every block's (a product on the sequence-split stream would fold
        # the model split into its rows)
        logits = self._logits(gather_seq(x))
        if collect_aux:
            return logits, aux
        return logits

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL (fp32 log-softmax) over the positions with
        ``batch["labels"] >= 0``, plus 0.01 x the MoE aux loss.  Its
        gradients reach the parameters once ``requires_grad_()`` has
        turned them on (they are built without).  Logits whose vocab a
        mesh dim splits go through :func:`vocab_parallel_nll` (each rank
        on its own vocab shard), other logits on a mesh of more than one
        rank through :func:`local_nll` (each rank on its own rows and
        block of the sequence); DTensor's log-softmax and gather would
        all-gather them and build the global (B, S, V) gradient on every
        rank."""
        logits, aux = self.forward(batch, collect_aux=True)
        labels = batch["labels"]
        with plain_as_replicated(self.embed):
            if vocab_split_dims(logits):
                nll_tok = vocab_parallel_nll(logits, labels.clamp(min=0))
            elif is_dtensor(logits) and logits.device_mesh.size() > 1:
                nll_tok = local_nll(logits, labels.clamp(min=0))
            else:
                logp = torch.log_softmax(logits.float(), dim=-1)
                nll_tok = -torch.gather(
                    logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
            mask = (labels >= 0).float()
            nll = (nll_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            return nll + 0.01 * aux

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if is_dtensor(self.embed):
            return gather_rows(self.embed, tokens)
        return self.embed[tokens]

    def _constrain(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream redistributed to ``hidden_pspec``'s
        placements where the reference constrains it: a 3-dim DTensor
        whose batch divides the data axes and whose sequence divides the
        model axis (and is at least it, which is above 1)."""
        if self.hidden_pspec is None or x.dim() != 3 or not is_dtensor(x):
            return x
        dp, mp = self.hidden_divisors or (1, 1)
        if x.shape[0] % max(dp, 1) == 0 and x.shape[1] % max(mp, 1) == 0 \
                and x.shape[1] >= mp > 1:
            mesh = x.device_mesh
            return x.redistribute(mesh, to_placements(mesh, self.hidden_pspec,
                                                      x.dim()))
        return x

    def _norm(self, w: torch.Tensor, b: Optional[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """RMSNorm of x with gain w, or, given a bias b (Finch's layout),
        LayerNorm."""
        if b is None:
            return rms_norm(w, x, self.cfg.norm_eps)
        return layer_norm(w, b, x, self.cfg.norm_eps)

    def _ln0(self, x: torch.Tensor) -> torch.Tensor:
        """Finch's LayerNorm of the embedding before layer 0 (none in
        other layouts)."""
        return x if self.ln0 is None else self._norm(self.ln0, self.ln0_b, x)

    def _add(self, h: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """The residual add h + f, f (a block's row-parallel output: a
        partial sum over ``model`` on a mesh) first placed as
        :meth:`_constrain` places the stream, by a reduce-scatter.  DTensor
        would otherwise carry the partial sum on through the next norm,
        and the column-parallel product after it would gather its weight
        whole."""
        return h + self._constrain(f)

    def _layer(self, body, *args):
        """body(*args), under activation checkpointing when ``remat`` and
        grad mode are on (the model draws no random numbers, so no RNG
        state is kept for the recompute)."""
        if self.remat and torch.is_grad_enabled():
            # the recompute runs in the backward, outside forward()'s block
            def run(*a):
                with plain_as_replicated(self.embed):
                    return body(*a)
            return checkpoint(run, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return body(*args)

    def _moe(self, p: M.MoE, hin: torch.Tensor, decode: bool = False):
        """The MoE block: the expert-parallel one with ``moe_impl=
        "shard_map"`` and a ``moe_mesh`` (not at `decode`), else the dense
        one.  On a DTensor at `decode` that is
        :func:`moe_shard.moe_block_grouped` (each rank its data shard's
        groups and its model rank's experts, as ``moe_buf_pspec`` lays
        the buffer out; no aux loss, which decode drops) where its layout
        holds; otherwise the dense block runs whole on every rank, on
        replicated inputs and weights."""
        cfg = self.cfg
        kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
                  capacity_factor=self.moe_capacity)
        if self.moe_impl == "shard_map" and self.moe_mesh is not None \
                and not decode:
            return MS.moe_block_sharded(p, hin, mesh=self.moe_mesh,
                                        dp_axes=self.moe_dp_axes, **kw)
        kw.update(n_groups=self.moe_groups, buf_pspec=self.moe_buf_pspec)
        if not is_dtensor(hin):
            return M.moe_block(p, hin, **kw)
        if decode:
            out = MS.moe_block_grouped(p, hin, **kw)
            if out is not None:
                return out, None
        names = [n for n, _ in p.named_parameters()]

        def local(x, *ts):
            return M.moe_block(module_view(p, dict(zip(names, ts))), x, **kw)
        return replicated_call(local, hin.device_mesh,
                               (hin, *(t for _, t in p.named_parameters())),
                               2)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.matmul(x, self.embed.t())
        return linear(self.lm_head, x)

    def _rope_theta(self) -> Optional[float]:
        return None if self.cfg.family == "audio" else self.cfg.rope_theta

    def _cross(self, lp: DecoderLayer, h: torch.Tensor,
               enc: Optional[torch.Tensor]) -> torch.Tensor:
        """h plus cross-attention to `enc` (none without an encoder
        output, as in the reference)."""
        if enc is None:
            return h
        cfg = self.cfg
        return self._add(h, A.attention_block(
            lp.xattn, rms_norm(lp.ln_x, h, cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=None, kv=enc))

    def _ffn(self, lp: DecoderLayer, h: torch.Tensor, decode: bool = False):
        """(FFN output, MoE aux loss) of the decoder layer on h."""
        cfg = self.cfg
        hin = rms_norm(lp.ln2, h, cfg.norm_eps)
        if lp.moe is None:
            return mlp(lp.mlp, hin), None
        f, aux = self._moe(lp.moe, hin, decode)
        if lp.mlp is not None:                     # Arctic's dense residual
            f = f + mlp(lp.mlp, hin)
        return f, aux

    def _decoder_stack(self, h: torch.Tensor,
                       enc: Optional[torch.Tensor] = None):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for lp in self.layers:
            h, al = self._layer(self._decoder_layer, lp, h, enc)
            if al is not None:
                aux = aux + al
        return h, aux

    def _decoder_layer(self, lp: DecoderLayer, h: torch.Tensor,
                       enc: Optional[torch.Tensor]):
        """One decoder layer on h -> (h, MoE aux loss or None)."""
        cfg = self.cfg
        a = A.attention_block(
            lp.attn, rms_norm(lp.ln1, h, cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=self._rope_theta())
        h = self._cross(lp, self._add(h, a), enc)
        f, al = self._ffn(lp, h)
        return self._constrain(self._add(h, f)), al

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The audio encoder (``_encoder_stack``): frames (B, enc_ctx, d),
        cast to the model's dtype -> (B, enc_ctx, d), the input of every
        decoder layer's cross-attention."""
        h = frames.to(self.dtype)
        for lp in self.enc_layers:
            h = self._layer(self._encoder_layer, lp, h)
        return rms_norm(self.enc_norm, h, self.cfg.norm_eps)

    def _encoder_layer(self, lp: EncoderLayer, h: torch.Tensor):
        cfg = self.cfg
        a = A.attention_block(
            lp.attn, rms_norm(lp.ln1, h, cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=None, causal=False)
        h = self._add(h, a)
        return self._constrain(
            self._add(h, mlp(lp.mlp, rms_norm(lp.ln2, h, cfg.norm_eps))))

    def _rwkv_stack(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.layers)):
            h = self._layer(
                lambda j, x: self._constrain(self.rwkv_layer(j, x)[0]), i, h)
        return h

    def _jamba_stack(self, h: torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for bp in self.layers:
            h, al = self._layer(self._jamba_block, bp, h)
            aux = aux + al
        return h, aux

    def _jamba_block(self, bp: JambaBlock, h: torch.Tensor):
        """One Jamba period on h -> (h, its MoE aux loss)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        mi = di = 0
        for i in range(cfg.attn_every):
            if i == 0:
                a = A.attention_block(
                    bp.attn, rms_norm(bp.attn_ln, h, cfg.norm_eps),
                    n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
                h = self._add(h, a)
            else:
                m, _ = S.mamba_block(
                    bp.mamba[i - 1],
                    rms_norm(bp.mamba_ln[i - 1], h, cfg.norm_eps))
                h = self._add(h, m)
            hin = rms_norm(bp.ffn_ln[i], h, cfg.norm_eps)
            if i % 2 == 0:
                f, al = self._moe(bp.moe[mi], hin)
                aux = aux + al
                mi += 1
            else:
                f = mlp(bp.mlp[di], hin)
                di += 1
            h = self._add(h, f)
        return self._constrain(h), aux

    def rwkv_layer(self, i: int, h: torch.Tensor,
                   state: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, Dict]:
        """RWKV layer `i` on h (B, L, d) -> (h, {"tm", "cm"} state).  With
        no state (the forward) the time-mix scan is the ``rwkv6_scan``
        kernel; with one (decode) it is ``wkv6_scan``."""
        cfg = self.cfg
        lp = self.layers[i]
        t, tm = S.rwkv_time_mix(lp.rwkv, self._norm(lp.ln1, lp.ln1_b, h),
                                cfg.rwkv_head_size,
                                state=None if state is None else state["tm"])
        h = h + t
        c, cm = S.rwkv_channel_mix(lp.rwkv, self._norm(lp.ln2, lp.ln2_b, h),
                                   state=None if state is None else state["cm"])
        return h + c, {"tm": tm, "cm": cm}

    # ==================================================================
    # decode path
    # ==================================================================
    def init_cache(self, batch_size: int, max_len: int,
                   enc_out: Optional[torch.Tensor] = None) -> Dict:
        """dense, moe, vlm: {"k", "v": (L, B, max_len, kvH, hd), "len": 0};
        audio: the same and {"enc": `enc_out`} (without it decode skips
        cross-attention, as the reference's does);
        ssm: {"layers": [per-layer RWKV state], "len": 0};
        hybrid: {"k", "v": (blocks, B, max_len, kvH, hd), "mamba":
        [per-block [per-Mamba-sub-layer state]], "len": 0}."""
        cfg = self.cfg
        dev = self.device
        if cfg.family == "ssm":
            return {"layers": [S.rwkv_init_state(batch_size, cfg.d_model,
                                                 cfg.rwkv_head_size,
                                                 self.dtype, dev)
                               for _ in range(cfg.n_layers)],
                    "len": 0}
        shape = (len(self.layers), batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                 "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                 "len": 0}
        if cfg.family == "hybrid":
            cache["mamba"] = [[S.mamba_init_state(batch_size, cfg.d_model,
                                                  cfg.d_state, cfg.d_conv,
                                                  self.dtype, dev)
                               for _ in range(cfg.attn_every - 1)]
                              for _ in self.layers]
        if cfg.family == "audio":
            cache["enc"] = enc_out
        return cache

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) integer -> logits (B, vocab), updated cache (the KV
        cache tensors are written in place)."""
        with plain_as_replicated(self.embed):
            return self._decode_step(cache, tokens)

    def _decode_step(self, cache: Dict, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        x = self._embed(tokens)[:, None, :]               # (B, 1, d)
        if cfg.family == "ssm":
            x, cache = self._rwkv_decode(cache, self._ln0(x))
        elif cfg.family == "hybrid":
            x, cache = self._jamba_decode(cache, x)
        else:
            x, cache = self._decoder_decode(cache, x)
        x = self._norm(self.final_norm, self.final_norm_b, x)
        return self._logits(x)[:, 0], cache

    def _decoder_decode(self, cache: Dict, h: torch.Tensor):
        """The encoder output's K/V are projected again at every step, as
        the reference does (no cross-attention KV cache)."""
        cfg = self.cfg
        enc = cache.get("enc")
        for i, lp in enumerate(self.layers):
            a, _ = A.cached_attention_step(
                lp.attn, rms_norm(lp.ln1, h, cfg.norm_eps),
                {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]},
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=self._rope_theta())
            h = self._cross(lp, h + a, enc)
            h = h + self._ffn(lp, h, decode=True)[0]
        return h, dict(cache, len=cache["len"] + 1)

    def _rwkv_decode(self, cache: Dict, h: torch.Tensor):
        states: List[Dict] = []
        for i, st in enumerate(cache["layers"]):
            h, st = self.rwkv_layer(i, h, st)
            states.append(st)
        return h, {"layers": states, "len": cache["len"] + 1}

    def _jamba_decode(self, cache: Dict, h: torch.Tensor):
        cfg = self.cfg
        per = cfg.attn_every
        new_m: List[List[Dict]] = []
        for bi, bp in enumerate(self.layers):
            states = []
            for i in range(per):
                if i == 0:
                    a, _ = A.cached_attention_step(
                        bp.attn, rms_norm(bp.attn_ln, h, cfg.norm_eps),
                        {"k": cache["k"][bi], "v": cache["v"][bi],
                         "len": cache["len"]},
                        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
                    h = h + a
                else:
                    m, st = S.mamba_block(
                        bp.mamba[i - 1],
                        rms_norm(bp.mamba_ln[i - 1], h, cfg.norm_eps),
                        state=cache["mamba"][bi][i - 1])
                    states.append(st)
                    h = h + m
                hin = rms_norm(bp.ffn_ln[i], h, cfg.norm_eps)
                if i % 2 == 0:
                    f, _ = self._moe(bp.moe[i // 2], hin, decode=True)
                else:
                    f = mlp(bp.mlp[i // 2], hin)
                h = h + f
            new_m.append(states)
        return h, dict(cache, mamba=new_m, len=cache["len"] + 1)


def build_model(cfg: ArchConfig, dtype=torch.bfloat16,
                device: DeviceLike = None, moe_capacity: float = 1.25,
                remat: bool = True) -> Model:
    """An unfilled :class:`Model` on `device` (None: the CUDA device)."""
    return Model(cfg, dtype=dtype, device=device, moe_capacity=moe_capacity,
                 remat=remat)
