"""Model assembly for the ``dense`` and ``ssm`` (RWKV6) families.

The port's counterpart of ``repro.models.transformer``.  :func:`build_model`
-> :class:`Model`, an ``nn.Module`` exposing

* ``init_weights(generator)``       -> fills every parameter (seeded)
* ``forward(batch)``                -> logits (prefill)
* ``init_cache(batch, max_len)``    -> decode cache
* ``decode_step(cache, tokens)``    -> (logits, cache)

Layers are an ``nn.ModuleList`` (the reference scans over stacked
parameters); :func:`repro_torch.models.convert.params_from_jax` unstacks a
reference pytree into this layout.  The ``moe``, ``hybrid``, ``vlm`` and
``audio`` families, and the training loss, are not ported yet: building
one of those families raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.layers import (MLP, Linear, empty_param, linear, mlp,
                                       rms_norm)

FAMILIES = ("dense", "ssm")


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = empty_param((d,), torch.float32, device)
        self.ln2 = empty_param((d,), torch.float32, device)
        self.attn = A.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                cfg.qkv_bias, dtype=dtype, device=device)
        self.mlp = MLP(d, cfg.d_ff, cfg.gated_mlp, dtype=dtype, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init_weights(gen)
        self.mlp.init_weights(gen)


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = empty_param((d,), torch.float32, device)
        self.ln2 = empty_param((d,), torch.float32, device)
        self.rwkv = S.RWKV(d, cfg.rwkv_head_size, cfg.d_ff, dtype=dtype,
                           device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.rwkv.init_weights(gen)


class Model(nn.Module):
    """One architecture's LM, parameters empty until :meth:`init_weights`
    or ``load_state_dict``.  ``device=None`` means the CUDA device."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
                f"port builds {FAMILIES}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        dev = self.device
        self.embed = empty_param((cfg.vocab, cfg.d_model), dtype, dev)
        self.final_norm = empty_param((cfg.d_model,), torch.float32, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else Linear(cfg.d_model, cfg.vocab, dtype=dtype,
                                    device=dev))
        layer = RWKVLayer if cfg.family == "ssm" else DecoderLayer
        self.layers = nn.ModuleList(layer(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Fill every parameter from `gen` (a generator on the model's
        device), in a fixed order."""
        self.embed.normal_(0.0, 0.02, generator=gen)
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            self.lm_head.init_weights(gen)
        for lyr in self.layers:
            lyr.init_weights(gen)

    # ==================================================================
    # forward (prefill)
    # ==================================================================
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch["tokens"]: (B, S) integer -> logits (B, S, vocab)."""
        cfg = self.cfg
        x = self.embed[batch["tokens"]]
        if cfg.family == "ssm":
            x = self._rwkv_stack(x)
        else:
            x = self._decoder_stack(x)
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.matmul(x, self.embed.t())
        return linear(self.lm_head, x)

    def _decoder_stack(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        for lp in self.layers:
            a = A.attention_block(
                lp.attn, rms_norm(lp.ln1, h, cfg.norm_eps),
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
            h = h + a
            h = h + mlp(lp.mlp, rms_norm(lp.ln2, h, cfg.norm_eps))
        return h

    def _rwkv_stack(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.layers)):
            h, _ = self.rwkv_layer(i, h)
        return h

    def rwkv_layer(self, i: int, h: torch.Tensor,
                   state: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, Dict]:
        """RWKV layer `i` on h (B, L, d) -> (h, {"tm", "cm"} state).  With
        no state (the forward) the time-mix scan is the ``rwkv6_scan``
        kernel; with one (decode) it is ``wkv6_scan``."""
        cfg = self.cfg
        lp = self.layers[i]
        t, tm = S.rwkv_time_mix(lp.rwkv, rms_norm(lp.ln1, h, cfg.norm_eps),
                                cfg.rwkv_head_size,
                                state=None if state is None else state["tm"])
        h = h + t
        c, cm = S.rwkv_channel_mix(lp.rwkv, rms_norm(lp.ln2, h, cfg.norm_eps),
                                   state=None if state is None else state["cm"])
        return h + c, {"tm": tm, "cm": cm}

    # ==================================================================
    # decode path
    # ==================================================================
    def init_cache(self, batch_size: int, max_len: int) -> Dict:
        """dense: {"k", "v": (L, B, max_len, kvH, hd), "len": 0};
        ssm: {"layers": [per-layer RWKV state], "len": 0}."""
        cfg = self.cfg
        dev = self.device
        if cfg.family == "ssm":
            return {"layers": [S.rwkv_init_state(batch_size, cfg.d_model,
                                                 cfg.rwkv_head_size,
                                                 self.dtype, dev)
                               for _ in range(cfg.n_layers)],
                    "len": 0}
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "len": 0}

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) integer -> logits (B, vocab), updated cache (the KV
        cache tensors are written in place)."""
        cfg = self.cfg
        x = self.embed[tokens][:, None, :]                # (B, 1, d)
        if cfg.family == "ssm":
            x, cache = self._rwkv_decode(cache, x)
        else:
            x, cache = self._decoder_decode(cache, x)
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        return self._logits(x)[:, 0], cache

    def _decoder_decode(self, cache: Dict, h: torch.Tensor):
        cfg = self.cfg
        for i, lp in enumerate(self.layers):
            a, _ = A.cached_attention_step(
                lp.attn, rms_norm(lp.ln1, h, cfg.norm_eps),
                {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]},
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
            h = h + a
            h = h + mlp(lp.mlp, rms_norm(lp.ln2, h, cfg.norm_eps))
        return h, dict(cache, len=cache["len"] + 1)

    def _rwkv_decode(self, cache: Dict, h: torch.Tensor):
        states: List[Dict] = []
        for i, st in enumerate(cache["layers"]):
            h, st = self.rwkv_layer(i, h, st)
            states.append(st)
        return h, {"layers": states, "len": cache["len"] + 1}


def build_model(cfg: ArchConfig, dtype=torch.float32,
                device: DeviceLike = None) -> Model:
    """An unfilled :class:`Model` on `device` (None: the CUDA device)."""
    return Model(cfg, dtype=dtype, device=device)
