"""Architecture config schema + shape suite (the assigned 10x4 grid)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    qkv_bias: bool = False
    gated_mlp: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_ff: int = 0
    dense_residual: bool = False   # Arctic: dense FFN residual alongside MoE
    # zero-traffic padding experts so the expert dim divides the TP axis
    # (perf iteration, EXPERIMENTS.md §Perf: EP beats intra-expert TP for
    # the dispatch collectives; the router never selects a padding expert)
    expert_pad: int = 0

    # hybrid (Jamba): one attention layer per `attn_every`; MoE every 2nd layer
    attn_every: int = 0
    d_state: int = 16
    d_conv: int = 4

    # encoder-decoder (Whisper): encoder depth + fixed encoder context
    enc_layers: int = 0
    enc_ctx: int = 0

    # modality frontend (STUB per assignment): input is precomputed embeddings
    frontend: str = "none"      # none | patch | conv

    # RWKV6
    rwkv_head_size: int = 64

    # which shapes this arch supports (see DESIGN.md §Shape-applicability)
    skip_shapes: Tuple[str, ...] = ()

    # Port-only fields (the reference's ArchConfig has none of them).
    # RWKV6 "Finch"'s published layer (arXiv:2404.05892, models/ssm.py):
    # the rank of the LoRA behind its five data-dependent token-shift
    # mixes and of its decay LoRA.  Both 0 (every entry of ARCHS) is the
    # repository's RWKV layer; both set is Finch's, LayerNorms with a bias
    # and ``ln0`` included.
    rwkv_mix_lora: int = 0
    rwkv_decay_lora: int = 0

    def __post_init__(self):
        if bool(self.rwkv_mix_lora) != bool(self.rwkv_decay_lora):
            raise ValueError(
                f"{self.name}: rwkv_mix_lora and rwkv_decay_lora select "
                f"Finch's layer together (got {self.rwkv_mix_lora}, "
                f"{self.rwkv_decay_lora})")

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def rwkv_finch(self) -> bool:
        """Whether an ssm-family model has Finch's published layer."""
        return self.rwkv_mix_lora > 0

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.attn_every else self.attn_every),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_ff=64 if self.expert_ff else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_ctx=min(self.enc_ctx, 16) if self.enc_ctx else 0,
            d_state=min(self.d_state, 8),
            rwkv_head_size=16,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# full-attention archs skip long_500k (quadratic-history decode; see DESIGN.md)
FULL_ATTENTION_SKIP = ("long_500k",)
