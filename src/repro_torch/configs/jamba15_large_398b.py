"""Jamba-1.5-Large-398B — hybrid Mamba+attention (1:7 interleave) with
16-expert top-2 MoE every other layer. [arXiv:2403.19887]

Sub-quadratic: runs the long_500k shape (Mamba layers O(1) state; the 1-in-8
attention layers keep a seq-sharded KV cache).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    gated_mlp=True,
    n_experts=16,
    top_k=2,
    expert_ff=24576,
    attn_every=8,               # 1 attention layer per 8 (1:7 Mamba:attn)
    d_state=16,
    d_conv=4,
    skip_shapes=(),             # all four shapes run
)
