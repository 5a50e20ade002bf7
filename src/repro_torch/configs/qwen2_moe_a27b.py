"""Qwen2-MoE-A2.7B (Qwen1.5-MoE) — 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ArchConfig, FULL_ATTENTION_SKIP

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,                  # shared-expert intermediate (4 x 1408)
    vocab=151936,
    qkv_bias=True,
    gated_mlp=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    expert_ff=1408,
    expert_pad=4,               # 60 -> 64 zero-traffic experts: EP | 16-way TP

    skip_shapes=FULL_ATTENTION_SKIP,
)
