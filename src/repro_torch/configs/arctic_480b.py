"""Snowflake Arctic-480B — dense-MoE hybrid: every layer has a dense FFN
residual in parallel with a 128-expert top-2 MoE. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ArchConfig, FULL_ATTENTION_SKIP

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,                  # the dense residual FFN
    vocab=32000,
    gated_mlp=True,
    n_experts=128,
    top_k=2,
    n_shared_experts=0,
    expert_ff=4864,
    dense_residual=True,
    skip_shapes=FULL_ATTENTION_SKIP,
)
