"""CodeQwen1.5-7B — dense, Qwen1.5 architecture (QKV bias, MHA: kv == heads).
[hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ArchConfig, FULL_ATTENTION_SKIP

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    gated_mlp=True,
    rope_theta=1e6,
    skip_shapes=FULL_ATTENTION_SKIP,
)
