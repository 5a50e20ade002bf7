"""RWKV6-7B ("Finch") — attention-free RNN with data-dependent decay.
[arXiv:2404.05892]

O(1) decode state — runs long_500k natively.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                 # d_model / rwkv_head_size
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    gated_mlp=False,
    rwkv_head_size=64,
    skip_shapes=(),             # all four shapes run
)
