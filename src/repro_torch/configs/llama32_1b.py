"""Llama-3.2-1B — small llama3, GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ArchConfig, FULL_ATTENTION_SKIP

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=5e5,
    skip_shapes=FULL_ATTENTION_SKIP,
)
