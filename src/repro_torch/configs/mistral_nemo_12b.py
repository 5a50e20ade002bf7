"""Mistral-Nemo-12B — dense GQA (kv=8), head_dim 128, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.configs.base import ArchConfig, FULL_ATTENTION_SKIP

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,               # explicit: NOT d_model // n_heads (=160)
    d_ff=14336,
    vocab=131072,
    gated_mlp=True,
    rope_theta=1e6,
    skip_shapes=FULL_ATTENTION_SKIP,
)
