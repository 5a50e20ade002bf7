"""InternVL2-2B — InternViT patch frontend (STUB) + InternLM2-1.8B backbone.
[arXiv:2404.16821]

The vision tower is a stub per the assignment: ``input_specs()`` provides
precomputed patch embeddings of shape (batch, seq, d_model) prepended to the
text stream; only the LM backbone is modeled.
"""
from repro_torch.configs.base import ArchConfig, FULL_ATTENTION_SKIP

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    gated_mlp=True,
    frontend="patch",
    skip_shapes=FULL_ATTENTION_SKIP,
)
