"""Whisper-medium — encoder-decoder; conv audio frontend is a STUB
(``input_specs()`` provides precomputed 1500-frame embeddings).
[arXiv:2212.04356]

seq_len maps to the DECODER side (teacher-forced for train/prefill); the
encoder context is the fixed 1500-frame conv output.  long_500k skipped
(full attention).
"""
from repro_torch.configs.base import ArchConfig, FULL_ATTENTION_SKIP

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    qkv_bias=True,
    gated_mlp=False,            # plain GELU MLP
    enc_layers=24,
    enc_ctx=1500,
    frontend="conv",
    skip_shapes=FULL_ATTENTION_SKIP,
)
