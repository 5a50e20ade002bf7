"""Flash attention forward and backward (CUDA kernels + plain torch
versions)."""
from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn, flash_attention, flash_attention_bwd,
    flash_attention_bwd_cost, flash_attention_bwd_plain,
    flash_attention_cost, flash_attention_plain)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_cost", "flash_attention_bwd_plain",
           "flash_attention_cost", "flash_attention_plain"]
