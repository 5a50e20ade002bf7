"""Flash-attention forward (CUDA kernel + plain torch version)."""
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_cost,
                                                     flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_cost", "flash_attention_plain"]
