"""Optimizer (AdamW, cosine schedule) and int8 gradient compression."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_lr)
from repro_torch.optim.compress import (compress_grads, decompress_grads,
                                        ef_init)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "compress_grads", "decompress_grads", "ef_init"]
