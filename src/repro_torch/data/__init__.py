"""Synthetic, replayable LM data with background prefetch."""
from repro_torch.data.pipeline import (PrefetchIterator, SyntheticLMDataset,
                                       make_batch_iter)

__all__ = ["SyntheticLMDataset", "PrefetchIterator", "make_batch_iter"]
