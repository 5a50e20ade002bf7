"""Assigned architecture configs (exact hyperparameters from the assignment).

The port's own copy of the reference's ``configs`` package (the data is
small and the port imports nothing of the reference).  Every architecture
is selectable via ``--arch <id>`` in the port's launchers.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, FULL_ATTENTION_SKIP

from repro_torch.configs.codeqwen15_7b import CONFIG as codeqwen15_7b
from repro_torch.configs.mistral_nemo_12b import CONFIG as mistral_nemo_12b
from repro_torch.configs.qwen25_14b import CONFIG as qwen25_14b
from repro_torch.configs.llama32_1b import CONFIG as llama32_1b
from repro_torch.configs.qwen2_moe_a27b import CONFIG as qwen2_moe_a27b
from repro_torch.configs.arctic_480b import CONFIG as arctic_480b
from repro_torch.configs.jamba15_large_398b import CONFIG as jamba15_large_398b
from repro_torch.configs.internvl2_2b import CONFIG as internvl2_2b
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (
        codeqwen15_7b, mistral_nemo_12b, qwen25_14b, llama32_1b,
        qwen2_moe_a27b, arctic_480b, jamba15_large_398b, internvl2_2b,
        whisper_medium, rwkv6_7b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cells():
    """All (arch, shape) grid cells, with skip annotations."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            skip = s.name in a.skip_shapes
            out.append((a, s, skip))
    return out


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_arch",
           "cells", "FULL_ATTENTION_SKIP"]
