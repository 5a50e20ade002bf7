"""LLMCompass-style higher-fidelity analytical model.

Same evaluation core as the roofline model, plus the effects the LLMCompass
simulator captures and the pure roofline misses:

* fixed per-op launch/setup overhead (kernel launch + tile scheduling);
* imperfect overlap between compute and memory streams (a fraction of the
  minor term is exposed);
* achievable (not peak) HBM efficiency.
"""
from __future__ import annotations

from repro_torch.perfmodel.roofline import RooflineModel


class CompassModel(RooflineModel):
    """Knobs calibrated against the paper's Table 4 (normalized TTFT of
    Design A 0.7174 vs the paper's 0.717, Design B 0.5955 vs 0.592)."""
    op_overhead_s = 2.0e-5     # per-op launch + TP-group sync/setup
    nonoverlap = 0.5           # minor-term exposure (no double buffering)
    mem_efficiency = 0.85      # achievable HBM fraction
