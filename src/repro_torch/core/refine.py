"""Refinement Loop (§3.4): data-driven correction of the AHK.

After each observed sample, the quantitative influence factors are
recalibrated toward the observed per-move deltas (EMA), and failed attempts
are reflected into the Trajectory Memory's deny-list.  Periodically the
sensitivity reference is re-anchored at the current best design so the
"delta vs sensitivity reference" rule stays locally valid.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.memory import Sample, TrajectoryMemory
from repro_torch.core.quane import Sensitivity, sensitivity_analysis


class RefinementLoop:
    def __init__(self, alpha: float = 0.5, reanchor_every: int = 5):
        self.alpha = alpha
        self.reanchor_every = reanchor_every

    def update(self, sens: Sensitivity, tm: TrajectoryMemory,
               sample: Sample) -> str:
        """EMA-correct influence factors with the observed move outcome."""
        note = tm.reflect(sample)
        if sample.directive is None or len(tm.samples) < 2:
            return note
        prev = tm.samples[-2]
        observed = {
            "ttft": sample.ttft - prev.ttft,
            "tpot": sample.tpot - prev.tpot,
            "area": sample.area - prev.area,
        }
        moves = sample.directive.get("moves", [])
        if not moves:
            return note
        # distribute the observed delta over the moves proportionally to the
        # current factors, then EMA each factor toward its share
        for metric, obs in observed.items():
            cur = {p: sens.delta[p][metric] * d for p, d in moves}
            total = sum(cur.values())
            for (p, d) in moves:
                share = cur[p] / total if abs(total) > 1e-30 else obs / len(moves)
                target = (obs * share / d) if abs(total) > 1e-30 else obs / (len(moves) * d)
                sens.delta[p][metric] = ((1 - self.alpha) * sens.delta[p][metric]
                                         + self.alpha * target)
        return note

    def maybe_reanchor(self, sens: Sensitivity, tm: TrajectoryMemory,
                       evaluator, step: int) -> Sensitivity:
        """Re-anchor the sensitivity reference at the current best design.

        `evaluator` is the proxy-tier :class:`~repro_torch.perfmodel.evaluator.
        Evaluator`.
        """
        if step % self.reanchor_every != 0 or not tm.samples:
            return sens
        best = tm.best()
        if best is None or np.array_equal(best.idx, sens.reference):
            return sens
        return sensitivity_analysis(evaluator, best.idx)
