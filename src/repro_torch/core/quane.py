"""Quantitative Engine (QuanE): sensitivity-derived influence magnitudes.

Executes the paper's automated preliminary sensitivity analysis: +-1-step
perturbations of every parameter around a reference design, fully vectorized
(one batched model call evaluates all neighbors at once — the LLM-scripted
micro-benchmark orchestration of §3.2.2 collapses into a single batched call).

The result (per-parameter, per-metric deltas *per index step*) initializes
the AHK's quantitative influence factors; the Refinement Loop later
recalibrates them with observed samples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.perfmodel.designspace import DesignSpace
from repro_torch.perfmodel.evaluator import as_evaluator

METRICS = ("ttft", "tpot", "area")


@dataclasses.dataclass
class Sensitivity:
    """Per-parameter signed deltas for a +1 index step at the reference."""
    reference: np.ndarray                      # the sensitivity reference design
    ref_metrics: Dict[str, float]
    delta: Dict[str, Dict[str, float]]         # param -> metric -> d(metric)/d(step)

    def criticality(self, metric: str = "ttft") -> Dict[str, float]:
        """Normalized |influence| of each param on `metric` in [0, 1] —
        the 'least critical resource' ranking used by corrective rule 3."""
        mags = {p: abs(d.get(metric, 0.0)) for p, d in self.delta.items()}
        hi = max(mags.values()) or 1.0
        return {p: v / hi for p, v in mags.items()}

    def as_prompt(self) -> str:
        lines = ["Sensitivity (per +1 step, vs reference):"]
        for p, d in sorted(self.delta.items()):
            lines.append("  " + p + ": " + " ".join(
                f"d{m}={d[m]:+.3e}" for m in METRICS))
        return "\n".join(lines)


def sensitivity_analysis(evaluator, idx: np.ndarray,
                         space: Optional[DesignSpace] = None) -> Sensitivity:
    """Finite-difference sensitivities around design `idx`.

    Uses a central difference where both neighbors exist, one-sided at the
    choice-range boundaries.  ONE fused batched dispatch covers all
    neighbors across every workload.
    """
    ev = as_evaluator(evaluator)
    space = space or ev.space
    idx = np.asarray(idx, dtype=np.int32)
    rows = [idx]
    slots = []  # (param_i, direction, row_index)
    for pi in range(space.n_params):
        for d in (-1, +1):
            j = idx.copy()
            j[pi] += d
            if 0 <= j[pi] < space.cardinalities[pi]:
                slots.append((pi, d, len(rows)))
                rows.append(j)
    batch = np.stack(rows, axis=0)

    if len(ev.workloads) < 2:
        raise ValueError("sensitivity_analysis needs a two-workload "
                         "evaluator (ttft + tpot)")
    rep = ev.objectives(batch)                      # one fused dispatch
    vals = {
        "ttft": rep[:, 0],
        "tpot": rep[:, 1],
        "area": rep[:, -1],
    }
    ref = {m: float(v[0]) for m, v in vals.items()}

    delta: Dict[str, Dict[str, float]] = {}
    for pi, pname in enumerate(space.names):
        ups = [r for (q, d, r) in slots if q == pi and d > 0]
        downs = [r for (q, d, r) in slots if q == pi and d < 0]
        delta[pname] = {}
        for m, v in vals.items():
            if ups and downs:
                delta[pname][m] = float((v[ups[0]] - v[downs[0]]) / 2.0)
            elif ups:
                delta[pname][m] = float(v[ups[0]] - v[0])
            elif downs:
                delta[pname][m] = float(v[0] - v[downs[0]])
            else:
                delta[pname][m] = 0.0
    return Sensitivity(reference=idx.copy(), ref_metrics=ref, delta=delta)
