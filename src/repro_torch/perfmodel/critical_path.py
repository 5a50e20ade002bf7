"""Critical-path / stall attribution (the paper's extension of LLMCompass).

``attribute_stalls`` reduces a model evaluation into the structured
critical-path feedback the Strategy Engine consumes: per-stall-class times,
the dominant stall, and the top offending operators.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

STALL_CLASSES = ("tensor_compute", "vector_compute", "memory_bw", "interconnect")


@dataclasses.dataclass
class StallReport:
    """Critical-path feedback for ONE design point."""
    stall_seconds: Dict[str, float]          # per-class attributed time
    dominant: str                            # argmax class
    dominant_fraction: float                 # its share of total latency
    top_ops: List[tuple]                     # [(op_name, class, seconds)] desc
    latency: float
    area: float

    def as_prompt(self) -> str:
        """Serialize the way the simulator feedback is presented to the LLM."""
        lines = [f"total_latency={self.latency:.6e}s area={self.area:.1f}mm2",
                 "stall breakdown:"]
        for c in STALL_CLASSES:
            lines.append(f"  {c}: {self.stall_seconds[c]:.6e}s"
                         f" ({self.stall_seconds[c] / max(self.latency, 1e-30):.1%})")
        lines.append(f"dominant stall: {self.dominant}"
                     f" ({self.dominant_fraction:.1%} of latency)")
        lines.append("top ops: " + ", ".join(
            f"{nm}[{cl}]={t:.3e}s" for nm, cl, t in self.top_ops))
        return "\n".join(lines)


def build_report(latency: float, area: float, stall: np.ndarray,
                 op_time: np.ndarray, op_class: np.ndarray,
                 op_names, top: int = 5) -> StallReport:
    """Assemble a :class:`StallReport` from one design's evaluated arrays.

    The single report-construction path shared by
    :func:`attribute_stalls` and :meth:`repro_torch.perfmodel.evaluator.
    PPAReport.stall_report`.
    """
    latency = float(latency)
    order = np.argsort(op_time)[::-1][:top]
    top_ops = [(op_names[i], STALL_CLASSES[int(op_class[i])],
                float(op_time[i])) for i in order]
    per = {c: float(stall[i]) for i, c in enumerate(STALL_CLASSES)}
    dom_i = int(np.argmax(stall))
    return StallReport(
        stall_seconds=per,
        dominant=STALL_CLASSES[dom_i],
        dominant_fraction=float(stall[dom_i] / max(latency, 1e-30)),
        top_ops=top_ops,
        latency=latency,
        area=float(area),
    )


def attribute_stalls(model, idx: np.ndarray, top: int = 5, *,
                     device=None) -> StallReport:
    """Evaluate one design and produce its critical-path report, through a
    (memoized) single-workload evaluator on `device`."""
    from repro_torch.perfmodel.evaluator import evaluator_for_model
    rep = evaluator_for_model(model, device=device).stalls(np.atleast_2d(idx))
    return rep.stall_report(i=0, top=top)
