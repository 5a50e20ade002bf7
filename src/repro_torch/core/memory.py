"""Trajectory Memory (TM): every evaluated sample + reflection helpers."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pareto import pareto_mask, hypervolume, dominates_ref


@dataclasses.dataclass
class Sample:
    step: int
    idx: np.ndarray                      # design (choice indices)
    ttft: float
    tpot: float
    area: float
    dominant_stall: str
    directive: Optional[dict] = None     # what the SE changed and predicted
    note: str = ""

    @property
    def objectives(self) -> np.ndarray:
        return np.array([self.ttft, self.tpot, self.area])


class TrajectoryMemory:
    def __init__(self, ref_point: np.ndarray):
        self.samples: List[Sample] = []
        self.ref = np.asarray(ref_point, dtype=np.float64)
        # failure patterns discovered by reflection: (param, direction, stall)
        # -> strike count; strategy avoids repeating heavily-struck moves.
        self.deny: Dict[Tuple[str, int, str], int] = {}

    # ------------------------------------------------------------------
    def add(self, s: Sample) -> None:
        self.samples.append(s)

    def objectives(self) -> np.ndarray:
        if not self.samples:
            return np.zeros((0, 3))
        return np.stack([s.objectives for s in self.samples])

    def pareto(self) -> List[Sample]:
        y = self.objectives()
        if len(y) == 0:
            return []
        mask = pareto_mask(y)
        out, seen = [], set()
        for s, m in zip(self.samples, mask):
            key = tuple(s.idx)
            if m and key not in seen:
                seen.add(key)
                out.append(s)
        return out

    def phv(self) -> float:
        return hypervolume(self.objectives(), self.ref)

    def superior_count(self) -> int:
        y = self.objectives()
        return int(dominates_ref(y, self.ref).sum()) if len(y) else 0

    def sample_efficiency(self) -> float:
        n = len(self.samples)
        return self.superior_count() / n if n else 0.0

    def best(self, weights=(1.0, 1.0, 1.0)) -> Optional[Sample]:
        """Best sample under normalized weighted sum (vs reference point)."""
        if not self.samples:
            return None
        y = self.objectives() / self.ref[None, :]
        score = (y * np.asarray(weights)[None, :]).sum(axis=1)
        return self.samples[int(np.argmin(score))]

    # ------------------- reflection --------------------------------
    def reflect(self, s: Sample) -> str:
        """Paper §3.4: identify failed attempts and record the pattern so the
        Strategy Engine avoids repeating them."""
        if s.directive is None or len(self.samples) < 2:
            return ""
        prev = self.samples[-2]
        improved = (s.ttft < prev.ttft) or (s.tpot < prev.tpot) or (s.area < prev.area)
        not_worse = (s.ttft <= prev.ttft * 1.001 and s.tpot <= prev.tpot * 1.001
                     and s.area <= prev.area * 1.001)
        if improved and not_worse:
            # confirmed move: relax any strikes against it
            for (param, direction) in s.directive.get("moves", []):
                key = (param, direction, prev.dominant_stall)
                if key in self.deny:
                    self.deny[key] = max(0, self.deny[key] - 1)
            return ""
        notes = []
        for (param, direction) in s.directive.get("moves", []):
            key = (param, direction, prev.dominant_stall)
            self.deny[key] = self.deny.get(key, 0) + 1
            notes.append(f"avoid {param}{'+' if direction > 0 else '-'} under "
                         f"{prev.dominant_stall} (strike {self.deny[key]})")
        return "; ".join(notes)

    def denied(self, param: str, direction: int, stall: str,
               threshold: int = 2) -> bool:
        return self.deny.get((param, direction, stall), 0) >= threshold
