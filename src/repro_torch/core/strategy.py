"""Strategy Engine (SE): bottleneck -> constrained design-parameter moves.

Implements §3.3.1 plus the three corrective rules of §5.2:
  * focus ONLY on the dominant stall's most-correlated resource;
  * compute predicted deltas against the sensitivity reference;
  * trade area away from the LEAST-critical resource.

The SE formulates each decision as the SAME multiple-choice query format the
DSE Benchmark uses (task=parameter_tuning) and delegates the choice to the
configured LLM backend — the benchmark and the live loop exercise one code
path, which is how the benchmark "ensures consistent architectural
reasoning" inside the framework.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.llm import LLMBackend, MCQuery, TASK_TUNING
from repro_torch.core.memory import TrajectoryMemory
from repro_torch.core.quale import InfluenceMap
from repro_torch.core.quane import Sensitivity
from repro_torch.perfmodel.critical_path import StallReport
from repro_torch.perfmodel.designspace import DesignSpace, SPACE
from repro_torch.perfmodel.roofline import SRAM_FEED_WORDS_PER_KB

Move = Tuple[str, int]          # (param name, +1/-1 index step)


@dataclasses.dataclass
class Directive:
    moves: List[Move]
    new_idx: np.ndarray
    predicted: Dict[str, float]          # predicted metric deltas
    rationale: str

    def as_dict(self) -> dict:
        return {"moves": list(self.moves), "predicted": dict(self.predicted),
                "rationale": self.rationale}


class StrategyEngine:
    """``primary_map`` (stall class -> the single most-correlated resource,
    the AHK primary edges) defaults to the edges of the extracted
    influence graph (:mod:`repro_torch.analysis`); inject a mapping for
    ablations."""

    def __init__(self, llm: LLMBackend, imap: InfluenceMap,
                 space: DesignSpace = SPACE, max_aggressiveness: int = 3,
                 primary_map: Optional[Dict[str, str]] = None):
        self.llm = llm
        self.imap = imap
        self.space = space
        self.max_aggressiveness = max_aggressiveness
        if primary_map is None:
            from repro_torch.analysis import primary_resources
            primary_map = primary_resources()
        self.primary_map = dict(primary_map)

    # ------------------------------------------------------------------
    def propose(self, idx: np.ndarray, report: StallReport, sens: Sensitivity,
                tm: TrajectoryMemory, focus: str,
                area_budget: Optional[float] = None,
                visited: Optional[set] = None) -> Directive:
        """One bottleneck-mitigation step.

        focus in {"ttft","tpot","area"}: the objective this iteration pushes;
        area_budget: if set and current area exceeds it, area-recovery
        trade-offs are mandatory (aggressiveness >= 2).
        """
        idx = np.asarray(idx, dtype=np.int32)
        vals = self.space.decode_np(idx)
        dominant = report.dominant

        relieve = self._relieve_moves(idx, vals, dominant, tm)
        tradeoff = self._tradeoff_moves(idx, sens, focus, tm, dominant)

        over_budget = area_budget is not None and report.area > area_budget
        aggressiveness = self._aggressiveness(report, over_budget)

        options = self._compose_options(relieve, tradeoff, aggressiveness,
                                        focus, over_budget)
        # never propose a design that was already evaluated (budget is precious)
        if visited:
            options = [o for o in options
                       if tuple(self._apply(idx, o)) not in visited]
        if not options:
            options = [self._fallback(idx, tm, visited)]

        crit = sens.criticality(focus if focus != "area" else "ttft")
        q = MCQuery(
            task=TASK_TUNING,
            prompt=(f"Current design {dict((k, int(v)) for k, v in vals.items())}.\n"
                    f"{report.as_prompt()}\n"
                    f"{sens.as_prompt()}\n"
                    f"Objective: minimize {focus}"
                    + (f" under area budget {area_budget:.0f}mm2" if area_budget else "")
                    + ". Pick the best single adjustment set."),
            options=[self._fmt_moves(m) for m in options],
            payload={
                "dominant_stall": dominant,
                "option_params": options,
                "criticality": crit,
                "sa_headroom": self._sa_headroom(vals),
                "constraints_ok": [True] * len(options),
            },
        )
        chosen = options[self.llm.choose(q)]
        new_idx = self._apply(idx, chosen)
        predicted = {
            m: float(sum(sens.delta[p][m] * d for p, d in chosen))
            for m in ("ttft", "tpot", "area")
        }
        return Directive(
            moves=list(chosen), new_idx=new_idx, predicted=predicted,
            rationale=(f"dominant={dominant} focus={focus} "
                       f"aggr={aggressiveness} moves={self._fmt_moves(chosen)}"))

    # ------------------------------------------------------------------
    def _apply(self, idx: np.ndarray, moves: Sequence[Move]) -> np.ndarray:
        new_idx = np.asarray(idx, dtype=np.int32).copy()
        for p, d in moves:
            pi = self.space.names.index(p)
            new_idx[pi] = np.clip(new_idx[pi] + d, 0,
                                  self.space.cardinalities[pi] - 1)
        return new_idx

    def _sa_headroom(self, vals: Dict[str, np.ndarray]) -> bool:
        """Would a one-step larger systolic array still be fed by SRAM?"""
        names = list(self.space.names)
        sa_choices = self.space.choices[names.index("sa_dim")]
        sa = float(vals["sa_dim"])
        bigger = next((c for c in sa_choices if c > sa), sa)
        feed = (SRAM_FEED_WORDS_PER_KB * float(vals["sram_kb"])
                / (bigger * float(vals["sublane_count"])))
        return feed >= 0.5

    def _relieve_moves(self, idx, vals, dominant, tm) -> List[List[Move]]:
        """Candidate move-sets that grow capacity for the dominant stall."""
        out: List[List[Move]] = []
        primary = self.primary_map[dominant]
        candidates = [primary] + [p for p in self.imap.params_for_stall(dominant)
                                  if p != primary]
        for p in candidates:
            pi = self.space.names.index(p)
            if idx[pi] + 1 >= self.space.cardinalities[pi]:
                continue
            if tm.denied(p, +1, dominant):
                continue
            moves = [(p, +1)]
            if p == "sa_dim" and not self._sa_headroom(vals):
                # utilization guard: pair the array growth with SRAM growth
                si = self.space.names.index("sram_kb")
                if idx[si] + 1 < self.space.cardinalities[si]:
                    moves.append(("sram_kb", +1))
                else:
                    continue
            out.append(moves)
        return out

    def _tradeoff_moves(self, idx, sens, focus, tm, dominant) -> List[Move]:
        """Area-recovery candidates: shrink the least-critical resources."""
        crit = sens.criticality(focus if focus != "area" else "ttft")
        area_gain = {p: -sens.delta[p]["area"] for p in crit}   # area saved per -1
        ranked = sorted(crit, key=lambda p: (crit[p], -abs(area_gain[p])))
        out: List[Move] = []
        for p in ranked:
            pi = self.space.names.index(p)
            if idx[pi] == 0:
                continue
            if tm.denied(p, -1, dominant):
                continue
            if sens.delta[p]["area"] <= 0:
                continue  # shrinking must actually save area
            out.append((p, -1))
            if len(out) >= 3:
                break
        return out

    def _aggressiveness(self, report: StallReport, over_budget: bool) -> int:
        a = 1
        if report.dominant_fraction > 0.5:
            a += 1
        if over_budget:
            a += 1
        return min(a, self.max_aggressiveness)

    def _compose_options(self, relieve, tradeoff, aggressiveness, focus,
                         over_budget) -> List[List[Move]]:
        options: List[List[Move]] = []
        if focus == "area" or over_budget:
            # area iterations: pure shrink options first
            for t in tradeoff:
                options.append([t])
            if len(tradeoff) >= 2:
                options.append(tradeoff[:2])
        for r in relieve[:3]:
            touched = {p for p, _ in r}
            compat = [t for t in tradeoff if t[0] not in touched]
            options.append(list(r))
            if aggressiveness >= 2 and compat:
                options.append(list(r) + [compat[0]])
            if aggressiveness >= 3 and len(compat) >= 2:
                options.append(list(r) + compat[:2])
        # dedupe, preserve order
        seen, uniq = set(), []
        for o in options:
            key = tuple(sorted(o))
            if key not in seen:
                seen.add(key)
                uniq.append(o)
        return uniq[:6]

    def _fallback(self, idx, tm, visited=None) -> List[Move]:
        """No admissible informed move: take a random legal (and unvisited)
        step — keeps the loop alive; the refinement pass learns from it."""
        rng = np.random.default_rng(len(tm.samples))
        for _ in range(64):
            pi = int(rng.integers(self.space.n_params))
            d = int(rng.choice([-1, 1]))
            if not (0 <= idx[pi] + d < self.space.cardinalities[pi]):
                continue
            moves = [(self.space.names[pi], d)]
            if visited and tuple(self._apply(idx, moves)) in visited:
                continue
            return moves
        # escape: random 2-param jump
        pis = rng.choice(self.space.n_params, size=2, replace=False)
        return [(self.space.names[int(p)], int(rng.choice([-1, 1]))) for p in pis]

    @staticmethod
    def _fmt_moves(moves: Sequence[Move]) -> str:
        return ", ".join(f"{p}{'+' if d > 0 else '-'}1" for p, d in moves) or "no-op"
