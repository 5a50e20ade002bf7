"""The Lumina DSE loop (Figure 2): AHK acquisition -> iterate
(evaluate -> bottleneck analysis -> strategy -> explore) -> refine.

Both fidelity tiers are :class:`~repro_torch.perfmodel.evaluator.Evaluator`
instances: the *target* evaluator is the budgeted simulation environment
(each EE step = ONE fused dispatch), the *proxy* evaluator serves
QualE probing and QuanE sensitivity for free (§3.2.2: "the QuanE can focus
on estimating only power and area, which are faster to evaluate").  Budget
accounting follows the paper: only EE dispatches on the target tier count.

The loop is exposed at two altitudes:

* :meth:`LuminaDSE.run` — the closed single-trajectory loop (optionally
  seeded with a LIST of initial designs, with an injectable per-step
  callback for telemetry);
* :meth:`LuminaDSE.start` -> :class:`Campaign` — the stepwise
  propose/observe view that :class:`~repro_torch.core.campaign.
  CampaignRunner` drives to run K campaigns against ONE shared engine,
  fusing each round's candidate evaluations into a single batched
  dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.analysis.influence import (RuleAudit, cross_validate,
                                            extract_influence_graph)
from repro_torch.core.explore import ExplorationEngine
from repro_torch.core.llm import LLMBackend, RuleOracle
from repro_torch.core.memory import Sample, TrajectoryMemory
from repro_torch.core.quale import derive_influence_map, InfluenceMap
from repro_torch.core.quane import sensitivity_analysis
from repro_torch.core.refine import RefinementLoop
from repro_torch.core.strategy import Directive, StrategyEngine
from repro_torch.perfmodel.designspace import DesignSpace, SPACE, A100_REFERENCE
from repro_torch.perfmodel.evaluator import Evaluator, as_evaluator, pair_view

FOCUS_CYCLE = ("ttft", "tpot", "area")

# step_callback(campaign, sample) — invoked after every budgeted observation
StepCallback = Callable[["Campaign", Sample], None]


@dataclasses.dataclass
class DSEResult:
    samples: List[Sample]
    phv: float
    sample_efficiency: float
    superior_count: int
    pareto: List[Sample]
    trajectory_notes: List[str]


class Campaign:
    """Stepwise view of ONE Lumina trajectory.

    Its runner (``LuminaDSE.run`` or ``CampaignRunner``) alternates::

        idx, directive = campaign.propose()
        sample = engine.evaluate(idx, step=campaign.step, directive=directive)
        campaign.observe(sample)

    ``propose`` first drains the campaign's initial seed list (step 0), then
    runs the bottleneck-analysis -> strategy cycle.  A shared ``visited`` set
    may be injected so parallel campaigns never burn budget re-evaluating
    each other's designs.
    """

    def __init__(self, dse: "LuminaDSE", init: np.ndarray,
                 visited: Optional[Set[tuple]] = None,
                 label: str = "lumina"):
        self.dse = dse
        self.label = label
        self.tm = TrajectoryMemory(dse.ref_point)
        self.notes: List[str] = []
        self.se = StrategyEngine(dse.llm, dse.imap, dse.space,
                                 primary_map=dse.primary_map)
        inits = np.atleast_2d(np.asarray(init, dtype=np.int32))
        self._pending_inits = []             # de-duplicated, order-preserving
        seen: Set[tuple] = set()
        for row in inits:
            key = tuple(row)
            if key not in seen:
                seen.add(key)
                self._pending_inits.append(row.copy())
        self.sens = sensitivity_analysis(dse.proxy, inits[0], space=dse.space)
        self.visited: Set[tuple] = visited if visited is not None else set()
        self.step = 0
        self._directive: Optional[Directive] = None

    def propose(self) -> Tuple[np.ndarray, Optional[Directive]]:
        """Next candidate design (and the directive that produced it)."""
        if self._pending_inits:
            self._directive = None
            idx = self._pending_inits.pop(0)
            # claim the seed NOW so sibling campaigns proposing later in the
            # same round never spend budget re-evaluating it
            self.visited.add(tuple(idx))
            return idx, None
        self.step += 1
        focus = FOCUS_CYCLE[(self.step - 1) % len(FOCUS_CYCLE)]
        base = self.tm.best(weights=_focus_weights(focus)) or self.tm.samples[-1]
        rep_t, rep_p = self.dse.ee.reports(base.idx)  # cached reads, cheap
        report = rep_p if focus == "tpot" else rep_t
        directive = self.se.propose(base.idx, report, self.sens, self.tm,
                                    focus, area_budget=self.dse.area_budget,
                                    visited=self.visited)
        self.visited.add(tuple(directive.new_idx))
        self._directive = directive
        return directive.new_idx, directive

    def observe(self, sample: Sample) -> None:
        """Record one evaluated proposal and run the refinement pass."""
        self.tm.add(sample)
        self.visited.add(tuple(sample.idx))
        if self._directive is not None:
            note = self.dse.refiner.update(self.sens, self.tm, sample)
            if note:
                self.notes.append(f"step {self.step}: {note}")
            self.sens = self.dse.refiner.maybe_reanchor(
                self.sens, self.tm, self.dse.proxy, self.step)
        self._directive = None

    def result(self) -> DSEResult:
        return DSEResult(
            samples=list(self.tm.samples),
            phv=self.tm.phv(),
            sample_efficiency=self.tm.sample_efficiency(),
            superior_count=self.tm.superior_count(),
            pareto=self.tm.pareto(),
            trajectory_notes=list(self.notes),
        )


class LuminaDSE:
    def __init__(self, evaluator: Evaluator, *,
                 proxy: Optional[Evaluator] = None,
                 llm: Optional[LLMBackend] = None,
                 space: DesignSpace = SPACE,
                 ref_point: Optional[np.ndarray] = None,
                 area_budget: Optional[float] = None,
                 seed: int = 0,
                 engine: Optional[ExplorationEngine] = None,
                 imap: Optional[InfluenceMap] = None,
                 workloads: Optional[Tuple[str, str]] = None,
                 primary_map: Optional[dict] = None):
        """``engine`` lets parallel campaigns share ONE ExplorationEngine
        (one budget counter, one report cache); ``imap`` injects an already
        derived influence map so K campaigns pay acquisition once;
        ``workloads`` picks the (prefill, decode) pair of a multi-workload
        evaluator this loop optimizes (e.g. one zoo-suite scenario);
        ``primary_map`` overrides the source-extracted AHK primary edges
        (stall -> parameter) for every campaign's SE — the ablation hook."""
        self.space = space
        evaluator = as_evaluator(evaluator)
        self.ee = (engine if engine is not None
                   else ExplorationEngine(evaluator, workloads=workloads))
        proxy = proxy if proxy is not None else evaluator
        if workloads is not None and hasattr(proxy, "models"):
            # scenario campaigns: QualE/QuanE read objective columns 0/1,
            # so the proxy must expose exactly this (prefill, decode) pair
            proxy = pair_view(proxy, workloads)
        self.proxy = proxy
        self.llm = llm or RuleOracle(enhanced=True)
        self.refiner = RefinementLoop()
        self.seed = seed
        self._imap = imap
        self.primary_map = primary_map   # None -> source-extracted default
        if ref_point is None:
            # the reference evaluation is free (given); reports() caches it so
            # a campaign starting at the reference re-reads it for free
            ref_idx = space.encode_nearest(A100_REFERENCE)
            rep_t, rep_p = self.ee.reports(ref_idx)
            ref_point = np.array([rep_t.latency, rep_p.latency, rep_t.area])
        self.ref_point = np.asarray(ref_point, dtype=np.float64)
        if self.ee.ref_point is None:    # objective scales for stall merging
            self.ee.ref_point = self.ref_point
        self.area_budget = (area_budget if area_budget is not None
                            else float(self.ref_point[2]))

    @property
    def imap(self) -> InfluenceMap:
        """QualE influence map (proxy tier, derived once per instance)."""
        if self._imap is None:
            self._imap = derive_influence_map(self.proxy, space=self.space,
                                              seed=self.seed)
        return self._imap

    def rule_audit(self) -> RuleAudit:
        """Cross-validate the source-extracted influence graph against this
        loop's probe-derived map: the auto-correction telemetry of §5.2
        (source-vs-probe disagreements are candidate rule corrections)."""
        return cross_validate(extract_influence_graph(), self.imap)

    # ------------------------------------------------------------------
    def start(self, init: Optional[np.ndarray] = None,
              visited: Optional[Set[tuple]] = None,
              label: str = "lumina") -> Campaign:
        """Open a stepwise campaign seeded at ``init`` (a design-index
        vector OR a list/array of them — a sweep-derived seed list)."""
        if init is None:
            init = self.space.encode_nearest(A100_REFERENCE)
        return Campaign(self, init, visited=visited, label=label)

    def run(self, budget: int = 20,
            init: Optional[np.ndarray] = None,
            step_callback: Optional[StepCallback] = None) -> DSEResult:
        """The closed loop: one campaign, `budget` target-tier evaluations.

        ``init`` may be a single design or a seed list (all seeds are
        evaluated first, then the trajectory continues from the best);
        ``step_callback(campaign, sample)`` fires after every observation —
        the injection point for per-step regret/PHV telemetry.
        """
        campaign = self.start(init)
        budget_stop = self.ee.evals + budget
        while self.ee.evals < budget_stop:
            idx, directive = campaign.propose()
            sample = self.ee.evaluate(idx, step=campaign.step,
                                      directive=directive)
            campaign.observe(sample)
            if step_callback is not None:
                step_callback(campaign, sample)
        return campaign.result()


def _focus_weights(focus: str):
    return {"ttft": (3.0, 1.0, 1.0), "tpot": (1.0, 3.0, 1.0),
            "area": (1.0, 1.0, 3.0)}[focus]
