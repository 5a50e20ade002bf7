"""Multi-campaign DSE orchestration: sweep-seeded parallel Lumina campaigns.

The paper's headline result hinges on bottleneck-guided starts;
:class:`CampaignRunner` turns the full-space sweep's per-stall-class seed
designs (:meth:`~repro_torch.perfmodel.sweep.SweepResult.stall_seeds`)
into K parallel :class:`~repro_torch.core.loop.Campaign` trajectories — one
campaign per dominant-stall class that actually occurs in the sweep, plus
the A100 reference start — under ONE shared evaluation budget.

The performance core is the fused round dispatch: every live campaign
proposes its next candidate, the K candidates are evaluated in ONE batched
:class:`~repro_torch.perfmodel.evaluator.EvalRequest` via
:meth:`~repro_torch.core.explore.ExplorationEngine.prefetch`, and each
campaign then observes its (now cache-resident) result dispatch-free.  K
campaigns at budget B therefore cost ~B/K + O(1) fused dispatches instead
of B.

With a plain ``Evaluator`` the runner owns the batching: one prefetched
request per round.  With an :class:`~repro_torch.distributed.service.
EvalService` each campaign submits its own ``stalls`` request on the
``interactive`` tier (its label is the client) and the service's
coalescing tick fuses them into one dispatch; a failed request is
resubmitted once (``campaign_service_resubmits``), and the result's
``service_counters`` is the service's ``telemetry()``.  A round asks for
stall attribution, which runs on torch ops on every backend; the ``cuda``
backend's ``ppa_eval`` launch serves the objectives dispatches of the
proxy tier (QuanE's sensitivity probes) and a service's proxy rung.

``scenario=`` (or ``workloads=``) points the whole runner at ONE scenario
of a multi-workload zoo-suite evaluator: the campaigns optimize that
scenario's (prefill, decode) pair, and seeding them from
``SweepResult.stall_seeds(scenario=...)`` launches bottleneck campaigns
per scenario class.

Scheduling is pluggable (``policy=``): ``"uniform"`` gives every live
campaign one evaluation per round (round-robin clipping); ``"adaptive"``
scores each campaign by its regret slope — an EWMA of per-round archive
gains (new Pareto point or per-objective best) — and drains the shared
budget through :func:`allocate_slots`, a weighted-deficit allocator over
``weight_floor + gain_ewma``.  Budget flows CONTINUOUSLY toward campaigns
whose regret is still falling; a stalled campaign's weight decays toward
the floor instead of being binarily early-stopped, so it keeps probing at
a trickle and can win budget back the moment it improves again.

Every observation is instrumented: the merged archive's per-objective
regret against the oracle front (:meth:`~repro_torch.perfmodel.evaluator.
OracleEvaluator.regret`) and its PHV as a fraction of the oracle front's
PHV are recorded per step and persist as a JSON time series
(:meth:`CampaignSetResult.save_telemetry`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Mapping, Optional, TYPE_CHECKING

import numpy as np

from repro_torch.core.explore import ExplorationEngine
from repro_torch.core.llm import LLMBackend
from repro_torch.core.loop import Campaign, DSEResult, LuminaDSE
from repro_torch.core.memory import Sample, TrajectoryMemory
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP
from repro_torch.perfmodel.designspace import DesignSpace, SPACE, A100_REFERENCE
from repro_torch.perfmodel.evaluator import (EvalRequest, Evaluator,
                                             OracleEvaluator, as_evaluator)

if TYPE_CHECKING:                       # avoid perfmodel <-> core import cycle
    from repro_torch.perfmodel.sweep import SweepResult

REFERENCE_CAMPAIGN = "a100"

POLICIES = ("uniform", "adaptive")

TELEMETRY_VERSION = 5    # v5: + metrics (registry snapshot); v4: +
                         # stall_histogram, rule_audit

#: Adaptive policy: minimum scheduling weight of a fully-stalled campaign.
#: Nonzero so no campaign is ever starved outright — a long-stalled
#: trajectory still gets ~floor/total of the budget to probe with.
ADAPTIVE_WEIGHT_FLOOR = 0.05


def allocate_slots(order: List[str], credit: Dict[str, float],
                   weights: Mapping[str, float], slots: int) -> List[str]:
    """Weighted-deficit slot allocation for one scheduling round.

    Each label in ``order`` accrues ``slots * w / sum(w)`` credit (its
    fair share of this round), then the ``slots`` highest-credit labels
    are chosen and debited 1.0 each.  ``credit`` is mutated in place and
    carries between rounds, so fractional shares accumulate: a label
    with 10% of the total weight is chosen ~1 round in 10, never zero —
    the deficit round robin of a QoS drain, applied to campaigns.

    Ties break toward the front of ``order`` (stable sort), and the
    chosen labels are returned in ``order`` sequence.
    """
    if slots <= 0 or not order:
        return []
    slots = min(int(slots), len(order))
    total = sum(weights[lb] for lb in order)
    if total <= 0:
        raise ValueError("allocate_slots needs positive total weight")
    for lb in order:
        credit[lb] = credit.get(lb, 0.0) + slots * weights[lb] / total
    chosen = set(sorted(order, key=lambda lb: -credit[lb])[:slots])
    for lb in chosen:
        credit[lb] -= 1.0
    return [lb for lb in order if lb in chosen]


@dataclasses.dataclass
class StepRecord:
    """One budgeted observation in a multi-campaign run (JSON-serializable)."""
    eval_i: int                        # global evaluations spent (1-based)
    round_i: int                       # fused-dispatch round index
    campaign: str                      # which trajectory observed this design
    step: int                          # campaign-local step
    objectives: List[float]            # [ttft, tpot, area] of the design
    phv: float                         # merged-archive PHV after this step
    phv_frac: Optional[float] = None   # merged PHV / oracle-front PHV
    regret: Optional[List[float]] = None  # per-objective regret vs oracle


@dataclasses.dataclass
class CampaignSetResult:
    per_campaign: Dict[str, DSEResult]
    samples: List[Sample]              # merged, in observation order
    phv: float
    superior_count: int
    pareto: List[Sample]
    telemetry: List[StepRecord]
    dispatches: int                    # fused target-tier dispatches spent
    rounds: int
    policy: str = "uniform"
    early_stopped: Dict[str, int] = dataclasses.field(default_factory=dict)
    # ^ legacy binary early-stop ledger; the continuous adaptive policy
    #   never stops a campaign outright, so this stays empty since v3
    budget_weights: Optional[Dict[str, float]] = None
    # ^ final per-campaign scheduling weights (floor + gain EWMA) under
    #   the adaptive policy; None under uniform
    service_counters: Optional[dict] = None
    # ^ EvalService.telemetry() snapshot (+ campaign_resubmits) when the
    #   runner drove a service; None for a plain evaluator
    stall_histogram: Optional[Dict[str, int]] = None
    # ^ dominant-stall counts over all budgeted observations: which AHK
    #   rules fired (and how often) across the campaign set
    rule_audit: Optional[dict] = None
    # ^ source-extracted influence graph vs this run's probe-derived map
    #   (repro_torch.analysis.influence.RuleAudit.as_dict()): the §5.2
    #   auto-correction telemetry — disagreements = candidate corrections
    metrics: Optional[dict] = None
    # ^ the runner's MetricsRegistry.snapshot() at run end (v5): round /
    #   per-campaign observation counters in the unified obs format

    def telemetry_dict(self) -> dict:
        return {
            "version": TELEMETRY_VERSION,
            "campaigns": sorted(self.per_campaign),
            "rounds": self.rounds,
            "dispatches": self.dispatches,
            "policy": self.policy,
            "early_stopped": dict(self.early_stopped),
            "budget_weights": (None if self.budget_weights is None
                               else dict(self.budget_weights)),
            "service": self.service_counters,
            "stall_histogram": (None if self.stall_histogram is None
                                else dict(self.stall_histogram)),
            "rule_audit": self.rule_audit,
            "metrics": self.metrics,
            "records": [dataclasses.asdict(r) for r in self.telemetry],
        }

    def save_telemetry(self, path: str) -> None:
        """Persist the per-step regret / PHV-fraction time series as JSON."""
        with open(path, "w") as f:
            json.dump(self.telemetry_dict(), f, indent=1)

    def regret_curve(self) -> np.ndarray:
        """(n_steps, n_obj) per-objective regret after each observation
        (rows of NaN where no oracle was attached)."""
        return np.array([r.regret if r.regret is not None
                         else [np.nan] * len(r.objectives)
                         for r in self.telemetry])

    def phv_frac_curve(self) -> np.ndarray:
        return np.array([np.nan if r.phv_frac is None else r.phv_frac
                         for r in self.telemetry])


def load_telemetry(path: str) -> dict:
    """Load a :meth:`CampaignSetResult.save_telemetry` JSON, upgrading
    older format versions to the current one in memory.

    v4 (and earlier) files predate the ``metrics`` registry snapshot;
    v3 files predate ``stall_histogram`` / ``rule_audit``.  Missing keys
    are filled with ``None`` and ``version`` is stamped to the current
    :data:`TELEMETRY_VERSION` — a file from a NEWER build refuses to
    load (its keys could mean something this build does not know).
    """
    with open(path) as f:
        data = json.load(f)
    version = int(data.get("version", 1))
    if version > TELEMETRY_VERSION:
        raise ValueError(
            f"telemetry format v{version} is newer than this build's "
            f"v{TELEMETRY_VERSION}; refusing to load")
    if version < 4:
        data.setdefault("stall_histogram", None)
        data.setdefault("rule_audit", None)
    if version < 5:
        data.setdefault("metrics", None)
    data["version"] = TELEMETRY_VERSION
    return data


class CampaignRunner:
    """Launch K parallel Lumina campaigns against one shared budget.

    Parameters
    ----------
    evaluator:
        The budgeted target-tier :class:`~repro_torch.perfmodel.evaluator.
        Evaluator` (every campaign's EE dispatches land here, fused).
    proxy:
        Free acquisition-tier evaluator (QualE/QuanE); defaults to
        ``evaluator``.
    oracle:
        Optional :class:`~repro_torch.perfmodel.evaluator.
        OracleEvaluator`; when given, every step is scored with exact
        per-objective regret and PHV-fraction against the exhaustive front.
    seeds_per_campaign:
        How many sweep seeds each stall-class campaign starts from (its
        step-0 seed list; all are evaluated — they spend budget).
    policy:
        ``"uniform"`` — one evaluation per live campaign per round with
        round-robin clipping.  ``"adaptive"`` — continuous budget
        reallocation by regret slope: each campaign carries an EWMA of
        its per-round archive gains, its scheduling weight is
        ``ADAPTIVE_WEIGHT_FLOOR + gain_ewma``, and each round's slots are
        drained through the weighted-deficit :func:`allocate_slots`.
        Improving campaigns propose (nearly) every round; stalled ones
        decay toward a trickle but are never stopped outright, so a
        late bloomer wins its budget share back the moment it improves.
    patience:
        Adaptive-policy memory horizon: the gain EWMA's smoothing is
        ``alpha = 1 / (1 + patience)``, so a campaign's weight decays to
        ~the floor after a few ``patience`` windows without improvement.
    """

    def __init__(self, evaluator: Evaluator, *,
                 proxy: Optional[Evaluator] = None,
                 oracle: Optional[OracleEvaluator] = None,
                 llm: Optional[LLMBackend] = None,
                 space: DesignSpace = SPACE,
                 ref_point: Optional[np.ndarray] = None,
                 area_budget: Optional[float] = None,
                 seed: int = 0,
                 seeds_per_campaign: int = 1,
                 policy: str = "uniform",
                 patience: int = 3,
                 workloads: Optional[tuple] = None,
                 scenario: Optional[str] = None,
                 primary_map: Optional[Dict[str, str]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        # deferred import: repro_torch.distributed pulls perfmodel (and
        # through it this module) back in — binding it lazily breaks the
        # cycle for processes whose import chain starts there
        from repro_torch.distributed.service import EvalService
        self.space = space
        self.evaluator = as_evaluator(evaluator)
        self._service = (self.evaluator
                         if isinstance(self.evaluator, EvalService) else None)
        # default to the service's tracer so campaign spans root the same
        # causal tree its tick/dispatch spans grow under
        self.tracer = (tracer if tracer is not None
                       else getattr(self._service, "tracer", None) or NOOP)
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._c_rounds = self.metrics.counter(
            "campaign_rounds", "fused-dispatch rounds driven")
        self._c_obs = self.metrics.counter(
            "campaign_observations", "budgeted observations, per campaign",
            labelnames=("campaign",))
        self._c_resubmits = self.metrics.counter(
            "campaign_service_resubmits",
            "failed service requests resubmitted once")
        if scenario is not None:
            # pick a zoo-suite scenario by name: its (prefill, decode)
            # workload pair becomes this runner's objective pair
            scenarios = getattr(self.evaluator, "scenarios", None) or ()
            match = [s for s in scenarios if s.name == scenario]
            if not match:
                raise KeyError(
                    f"unknown scenario {scenario!r}; evaluator has "
                    f"{tuple(s.name for s in scenarios)}")
            if workloads is not None:
                raise ValueError("pass workloads= or scenario=, not both")
            workloads = (match[0].prefill, match[0].decode)
        self.scenario = scenario
        self.ee = ExplorationEngine(self.evaluator, workloads=workloads)
        self.oracle = oracle
        self.seeds_per_campaign = int(seeds_per_campaign)
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.patience = max(1, int(patience))
        # one LuminaDSE holds the shared pieces (engine, proxy, imap, ref);
        # campaigns are stepwise views onto it
        self.dse = LuminaDSE(self.evaluator, proxy=proxy, llm=llm,
                             space=space, ref_point=ref_point,
                             area_budget=area_budget, seed=seed,
                             engine=self.ee, workloads=workloads,
                             primary_map=primary_map)
        self.ref_point = self.dse.ref_point

    @property
    def service_resubmits(self) -> int:
        """Failed-request resubmissions across all :meth:`run` calls."""
        return int(self._c_resubmits.value())

    def _service_round(self, proposals) -> None:
        """One round through the service: every campaign submits its own
        ``stalls`` request on the interactive tier (campaign traffic is
        latency-critical for the human in the loop, so background batch
        and scavenger traffic cannot starve the rounds), the service's
        tick fuses them, and a failed request gets ONE resubmission before
        its error surfaces (worker loss heals between ticks)."""
        svc = self._service

        def submit(p):
            return svc.submit(EvalRequest(p[2][None, :], detail="stalls"),
                              client=p[0], tier="interactive")

        futures = [submit(p) for p in proposals]
        svc.tick()
        while not all(f.done() for f in futures):
            svc.tick()                       # row-capped service ticks
        retried = []
        for p, fut in zip(proposals, futures):
            if fut.exception() is not None:
                self._c_resubmits.inc()
                retried.append(submit(p))
        while retried and not all(f.done() for f in retried):
            svc.tick()
        for fut in retried:
            fut.result()                     # a second failure is real

    # ------------------------------------------------------------------
    def seed_starts(self, seeds: Mapping[str, np.ndarray],
                    include_reference: bool = True) -> Dict[str, np.ndarray]:
        """{campaign label -> (k, n_params) step-0 seed list}.

        ``seeds`` is :meth:`SweepResult.stall_seeds` output (or any
        {label -> seed array} mapping).  Stall classes with NO seed designs
        (every design in the sweep had some other dominant stall) are
        skipped, not crashed on.  Within a class, seeds are ranked by their
        worst objective ratio vs the reference point (minimax), so the
        campaign starts from the most balanced bottleneck representative.
        """
        starts: Dict[str, np.ndarray] = {}
        claimed: set = set()                 # no design seeds two campaigns
        if include_reference:
            ref_idx = self.space.encode_nearest(A100_REFERENCE)
            starts[REFERENCE_CAMPAIGN] = ref_idx[None, :]
            claimed.add(tuple(ref_idx))
        for label, arr in seeds.items():
            arr = np.asarray(arr, dtype=np.int32)
            arr = arr.reshape(-1, self.space.n_params) if arr.size else arr
            if arr.size == 0:
                continue                      # empty stall class: no campaign
            order = np.argsort(self._minimax_ratio(arr), kind="stable")
            take = [row for row in arr[order]
                    if tuple(row) not in claimed][: self.seeds_per_campaign]
            if not take:                      # every seed already claimed
                continue
            claimed.update(tuple(row) for row in take)
            starts[label] = np.stack(take)
        return starts

    def _minimax_ratio(self, idx: np.ndarray) -> np.ndarray:
        """max_o(objective_o / ref_o) per design — <1 means A100-superior.
        One fused prefetch scores a whole seed class (cache-shared with the
        campaigns that will start there)."""
        self.ee.prefetch(idx)
        ratios = np.empty(idx.shape[0])
        for i, row in enumerate(idx):
            rep_t, rep_p = self.ee.reports(row)
            y = np.array([rep_t.latency, rep_p.latency, rep_t.area])
            ratios[i] = float((y / self.ref_point).max())
        return ratios

    # ------------------------------------------------------------------
    def run(self, budget: int = 20, *,
            seeds: Optional[Mapping[str, np.ndarray]] = None,
            sweep: Optional["SweepResult"] = None,
            include_reference: bool = True,
            step_callback: Optional[Callable[[StepRecord, Sample], None]] = None
            ) -> CampaignSetResult:
        """Run all campaigns round-robin under one shared `budget`.

        Seeds come from ``seeds`` (a {label -> (k, n_params)} mapping),
        from ``sweep.stall_seeds()``, or default to the reference start
        only.  Each round fuses every live campaign's candidate into ONE
        batched dispatch.
        """
        d0 = getattr(self.evaluator, "dispatches", 0)
        if seeds is None:
            seeds = sweep.stall_seeds(self.space) if sweep is not None else {}
        starts = self.seed_starts(seeds, include_reference=include_reference)
        if not starts:
            raise ValueError("no campaigns to run: every seed class was "
                             "empty and include_reference=False")

        shared_visited: set = set()
        campaigns: Dict[str, Campaign] = {
            label: self.dse.start(init, visited=shared_visited, label=label)
            for label, init in starts.items()
        }
        merged = TrajectoryMemory(self.ref_point)
        telemetry: List[StepRecord] = []
        best = np.full(len(self.ref_point), np.inf)
        budget_stop = self.ee.evals + int(budget)
        rounds = 0
        prev_phv = 0.0
        early_stopped: Dict[str, int] = {}
        # adaptive policy state: regret-slope EWMA per campaign
        # (optimistic init 1.0 — every campaign starts fully funded) and
        # the carrying deficit credit for allocate_slots
        gain_alpha = 1.0 / (1.0 + self.patience)
        gain_ewma: Dict[str, float] = {label: 1.0 for label in campaigns}
        credit: Dict[str, float] = {label: 0.0 for label in campaigns}

        order = list(campaigns)
        tr = self.tracer
        with tr.span("campaign.run", budget=int(budget),
                     campaigns=len(campaigns)):
            while self.ee.evals < budget_stop:
                rounds += 1
                self._c_rounds.inc()
                room = budget_stop - self.ee.evals
                if self.policy == "adaptive":
                    # budget flows to falling-regret campaigns continuously:
                    # weighted-deficit allocation over floor + gain EWMA
                    weights = {lb: ADAPTIVE_WEIGHT_FLOOR + gain_ewma[lb]
                               for lb in order}
                    chosen = allocate_slots(order, credit, weights,
                                            min(room, len(order)))
                else:
                    chosen = order[:room]
                with tr.span("campaign.round", round_i=rounds,
                             slots=len(chosen)):
                    proposals = []
                    for label in chosen:
                        camp = campaigns[label]
                        idx, directive = camp.propose()
                        proposals.append((label, camp, idx, directive))
                    # ---- the fused round dispatch: K candidates, ONE
                    # dispatch.  With a plain evaluator the RUNNER batches
                    # (one prefetched EvalRequest); with an EvalService each
                    # campaign submits its own request and the SERVICE's
                    # coalescing tick fuses them.
                    if self._service is not None:
                        self._service_round(proposals)
                    else:
                        self.ee.prefetch(np.stack([p[2]
                                                   for p in proposals]))
                    for label, camp, idx, directive in proposals:
                        sample = self.ee.evaluate(idx, step=camp.step,
                                                  directive=directive)
                        camp.observe(sample)
                        merged.add(sample)
                        self._c_obs.inc(campaign=label)
                        improved = bool((sample.objectives < best).any())
                        best = np.minimum(best, sample.objectives)
                        record = StepRecord(
                            eval_i=self.ee.evals, round_i=rounds,
                            campaign=label, step=camp.step,
                            objectives=[float(v)
                                        for v in sample.objectives],
                            phv=merged.phv(),
                        )
                        gained = (1.0 if (record.phv > prev_phv or improved)
                                  else 0.0)
                        gain_ewma[label] += gain_alpha * (gained
                                                          - gain_ewma[label])
                        prev_phv = record.phv
                        if self.oracle is not None:
                            record.regret = [
                                float(v)
                                for v in self.oracle.regret(best[None, :])]
                            record.phv_frac = self.oracle.normalized_phv(
                                record.phv, self.ref_point)
                        telemetry.append(record)
                        if step_callback is not None:
                            step_callback(record, sample)
                # round-robin fairness: rotate which campaign is clipped
                # (uniform) or wins credit ties (adaptive) when the
                # remaining budget no longer covers every live campaign
                order = order[1:] + order[:1]

        return CampaignSetResult(
            per_campaign={label: c.result() for label, c in campaigns.items()},
            samples=list(merged.samples),
            phv=merged.phv(),
            superior_count=merged.superior_count(),
            pareto=merged.pareto(),
            telemetry=telemetry,
            dispatches=getattr(self.evaluator, "dispatches", 0) - d0,
            rounds=rounds,
            policy=self.policy,
            early_stopped=early_stopped,
            budget_weights=({lb: round(ADAPTIVE_WEIGHT_FLOOR + g, 4)
                             for lb, g in gain_ewma.items()}
                            if self.policy == "adaptive" else None),
            service_counters=(dict(self._service.telemetry(),
                                   campaign_resubmits=self.service_resubmits)
                              if self._service is not None else None),
            stall_histogram=dict(self.ee.stall_counts),
            rule_audit=self.dse.rule_audit().as_dict(),
            metrics=self.metrics.snapshot(),
        )
