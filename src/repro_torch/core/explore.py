"""Exploration Engine (EE): directive -> simulator evaluation -> sample.

The EE is the integration layer (§3.3.2): it serializes the SE's directive
into the simulator's design format (choice-index vector), issues the
evaluation through the unified :class:`~repro_torch.perfmodel.evaluator.
Evaluator` contract, and returns the structured sample for the Trajectory
Memory.

One DSE step costs exactly ONE fused dispatch: the evaluator computes both
latency objectives and stall attribution together, and each design's
:class:`~repro_torch.perfmodel.evaluator.PPAReport` row lands in a
:class:`~repro_torch.perfmodel.evaluator.RowCache` so follow-up
``reports()`` reads (the SE re-reading the current base design) are free.
:meth:`ExplorationEngine.prefetch` extends the same contract to many designs
at once: the candidate sets of K parallel campaigns are fused into ONE
batched dispatch per round.

An evaluator that carries its own ``row_cache`` (a shared service) lends
the engine that cache; otherwise the engine keeps a private bounded
``RowCache`` with the same eviction-aware LRU semantics.

``workloads=`` selects which (prefill, decode) pair of a multi-workload
evaluator drives this engine.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.memory import Sample
from repro_torch.core.strategy import Directive
from repro_torch.perfmodel.critical_path import StallReport
from repro_torch.perfmodel.evaluator import (EvalRequest, Evaluator,
                                             PPAReport, RowCache,
                                             as_evaluator)

_CACHE_CAP = 4096        # evaluated-design report rows kept per engine (LRU)

ReportPair = Tuple[StallReport, StallReport]


class ExplorationEngine:
    """Wraps an :class:`~repro_torch.perfmodel.evaluator.Evaluator` as the
    evaluation backend of one or many DSE campaigns.

    ``evals`` counts simulator invocations — the sampling budget shared by
    every campaign driving this engine.
    """

    def __init__(self, evaluator: Evaluator,
                 workloads: Optional[Tuple[str, str]] = None,
                 cache: Optional[RowCache] = None):
        self.evaluator = as_evaluator(evaluator)
        if workloads is None:
            if len(self.evaluator.workloads) < 2:
                raise ValueError("the DSE loop needs a two-workload "
                                 "evaluator (prefill + decode)")
            workloads = tuple(self.evaluator.workloads[:2])
        else:
            workloads = tuple(workloads)
            if len(workloads) != 2:
                raise ValueError("workloads must be a (prefill, decode) pair")
            unknown = set(workloads) - set(self.evaluator.workloads)
            if unknown:
                raise KeyError(f"unknown workloads {sorted(unknown)}; "
                               f"have {self.evaluator.workloads}")
        self._wt, self._wp = workloads
        self.evals = 0        # simulator invocations (the sampling budget)
        # dominant-stall histogram over budgeted observations: which AHK
        # rules the SE will have fired; campaign telemetry snapshots it
        self.stall_counts: dict = {}
        # ONE cache: the service's shared cross-client row cache when the
        # evaluator is a service, a private same-semantics one otherwise
        self._cache: RowCache = (
            cache if cache is not None
            else getattr(self.evaluator, "row_cache", None)
            or RowCache(_CACHE_CAP))
        # per-objective latency scales for the dominant-stall merge; the DSE
        # loop sets this to its reference point so TTFT (whole prefill, ms)
        # and TPOT (per token, us) stalls compare on their own scales
        self.ref_point: Optional[np.ndarray] = None

    # legacy attribute access (a few benches/teardowns poke the models)
    @property
    def ttft_model(self):
        return self.evaluator.models[self._wt]

    @property
    def tpot_model(self):
        return self.evaluator.models[self._wp]

    @property
    def workload_pair(self) -> Tuple[str, str]:
        return (self._wt, self._wp)

    # -- shared row cache ----------------------------------------------
    def _cached_row(self, key: bytes) -> Optional[PPAReport]:
        return self._cache.get(key, "stalls", (self._wt, self._wp))

    def _report_pair(self, idx: np.ndarray) -> ReportPair:
        """Both workloads' critical-path reports from one fused dispatch."""
        idx = np.asarray(idx, dtype=np.int32)
        key = RowCache.key(idx)
        row = self._cached_row(key)
        if row is None:
            rep = self.evaluator.evaluate(
                EvalRequest(idx, detail="stalls",
                            workloads=self._request_names()))
            row = rep.row(0)
            self._cache.put(key, "stalls", row)
        return (row.stall_report(self._wt), row.stall_report(self._wp))

    def _request_names(self) -> Optional[Tuple[str, ...]]:
        """A service evaluates (and caches) its FULL workload set per tick
        anyway — request it all so the shared rows serve every client; a
        plain evaluator only pays for this engine's pair."""
        if getattr(self.evaluator, "row_cache", None) is self._cache \
                and self._cache is not None:
            return None
        return (self._wt, self._wp)

    def prefetch(self, idx_batch: np.ndarray) -> int:
        """Evaluate many designs in ONE fused batched dispatch.

        Fills the row cache so the follow-up per-design
        :meth:`evaluate`/:meth:`reports` calls are dispatch-free — the
        batched multi-design path behind multi-campaign rounds.  Designs
        already cached are not re-evaluated.  Returns the number of designs
        actually dispatched.
        """
        batch = np.atleast_2d(np.asarray(idx_batch, dtype=np.int32))
        fresh_keys: List[bytes] = []
        fresh_rows: List[np.ndarray] = []
        seen = set()
        for row in batch:
            key = RowCache.key(row)
            if key in seen or self._cached_row(key) is not None:
                continue
            seen.add(key)
            fresh_keys.append(key)
            fresh_rows.append(row)
        if not fresh_rows:
            return 0
        rep = self.evaluator.evaluate(
            EvalRequest(np.stack(fresh_rows), detail="stalls",
                        workloads=self._request_names()))
        for i, key in enumerate(fresh_keys):
            self._cache.put(key, "stalls", rep.row(i))
        return len(fresh_rows)

    # ------------------------------------------------------------------
    def evaluate(self, idx: np.ndarray, step: int,
                 directive: Optional[Directive] = None) -> Sample:
        idx = np.asarray(idx, dtype=np.int32)
        rep_t, rep_p = self._report_pair(idx)
        self.evals += 1
        # the design's dominant stall = the larger ABSOLUTE stall across the
        # two latency objectives (what the SE will attack next)
        dom = self._merge(rep_t, rep_p)
        self.stall_counts[dom.dominant] = \
            self.stall_counts.get(dom.dominant, 0) + 1
        return Sample(
            step=step, idx=idx.copy(),
            ttft=rep_t.latency, tpot=rep_p.latency, area=rep_t.area,
            dominant_stall=dom.dominant,
            directive=directive.as_dict() if directive else None,
        )

    def reports(self, idx: np.ndarray) -> ReportPair:
        """Critical-path reports for both latency objectives (cached)."""
        return self._report_pair(idx)

    def _merge(self, rep_t: StallReport, rep_p: StallReport) -> StallReport:
        """Latency-weighted dominant-stall merge: the report whose dominant
        stall burns more time — each objective measured on its OWN latency
        scale (``ref_point`` when the loop provides one) — wins.

        Comparing bare ``dominant_fraction``s (or short-circuiting on a raw
        latency ratio, as the old ``ttft >= 50 * tpot`` bypass did)
        misattributes TPOT-bound designs whenever TTFT is merely large;
        comparing raw seconds would bury the per-token TPOT objective under
        the whole-prefill TTFT for good — the reference scales make the two
        commensurable."""
        st, sp = ((float(self.ref_point[0]), float(self.ref_point[1]))
                  if self.ref_point is not None else (1.0, 1.0))
        w_t = rep_t.dominant_fraction * rep_t.latency / st
        w_p = rep_p.dominant_fraction * rep_p.latency / sp
        return rep_t if w_t >= w_p else rep_p
