"""`repro_torch.analysis`: static analysis over the port's own source code.

The port's counterpart of ``repro.analysis``.  Two passes share one
AST/dataflow core (:mod:`.dataflow`):

* **Knowledge extraction** (:mod:`.influence`) — an interprocedural,
  assignment-level dataflow analysis of the port's performance-model
  source (``perfmodel/hardware.py``, ``roofline.py``, ``workload.py``,
  ``designspace.py``, ``critical_path.py``) that emits a typed
  :class:`~repro_torch.analysis.influence.InfluenceGraph`: design
  parameter → derived hardware quantity → roofline op-term → stall class →
  PPA metric, every edge carrying ``file:line`` provenance.  The AHK
  primary stall→parameter edges consumed by
  :class:`~repro_torch.core.llm.RuleOracle` and
  :class:`~repro_torch.core.strategy.StrategyEngine` are *derived* from
  this graph.  ``python -m repro_torch.analysis.extract --check`` holds the
  extraction to the checked-in artifact (the reference's graph).

* **Invariant linter** (:mod:`.lint`) — the reference's AST checks
  (shared mutables written outside a held lock in
  ``distributed/``/``serve/``, futures swallowed on exception paths,
  thread/timer/executor leaks, mutable default args, jit hazards, host
  syncs in hot loops, ad-hoc telemetry counters, pickle outside the
  codec).  ``python -m repro_torch.analysis.lint --baseline
  src/repro_torch/analysis/lint-baseline.json`` fails only on *new*
  findings.
"""
from repro_torch.analysis.influence import (InfluenceGraph, RuleAudit,
                                            cross_validate,
                                            derive_influence_map_from_source,
                                            derived_to_metrics,
                                            extract_influence_graph,
                                            primary_resources)

__all__ = [
    "InfluenceGraph", "RuleAudit", "cross_validate",
    "derive_influence_map_from_source", "derived_to_metrics",
    "extract_influence_graph", "primary_resources",
    "Finding", "lint_paths", "load_baseline",
]

_LINT_NAMES = ("Finding", "lint_paths", "load_baseline")


def __getattr__(name):
    # lazy so `python -m repro_torch.analysis.lint` doesn't double-import lint
    if name in _LINT_NAMES:
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(name)
