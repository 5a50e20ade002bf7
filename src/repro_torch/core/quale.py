"""Qualitative Engine (QualE): structural Influence-Map acquisition.

The paper's QualE has an LLM statically analyse the simulator codebase and
emit a map {resource parameter -> influenced PPA metrics / stall classes}.
The analogue of "parsing the simulator" is *probing the analytic model's
dependency structure*: perturb each parameter across a set of probe designs
and record which outputs (TTFT, TPOT, area, per-stall-class times) respond.
This discovers, e.g., that vector throughput depends on core/sublane/vector
width but NOT on the systolic array — the exact example in §3.2.1.

The derived map is the structural half of the Architectural Heuristic
Knowledge (AHK); the Quantitative Engine fills in magnitudes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.analysis.influence import extract_influence_graph
from repro_torch.perfmodel.critical_path import STALL_CLASSES
from repro_torch.perfmodel.designspace import DesignSpace
from repro_torch.perfmodel.evaluator import EvalRequest, as_evaluator

METRICS = ("ttft", "tpot", "area")


@dataclasses.dataclass
class InfluenceMap:
    """param -> metrics it influences; param -> stall classes it relieves."""
    metric_edges: Dict[str, Set[str]]
    stall_edges: Dict[str, Set[str]]

    def params_for_stall(self, stall: str) -> List[str]:
        return sorted(p for p, s in self.stall_edges.items() if stall in s)

    def as_prompt(self) -> str:
        lines = ["Influence map (param -> affected metrics | relieved stalls):"]
        for p in sorted(self.metric_edges):
            lines.append(f"  {p}: metrics={sorted(self.metric_edges[p])}"
                         f" stalls={sorted(self.stall_edges.get(p, ()))}")
        return "\n".join(lines)


def derive_influence_map(evaluator,
                         space: Optional[DesignSpace] = None,
                         n_probes: int = 8, seed: int = 0,
                         rel_eps: float = 1e-4) -> InfluenceMap:
    """Probe the evaluator at `n_probes` random designs, sweeping each
    parameter over its full choice range, and record which outputs move.

    One fused stalls-detail dispatch per parameter covers every workload's
    latency, the per-class stall times AND area.
    """
    ev = as_evaluator(evaluator)
    space = space or ev.space
    rng = np.random.default_rng(seed)
    probes = space.sample(rng, n_probes)
    metric_edges: Dict[str, Set[str]] = {p: set() for p in space.names}
    stall_edges: Dict[str, Set[str]] = {p: set() for p in space.names}

    for pi, pname in enumerate(space.names):
        card = int(space.cardinalities[pi])
        # batch: every probe x every choice of this param
        batch = np.repeat(probes, card, axis=0)
        batch[:, pi] = np.tile(np.arange(card, dtype=np.int32), n_probes)
        rep = ev.evaluate(EvalRequest(batch, detail="stalls"))
        for mname in ev.workloads:
            lat = rep.latency[mname].reshape(n_probes, card)
            stall = rep.stall[mname].reshape(n_probes, card, 4)
            if _responds(lat, rel_eps):
                metric_edges[pname].add(mname)
            for ci, cname in enumerate(STALL_CLASSES):
                if _responds(stall[..., ci], rel_eps):
                    stall_edges[pname].add(cname)
        area = rep.area.reshape(n_probes, card)
        if _responds(area, rel_eps):
            metric_edges[pname].add("area")

    return InfluenceMap(metric_edges=metric_edges, stall_edges=stall_edges)


def _responds(vals: np.ndarray, rel_eps: float) -> bool:
    """True if sweeping the parameter moves the output anywhere."""
    span = vals.max(axis=-1) - vals.min(axis=-1)
    scale = np.maximum(np.abs(vals).max(axis=-1), 1e-30)
    return bool((span / scale > rel_eps).any())


def static_influence_map() -> InfluenceMap:
    """The SAME InfluenceMap contract, acquired WITHOUT executing the model:
    built from the influence graph extracted from the perfmodel source
    (:mod:`repro_torch.analysis.influence`; the paper's literal 'LLM
    statically analyses the simulator codebase' path).  Zero evaluator
    dispatches — usable as ``LuminaDSE(imap=static_influence_map())`` — and
    the probe map cross-validates it (:meth:`LuminaDSE.rule_audit`)."""
    graph = extract_influence_graph()
    metric_edges = {p: set(ms) for p, ms in graph.param_metrics().items()}
    stall_edges: Dict[str, Set[str]] = {p: set() for p in graph.params}
    for stall in graph.stalls:
        for p in graph.params_for_stall(stall):
            stall_edges[p].add(stall)
    return InfluenceMap(metric_edges=metric_edges, stall_edges=stall_edges)
