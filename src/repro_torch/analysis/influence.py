"""The influence graph: a reader of the artifact the reference extracts from
its perfmodel source, and its cross-validation against the probe map.

The reference's extractor (an interprocedural dataflow analysis of the
perfmodel source) emits a typed :class:`InfluenceGraph`

    design parameter -> derived hardware quantity -> roofline op-term
                     -> stall class -> PPA metric

with ``file:line`` provenance on every edge, and checks it in as
``influence_graph.json``.  The port keeps its own copy of that artifact
beside this module and reads it here; the extractor itself is not ported.
The port's perfmodel computes the same functions as the reference's, so
the graph's architecture (its :meth:`InfluenceGraph.signature`) holds for
both; the provenance sites name the reference's source lines.

:func:`cross_validate` compares the graph with a probe-based
:class:`~repro_torch.core.quale.InfluenceMap` and classifies the
disagreements for the rule auto-correction telemetry.
"""
from __future__ import annotations

import dataclasses
import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

ARTIFACT_PATH = Path(__file__).with_name("influence_graph.json")

# edge kinds, in pipeline order
EK_PARAM_DERIVED = "param->derived"
EK_DERIVED_TERM = "derived->term"
EK_TERM_STALL = "term->stall"
EK_DERIVED_STALL = "derived->stall"
EK_TERM_METRIC = "term->metric"
EK_DERIVED_METRIC = "derived->metric"
EK_STALL_PRIMARY = "stall->primary"


@dataclasses.dataclass(frozen=True)
class Edge:
    kind: str
    src: str
    dst: str
    guards: Tuple[str, ...] = ()
    sites: Tuple[str, ...] = ()

    def as_dict(self) -> dict:
        return {"kind": self.kind, "src": self.src, "dst": self.dst,
                "guards": list(self.guards), "sites": list(self.sites)}


@dataclasses.dataclass
class InfluenceGraph:
    """The extracted param -> derived -> term -> stall -> metric graph."""

    params: Tuple[str, ...]
    derived: Tuple[str, ...]
    terms: Tuple[str, ...]
    stalls: Tuple[str, ...]
    metrics: Tuple[str, ...]
    edges: Tuple[Edge, ...]
    guard_kinds: Dict[str, str]     # guard local -> workload op-kind name
    primary: Dict[str, str]         # stall class -> primary relief param

    # -- queries -----------------------------------------------------------

    def edges_of(self, kind: str) -> List[Edge]:
        return [e for e in self.edges if e.kind == kind]

    def param_derived(self) -> Dict[str, Set[str]]:
        out: Dict[str, Set[str]] = {p: set() for p in self.params}
        for e in self.edges_of(EK_PARAM_DERIVED):
            out[e.src].add(e.dst)
        return out

    def derived_stalls(self) -> Dict[str, Set[str]]:
        out: Dict[str, Set[str]] = {d: set() for d in self.derived}
        for e in self.edges_of(EK_DERIVED_STALL):
            out[e.src].add(e.dst)
        return out

    def stall_params(self) -> Dict[str, Set[str]]:
        """stall class -> every parameter with a structural path into it."""
        ds = self.derived_stalls()
        out: Dict[str, Set[str]] = {c: set() for c in self.stalls}
        for p, dkeys in self.param_derived().items():
            for d in dkeys:
                for c in ds.get(d, ()):
                    out[c].add(p)
        return out

    def params_for_stall(self, stall: str) -> List[str]:
        return sorted(self.stall_params().get(stall, ()))

    def derived_to_metrics(self) -> Dict[str, Set[str]]:
        """derived quantity -> PPA metrics it feeds."""
        latency_metrics = {e.dst for e in self.edges_of(EK_TERM_METRIC)}
        out: Dict[str, Set[str]] = {}
        for e in self.edges_of(EK_DERIVED_TERM):
            out.setdefault(e.src, set()).update(latency_metrics)
        for e in self.edges_of(EK_DERIVED_METRIC):
            out.setdefault(e.src, set()).add(e.dst)
        return out

    def param_metrics(self) -> Dict[str, Set[str]]:
        """param -> PPA metrics, via param->derived composed with
        derived->metrics (the full-surface source-derived influence map)."""
        d2m = self.derived_to_metrics()
        out: Dict[str, Set[str]] = {p: set() for p in self.params}
        for p, dkeys in self.param_derived().items():
            for d in dkeys:
                out[p].update(d2m.get(d, ()))
        return out

    def primary_resources(self) -> Dict[str, str]:
        return dict(self.primary)

    def provenance(self, kind: str, src: str, dst: str) -> Tuple[str, ...]:
        for e in self.edges:
            if (e.kind, e.src, e.dst) == (kind, src, dst):
                return e.sites
        return ()

    # -- rendering / serialization ----------------------------------------

    def render_param(self, param: str) -> str:
        """Human-readable influence chain for one parameter."""
        if param not in self.params:
            raise KeyError(param)
        lines = [f"{param}"]
        dterm: Dict[str, List[Edge]] = {}
        for e in self.edges_of(EK_DERIVED_TERM):
            dterm.setdefault(e.src, []).append(e)
        dstall = self.derived_stalls()
        lat = sorted({e.dst for e in self.edges_of(EK_TERM_METRIC)})
        for e in self.edges_of(EK_PARAM_DERIVED):
            if e.src != param:
                continue
            lines.append(f"  -> {e.dst}  @ {e.sites[0]}")
            for te in dterm.get(e.dst, ()):
                g = f" [{','.join(te.guards)}]" if te.guards else ""
                cls = sorted(dstall.get(e.dst, ()))
                lines.append(f"     -> {te.dst}{g}  @ {te.sites[0]}"
                             f"  -> {'/'.join(cls)} -> {','.join(lat)}")
            for me in self.edges_of(EK_DERIVED_METRIC):
                if me.src == e.dst:
                    lines.append(f"     -> metric {me.dst}  @ {me.sites[0]}")
        prim = [c for c, p in sorted(self.primary.items()) if p == param]
        if prim:
            lines.append(f"  primary relief for: {', '.join(prim)}")
        return "\n".join(lines)

    def as_json(self) -> dict:
        return {
            "version": 1,
            "params": list(self.params),
            "derived": list(self.derived),
            "terms": list(self.terms),
            "stalls": list(self.stalls),
            "metrics": list(self.metrics),
            "guard_kinds": dict(sorted(self.guard_kinds.items())),
            "primary": dict(sorted(self.primary.items())),
            "edges": [e.as_dict() for e in self.edges],
        }

    def signature(self) -> dict:
        """Everything architectural, nothing positional: provenance lines
        may drift with formatting-only refactors of the source."""
        d = self.as_json()
        d["edges"] = sorted([e["kind"], e["src"], e["dst"], e["guards"]]
                            for e in d["edges"])
        return d

    @classmethod
    def from_json(cls, d: dict) -> "InfluenceGraph":
        return cls(
            params=tuple(d["params"]), derived=tuple(d["derived"]),
            terms=tuple(d["terms"]), stalls=tuple(d["stalls"]),
            metrics=tuple(d["metrics"]),
            edges=tuple(Edge(e["kind"], e["src"], e["dst"],
                             tuple(e["guards"]), tuple(e["sites"]))
                        for e in d["edges"]),
            guard_kinds=dict(d["guard_kinds"]),
            primary=dict(d["primary"]))


def load_artifact(path: Optional[Path] = None) -> InfluenceGraph:
    p = path or ARTIFACT_PATH
    return InfluenceGraph.from_json(json.loads(p.read_text()))


@lru_cache(maxsize=1)
def extract_influence_graph() -> InfluenceGraph:
    """The influence graph of the perfmodel (the port's copy of the
    reference's extracted artifact, loaded once)."""
    return load_artifact()


def primary_resources() -> Dict[str, str]:
    """stall class -> the parameter that most directly relieves it (the AHK
    primary edges of the graph)."""
    return extract_influence_graph().primary_resources()


# --------------------------------------------------------------------------
# cross-validation against the probe-based QualE map
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RuleAudit:
    """Source-vs-probe disagreement report (the measurable half of the
    paper's rule auto-correction loop).

    * ``metric_probe_only`` non-empty means the extraction MISSED real
      dataflow — an extractor bug worth failing on.
    * ``metric_source_only`` is benign over-approximation (the probes did
      not excite that edge at the sampled designs).
    * ``stall_probe_only`` is *attribution coupling*: perturbing a param
      moves which ops dominate another class without structurally feeding
      it (e.g. growing ``sa_dim`` shifts memory-bound attribution).
    * ``stall_source_only`` is a structural path the probes never saw.
    """

    metric_agree: Dict[str, List[str]]
    metric_probe_only: Dict[str, List[str]]
    metric_source_only: Dict[str, List[str]]
    stall_agree: Dict[str, List[str]]
    stall_probe_only: Dict[str, List[str]]
    stall_source_only: Dict[str, List[str]]

    def counts(self) -> Dict[str, int]:
        return {f: sum(len(v) for v in getattr(self, f).values())
                for f in ("metric_agree", "metric_probe_only",
                          "metric_source_only", "stall_agree",
                          "stall_probe_only", "stall_source_only")}

    def corrections(self) -> List[str]:
        """Telemetry lines for the rule auto-correction loop."""
        out = []
        for p, ms in sorted(self.metric_probe_only.items()):
            if ms:
                out.append(f"EXTRACTION-GAP {p}: probes move {ms} but no "
                           f"source path found")
        for p, cs in sorted(self.stall_probe_only.items()):
            if cs:
                out.append(f"attribution-coupling {p}: probes move stall "
                           f"{cs} without a structural path")
        for p, cs in sorted(self.stall_source_only.items()):
            if cs:
                out.append(f"unexercised {p}: structural path to stall "
                           f"{cs} not excited by probes")
        return out

    def as_dict(self) -> dict:
        d = {f: {k: list(v) for k, v in getattr(self, f).items() if v}
             for f in ("metric_agree", "metric_probe_only",
                       "metric_source_only", "stall_agree",
                       "stall_probe_only", "stall_source_only")}
        d["counts"] = self.counts()
        return d


def _diff(src: Dict[str, Set[str]], probed: Dict[str, Set[str]],
          params) -> Tuple[Dict[str, List[str]], Dict[str, List[str]],
                           Dict[str, List[str]]]:
    agree, ponly, sonly = {}, {}, {}
    for p in params:
        s, pr = src.get(p, set()), probed.get(p, set())
        agree[p] = sorted(s & pr)
        ponly[p] = sorted(pr - s)
        sonly[p] = sorted(s - pr)
    return agree, ponly, sonly


def cross_validate(graph: InfluenceGraph, probed) -> RuleAudit:
    """Compare the source-extracted graph against a probe-based
    :class:`repro_torch.core.quale.InfluenceMap`."""
    src_m = graph.param_metrics()
    src_s: Dict[str, Set[str]] = {p: set() for p in graph.params}
    for c, ps in graph.stall_params().items():
        for p in ps:
            src_s[p].add(c)
    ma, mp, ms = _diff(src_m, probed.metric_edges, graph.params)
    sa, sp, ss = _diff(src_s, probed.stall_edges, graph.params)
    return RuleAudit(metric_agree=ma, metric_probe_only=mp,
                     metric_source_only=ms, stall_agree=sa,
                     stall_probe_only=sp, stall_source_only=ss)
