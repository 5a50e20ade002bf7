"""Interprocedural influence-graph extraction from the perfmodel SOURCE.

The port's counterpart of ``repro.analysis.influence``, run over the
port's own perfmodel.  The literal reproduction of the paper's §3.2.1
("the LLM statically analyses the simulator codebase and emits
architectural heuristic knowledge"): an assignment-level, guard-aware,
interprocedural dataflow analysis over ``repro_torch.perfmodel.{hardware,
roofline,workload,designspace,critical_path}`` that emits a typed
:class:`InfluenceGraph`

    design parameter -> derived hardware quantity -> roofline op-term
                     -> stall class -> PPA metric

with ``file:line`` provenance on every edge.  Nothing architectural is
hand-coded here: the analysis anchors only on *where the model lives*
(function names listed in ``_ANCHORS``) and derives *what it says* —
which guards split op kinds, which term each stall class attributes to,
which derived key is each class's peak throughput, and therefore which
parameter is the AHK "primary relief" for each stall class:

* **term discovery** — the op-time terms are exactly the non-guard keys
  `_dominant_class` reads off the `_op_terms` output dict;
* **class attribution** — `_dominant_class`'s nested ``where`` tree is
  decomposed into (guard-chain -> class-constant) leaves; a class's term
  is the common left operand of its positive dominance comparisons
  (MEMORY falls out by elimination), and its ``is_*`` guards become
  branch constraints;
* **primary resource** — a class's *peak key* is the first derived-hw key
  found in division-denominator position walking its term's compatible
  branches outward (breadth-first through locals and callees: the
  shallowest thing the term is divided by IS the throughput being
  saturated); the primary parameter is the unique parameter that reaches
  the peak key while influencing no other stall class.

Two torch idioms of the port's perfmodel have no counterpart in the
reference's ``jnp`` source, and the extractor reads them for what they
are: a cast ``<where-tree>.to(...)`` is the tree it casts (``_branches``
peels it), and a tensor's metadata (``.device``, ``.dtype``, ``.shape``,
``.ndim``: where an op table is placed) carries no value into a term
(``_key_uses`` and ``_peak_keys`` read no key under it).

`RuleOracle` / `StrategyEngine` consume :func:`primary_resources`;
:func:`cross_validate` checks the graph against the probe-based QualE map
(`repro_torch.core.quale.derive_influence_map`) and classifies
disagreements for the rule auto-correction telemetry.  Any unanticipated
source shape raises :class:`~repro_torch.analysis.dataflow.AnalysisError`
so ``python -m repro_torch.analysis.extract --check`` fails loudly instead
of shipping a silently wrong graph.

The checked-in ``influence_graph.json`` beside this module is the
reference's artifact (its sites name the reference's lines); it is read
by :func:`load_artifact`, and ``extract --check`` holds the port's
extraction to its :meth:`InfluenceGraph.signature`, which carries no line.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.dataflow import (AnalysisError, FunctionInfo,
                                           ModuleIndex, Site, bind_args,
                                           callee_parts, expr_reads)

GuardAtom = Tuple[str, bool]
Guards = FrozenSet[GuardAtom]

ARTIFACT_PATH = Path(__file__).with_name("influence_graph.json")

# Where the model lives (not what it says): the only hand-maintained part.
_ANCHORS = {
    "hardware": ("repro_torch.perfmodel.hardware", "derive_hardware"),
    "terms": ("repro_torch.perfmodel.roofline", "RooflineModel._op_terms"),
    "dominant": ("repro_torch.perfmodel.roofline", "_dominant_class"),
    "batch": ("repro_torch.perfmodel.roofline",
              "RooflineModel._workload_batch"),
    "suite": ("repro_torch.perfmodel.workload", "paper_suite"),
}
_AREA_KEY = "area_mm2"
_AREA_METRIC = "area"
# tensor metadata: where a tensor lives and how it is laid out, never a
# value that flows into a term (``hwb["sa_dim"].device`` places an op table)
_METADATA_ATTRS = frozenset({"device", "dtype", "shape", "ndim"})


def _perfmodel_modules():
    from repro_torch.perfmodel import (critical_path, designspace, hardware,
                                       roofline, workload)
    return (hardware, roofline, workload, designspace, critical_path)


def _fn(idx: ModuleIndex, anchor: Tuple[str, str]) -> FunctionInfo:
    mod, qual = anchor
    minfo = idx.modules.get(mod)
    if minfo is None or qual not in minfo.functions:
        raise AnalysisError(f"anchor {mod}.{qual} not found in parsed source")
    return minfo.functions[qual]


# --------------------------------------------------------------------------
# guard-aware interprocedural key-read closure
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KeyUse:
    """One read of ``hw_dict["key"]`` reachable from an expression, with the
    guard chain (``where`` conditions) under which it is live."""

    key: str
    guards: Guards
    site: Site


def _guard_atom(cond: ast.expr) -> Optional[str]:
    if isinstance(cond, ast.Name):
        return cond.id
    if isinstance(cond, ast.Subscript) and \
            isinstance(cond.slice, ast.Constant) and \
            isinstance(cond.slice.value, str):
        return cond.slice.value
    return None


def _key_uses(idx: ModuleIndex, fn: FunctionInfo, expr: ast.expr,
              hw: FrozenSet[str], guards: Guards, seen: set) -> List[KeyUse]:
    """All hw-dict key reads reachable from ``expr``, through local
    assignments and into called functions whose arguments carry the dict."""
    out: List[KeyUse] = []

    def walk(e: ast.AST, g: Guards) -> None:
        if isinstance(e, ast.Call):
            base, name = callee_parts(e)
            if name == "where" and len(e.args) == 3:
                cond, a, b = e.args
                walk(cond, g)
                atom = _guard_atom(cond)
                ga = g | {(atom, True)} if atom else g
                gb = g | {(atom, False)} if atom else g
                walk(a, frozenset(ga))
                walk(b, frozenset(gb))
                return
            for arg in list(e.args) + [kw.value for kw in e.keywords]:
                walk(arg, g)
            if isinstance(e.func, ast.Attribute) and \
                    not isinstance(e.func.value, ast.Name):
                walk(e.func.value, g)
            callee = idx.resolve_function(fn, base, name) if name else None
            if callee is not None:
                binding = bind_args(callee, e)
                hwf = frozenset(f for f, a in binding.items()
                                if isinstance(a, ast.Name) and a.id in hw)
                tok = ("fn", callee.module, callee.qualname, hwf, g)
                if hwf and tok not in seen:
                    seen.add(tok)
                    for rexpr, _ in callee.returns:
                        out.extend(_key_uses(idx, callee, rexpr, hwf, g, seen))
            return
        if isinstance(e, ast.IfExp):
            walk(e.test, g)
            atom = _guard_atom(e.test)
            walk(e.body, frozenset(g | {(atom, True)}) if atom else g)
            walk(e.orelse, frozenset(g | {(atom, False)}) if atom else g)
            return
        if isinstance(e, ast.Subscript) and isinstance(e.value, ast.Name):
            sl = e.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                if e.value.id in hw:
                    out.append(KeyUse(sl.value, g, Site(fn.file, e.lineno)))
                else:
                    walk(e.value, g)
                return
            walk(e.value, g)
            walk(sl, g)
            return
        if isinstance(e, ast.Name):
            if e.id in hw:
                return
            tok = ("local", fn.module, fn.qualname, e.id, g)
            if e.id in fn.assigns and tok not in seen:
                seen.add(tok)
                for aexpr, _ in fn.assigns[e.id]:
                    walk(aexpr, g)
            return
        if isinstance(e, ast.Attribute):
            if e.attr not in _METADATA_ATTRS and \
                    not isinstance(e.value, ast.Name):
                walk(e.value, g)
            return
        for child in ast.iter_child_nodes(e):
            walk(child, g)

    walk(expr, guards)
    return out


# --------------------------------------------------------------------------
# where-tree decomposition (branches / leaves with guard chains)
# --------------------------------------------------------------------------

def _branches(idx: ModuleIndex, fn: FunctionInfo, expr: ast.expr,
              guards: Guards = frozenset(), expand_locals: bool = False,
              _depth: int = 0) -> List[Tuple[Guards, ast.expr]]:
    """Peel nested ``where(cond, a, b)`` calls into (guards, leaf) pairs.
    A cast ``<tree>.to(...)`` is peeled to the tree it casts.  With
    ``expand_locals``, a leaf that is a plain local name is expanded
    through its assignment (used on `_dominant_class`)."""
    if _depth > 16:
        raise AnalysisError(f"where-tree too deep in {fn.qualname}")
    if _is_cast(expr):
        return _branches(idx, fn, expr.func.value, guards, expand_locals,
                         _depth + 1)
    if isinstance(expr, ast.Call):
        _, name = callee_parts(expr)
        if name == "where" and len(expr.args) == 3:
            cond, a, b = expr.args
            atom = _guard_atom(cond)
            ga = frozenset(guards | {(atom, True)}) if atom else guards
            gb = frozenset(guards | {(atom, False)}) if atom else guards
            return (_branches(idx, fn, a, ga, expand_locals, _depth + 1) +
                    _branches(idx, fn, b, gb, expand_locals, _depth + 1))
    if expand_locals and isinstance(expr, ast.Name) and \
            expr.id in fn.assigns:
        exprs = fn.assigns[expr.id]
        if len(exprs) != 1:
            raise AnalysisError(
                f"{fn.qualname}: local {expr.id} assigned {len(exprs)} times;"
                " cannot decompose unambiguously")
        return _branches(idx, fn, exprs[0][0], guards, expand_locals,
                         _depth + 1)
    return [(guards, expr)]


def _is_cast(expr: ast.expr) -> bool:
    """``<expr>.to(...)`` on a computed value (not a module's ``to``)."""
    return isinstance(expr, ast.Call) and \
        isinstance(expr.func, ast.Attribute) and expr.func.attr == "to" and \
        not isinstance(expr.func.value, ast.Name)


def _contradicts(guards: Guards, constraint: Guards) -> bool:
    return any((n, not p) in guards for n, p in constraint)


def _compatible(guards: Guards, leaf_constraints: Sequence[Guards]) -> bool:
    """A branch is live for a class if its guards don't contradict the kind
    constraints of at least one of the class's attribution leaves."""
    if not leaf_constraints:
        return True
    return any(not _contradicts(guards, c) for c in leaf_constraints)


# --------------------------------------------------------------------------
# peak-key search: first denominator hw-key outward from a term branch
# --------------------------------------------------------------------------

def _peak_keys(idx: ModuleIndex,
               items: List[Tuple[FunctionInfo, ast.expr, FrozenSet[str], bool]],
               max_depth: int = 8) -> List[Tuple[str, Site]]:
    """Breadth-first search for hw-dict keys in division-denominator
    position, by levels of indirection (locals / callee returns).  The
    first level with any hit wins: the shallowest quantity a time term is
    divided by is the peak throughput that term saturates."""
    seen: set = set()
    for _ in range(max_depth):
        found: List[Tuple[str, Site]] = []
        nxt: List[Tuple[FunctionInfo, ast.expr, FrozenSet[str], bool]] = []

        def scan(fn: FunctionInfo, e: ast.AST, hw: FrozenSet[str],
                 den: bool) -> None:
            if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Div):
                scan(fn, e.left, hw, den)
                scan(fn, e.right, hw, True)
                return
            if isinstance(e, ast.Subscript) and \
                    isinstance(e.value, ast.Name) and \
                    isinstance(e.slice, ast.Constant) and \
                    isinstance(e.slice.value, str):
                if e.value.id in hw and den:
                    found.append((e.slice.value, Site(fn.file, e.lineno)))
                return
            if isinstance(e, ast.Name):
                tok = (fn.module, fn.qualname, e.id, den)
                if e.id in fn.assigns and tok not in seen:
                    seen.add(tok)
                    for aexpr, _ in fn.assigns[e.id]:
                        nxt.append((fn, aexpr, hw, den))
                return
            if isinstance(e, ast.Call):
                base, name = callee_parts(e)
                for arg in list(e.args) + [kw.value for kw in e.keywords]:
                    scan(fn, arg, hw, den)
                callee = idx.resolve_function(fn, base, name) if name else None
                if callee is not None:
                    binding = bind_args(callee, e)
                    hwf = frozenset(f for f, a in binding.items()
                                    if isinstance(a, ast.Name) and a.id in hw)
                    tok = (callee.module, callee.qualname, hwf, den)
                    if hwf and tok not in seen:
                        seen.add(tok)
                        for rexpr, _ in callee.returns:
                            nxt.append((callee, rexpr, hwf, den))
                return
            if isinstance(e, ast.Attribute):
                if e.attr not in _METADATA_ATTRS and \
                        not isinstance(e.value, ast.Name):
                    scan(fn, e.value, hw, den)
                return
            for child in ast.iter_child_nodes(e):
                scan(fn, child, hw, den)

        for fn, e, hw, den in items:
            scan(fn, e, hw, den)
        if found:
            return found
        if not nxt:
            break
        items = nxt
    return []


# --------------------------------------------------------------------------
# typed graph
# --------------------------------------------------------------------------

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


def _guard_strs(guards: Guards) -> Tuple[str, ...]:
    return tuple(sorted(n if p else f"!{n}" for n, p in guards))


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
        """derived quantity -> PPA metrics it feeds (the extracted
        replacement for the old hand-coded ``DERIVED_TO_METRICS``)."""
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
        """Human-readable influence chain for one parameter (README/CLI)."""
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
        """Everything architectural, nothing positional: the structure CI
        guards (``extract --check``).  Provenance lines may drift with
        formatting-only refactors without failing the build."""
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


# --------------------------------------------------------------------------
# extraction
# --------------------------------------------------------------------------

def _add_edge(acc: Dict[tuple, Set[str]], kind: str, src: str, dst: str,
              guards: Tuple[str, ...], sites: Sequence[Site]) -> None:
    acc.setdefault((kind, src, dst, guards), set()).update(
        str(s) for s in sites)


def _extract(idx: ModuleIndex) -> InfluenceGraph:
    from repro_torch.perfmodel.critical_path import STALL_CLASSES
    from repro_torch.perfmodel.designspace import PARAM_NAMES

    hw_fn = _fn(idx, _ANCHORS["hardware"])
    terms_fn = _fn(idx, _ANCHORS["terms"])
    dom_fn = _fn(idx, _ANCHORS["dominant"])
    batch_fn = _fn(idx, _ANCHORS["batch"])
    suite_fn = _fn(idx, _ANCHORS["suite"])
    acc: Dict[tuple, Set[str]] = {}

    # ---- param -> derived: derive_hardware's dict-literal return ---------
    if len(hw_fn.params) != 1:
        raise AnalysisError(f"{hw_fn.qualname}: expected 1 formal")
    vname = hw_fn.params[0]
    if not hw_fn.dict_returns:
        raise AnalysisError(f"{hw_fn.qualname}: no dict-literal return")
    derived = tuple(hw_fn.dict_returns)
    params = tuple(PARAM_NAMES)
    for dkey, (vexpr, _) in hw_fn.dict_returns.items():
        uses = _key_uses(idx, hw_fn, vexpr, frozenset([vname]),
                         frozenset(), set())
        if not uses:
            raise AnalysisError(
                f"derived key {dkey!r} reads no design parameter")
        for u in uses:
            if u.key not in params:
                raise AnalysisError(
                    f"derived key {dkey!r} reads unknown parameter {u.key!r}")
            _add_edge(acc, EK_PARAM_DERIVED, u.key, dkey, (), [u.site])

    # ---- guards: is_* locals comparing the op kind to workload constants -
    guard_kinds: Dict[str, str] = {}
    for gname, exprs in terms_fn.assigns.items():
        for gexpr, _ in exprs:
            if isinstance(gexpr, ast.Compare) and len(gexpr.ops) == 1 and \
                    isinstance(gexpr.ops[0], ast.Eq) and \
                    isinstance(gexpr.comparators[0], ast.Attribute) and \
                    isinstance(gexpr.comparators[0].value, ast.Name):
                attr = gexpr.comparators[0]
                const = idx.resolve_constant(terms_fn, attr.value.id,
                                             attr.attr)
                if const is not None:
                    guard_kinds[gname] = attr.attr
    if not guard_kinds:
        raise AnalysisError("no op-kind guards found in _op_terms")

    # ---- terms: the non-guard keys _dominant_class reads off _op_terms ---
    if not dom_fn.params:
        raise AnalysisError(f"{dom_fn.qualname}: expected a terms-dict formal")
    tname = dom_fn.params[0]
    dom_keys = {r.name for r in expr_reads(dom_fn.node, dom_fn.file)
                if r.kind == "key" and r.base == tname}
    # keys read via the unpacking locals too (t_compute = t["t_compute"])
    terms = tuple(k for k in terms_fn.dict_returns
                  if k in dom_keys and k not in guard_kinds)
    if not terms:
        raise AnalysisError("no op-time terms discovered from _dominant_class")

    # map term key -> the _op_terms local holding it
    term_local: Dict[str, str] = {}
    for tkey in terms:
        vexpr, _ = terms_fn.dict_returns[tkey]
        if not isinstance(vexpr, ast.Name):
            raise AnalysisError(f"term {tkey!r} is not a plain local")
        term_local[tkey] = vexpr.id

    # ---- _dominant_class: (guards -> class) leaves -----------------------
    stall_classes = tuple(STALL_CLASSES)
    if len(dom_fn.returns) != 1:
        raise AnalysisError(f"{dom_fn.qualname}: expected a single return")
    ret_expr, _ = dom_fn.returns[0]
    leaves = _branches(idx, dom_fn, ret_expr, expand_locals=True)

    # dominance locals: Compare-structured; their subject is a term key
    def _dominance_subject(local: str) -> Optional[str]:
        exprs = dom_fn.assigns.get(local)
        if not exprs:
            return None
        subjects = set()
        for node in ast.walk(exprs[0][0]):
            if isinstance(node, ast.Compare) and \
                    isinstance(node.left, ast.Name) and \
                    any(isinstance(op, (ast.Gt, ast.GtE)) for op in node.ops):
                subjects.add(node.left.id)
        if len(subjects) != 1:
            return None
        subj = next(iter(subjects))
        # subject local -> t["<key>"] -> term key
        for sexpr, _site in dom_fn.assigns.get(subj, ()):
            for r in expr_reads(sexpr, dom_fn.file):
                if r.kind == "key" and r.base == tname and r.name in terms:
                    return r.name
        return None

    class_term: Dict[str, str] = {}
    class_constraints: Dict[str, List[Guards]] = {}
    class_sites: Dict[str, List[Site]] = {c: [] for c in stall_classes}
    for guards, leaf in leaves:
        if not isinstance(leaf, ast.Name):
            raise AnalysisError(
                f"{dom_fn.qualname}: non-constant attribution leaf at "
                f"line {getattr(leaf, 'lineno', '?')}")
        const = idx.resolve_constant(dom_fn, None, leaf.id)
        if const is None or not isinstance(const[0], int):
            raise AnalysisError(
                f"{dom_fn.qualname}: leaf {leaf.id!r} is not an int constant")
        cval, csite = const
        if not 0 <= cval < len(stall_classes):
            raise AnalysisError(f"class constant {leaf.id}={cval} out of "
                                f"range for STALL_CLASSES")
        cname = stall_classes[cval]
        class_sites[cname].append(Site(dom_fn.file, leaf.lineno))
        class_sites[cname].append(csite)
        kind_atoms = frozenset((n, p) for n, p in guards if n in guard_kinds)
        class_constraints.setdefault(cname, []).append(kind_atoms)
        for n, p in guards:
            if n in guard_kinds or not p:
                continue
            subj = _dominance_subject(n)
            if subj is None:
                raise AnalysisError(
                    f"{dom_fn.qualname}: cannot find dominance subject of "
                    f"guard {n!r}")
            if class_term.get(cname, subj) != subj:
                raise AnalysisError(f"class {cname}: conflicting terms")
            class_term[cname] = subj

    # classes with no positive dominance guard get the leftover term
    unclaimed = [c for c in class_constraints if c not in class_term]
    leftover = [t for t in terms if t not in class_term.values()]
    if len(unclaimed) == 1 and len(leftover) == 1:
        class_term[unclaimed[0]] = leftover[0]
    elif unclaimed:
        raise AnalysisError(
            f"cannot attribute terms by elimination: classes {unclaimed} "
            f"vs leftover terms {leftover}")
    stalls = tuple(c for c in stall_classes if c in class_term)
    if set(stalls) != set(stall_classes):
        raise AnalysisError(
            f"attribution covers {stalls}, expected {stall_classes}")

    # ---- derived -> term (guarded key uses of each term's dataflow) ------
    if not terms_fn.params:
        raise AnalysisError(f"{terms_fn.qualname}: expected a hw-dict formal")
    hwb = frozenset([terms_fn.params[0]])
    term_uses: Dict[str, List[KeyUse]] = {}
    for tkey in terms:
        uses: List[KeyUse] = []
        for aexpr, _ in terms_fn.assigns.get(term_local[tkey], ()):
            uses.extend(_key_uses(idx, terms_fn, aexpr, hwb,
                                  frozenset(), set()))
        if not uses:
            raise AnalysisError(f"term {tkey!r} reads no derived hw key")
        term_uses[tkey] = uses
        for u in uses:
            if u.key not in derived:
                raise AnalysisError(
                    f"term {tkey!r} reads {u.key!r}, not a derived key")
            _add_edge(acc, EK_DERIVED_TERM, u.key, tkey,
                      _guard_strs(u.guards), [u.site])

    # ---- term -> stall + derived -> stall (constraint-compatible) --------
    for cname in stalls:
        tkey = class_term[cname]
        constraints = class_constraints[cname]
        _add_edge(acc, EK_TERM_STALL, tkey, cname,
                  tuple(sorted({s for c in constraints
                                for s in _guard_strs(c)})),
                  class_sites[cname])
        for u in term_uses[tkey]:
            if _compatible(u.guards, constraints):
                _add_edge(acc, EK_DERIVED_STALL, u.key, cname,
                          _guard_strs(u.guards), [u.site])

    # ---- term -> metric: latency reduction + the suite's metric names ----
    # the latency local is the one reducing a key of the op-terms dict
    lat_local, lat_site = None, None
    tdict_locals = {n for n, exprs in batch_fn.assigns.items()
                    for aexpr, _ in exprs
                    if isinstance(aexpr, ast.Call) and
                    callee_parts(aexpr)[1] == terms_fn.name}
    if not tdict_locals:
        raise AnalysisError(
            f"{batch_fn.qualname}: no call to {terms_fn.name} found")
    for lname, exprs in batch_fn.assigns.items():
        for aexpr, asite in exprs:
            for r in expr_reads(aexpr, batch_fn.file):
                if r.kind == "key" and r.base in tdict_locals and \
                        r.name in terms_fn.dict_returns and \
                        r.name not in guard_kinds:
                    # chase the op-terms key back to the time terms
                    start, _ = terms_fn.dict_returns[r.name]
                    hits = _name_closure(terms_fn, start,
                                         set(term_local.values()))
                    if set(hits) == set(term_local.values()):
                        lat_local, lat_site = lname, asite
                        term_hits = hits
                        break
            if lat_local:
                break
        if lat_local:
            break
    if lat_local is None:
        raise AnalysisError(
            f"{batch_fn.qualname}: no local reduces all op-time terms")

    metric_names, suite_site = _suite_metrics(suite_fn)
    for tkey in terms:
        hsite = term_hits[term_local[tkey]]
        for m in metric_names:
            _add_edge(acc, EK_TERM_METRIC, tkey, m,
                      (), [hsite, lat_site, suite_site])

    # ---- derived -> metric: the area key feeds the area metric -----------
    if _AREA_KEY not in derived:
        raise AnalysisError(f"derived key {_AREA_KEY!r} missing")
    _add_edge(acc, EK_DERIVED_METRIC, _AREA_KEY, _AREA_METRIC,
              (), [hw_fn.dict_returns[_AREA_KEY][1]])
    metrics = tuple(metric_names) + (_AREA_METRIC,)

    # ---- primary resources: peak key + class exclusivity -----------------
    edges = tuple(Edge(k, s, d, g, tuple(sorted(sites)))
                  for (k, s, d, g), sites in sorted(acc.items()))
    graph = InfluenceGraph(params=params, derived=derived, terms=terms,
                           stalls=stalls, metrics=metrics, edges=edges,
                           guard_kinds=guard_kinds, primary={})
    stall_params = graph.stall_params()
    param_stalls: Dict[str, Set[str]] = {p: set() for p in params}
    for c, ps in stall_params.items():
        for p in ps:
            param_stalls[p].add(c)
    pderived = graph.param_derived()

    primary: Dict[str, str] = {}
    prim_edges: Dict[tuple, Set[str]] = {}
    for cname in stalls:
        tkey = class_term[cname]
        constraints = class_constraints[cname]
        items = []
        for aexpr, _ in terms_fn.assigns.get(term_local[tkey], ()):
            for guards, leaf in _branches(idx, terms_fn, aexpr):
                if _compatible(guards, constraints):
                    items.append((terms_fn, leaf, hwb, False))
        peaks = _peak_keys(idx, items)
        if not peaks:
            raise AnalysisError(f"class {cname}: no peak (denominator) key "
                                f"found in term {tkey!r}")
        peak_keys = {k for k, _ in peaks}
        cands = sorted(p for p in params
                       if pderived[p] & peak_keys and
                       param_stalls[p] == {cname})
        if len(cands) != 1:
            raise AnalysisError(
                f"class {cname}: primary parameter not unique: {cands} "
                f"(peak keys {sorted(peak_keys)})")
        primary[cname] = cands[0]
        sites = {str(s) for _, s in peaks}
        for e in graph.edges_of(EK_PARAM_DERIVED):
            if e.src == cands[0] and e.dst in peak_keys:
                sites.update(e.sites)
        prim_edges[(EK_STALL_PRIMARY, cname, cands[0], ())] = sites

    graph.primary = primary
    graph.edges = graph.edges + tuple(
        Edge(k, s, d, g, tuple(sorted(sites)))
        for (k, s, d, g), sites in sorted(prim_edges.items()))
    return graph


def _name_closure(fn: FunctionInfo, start: ast.expr,
                  targets: Set[str]) -> Dict[str, Site]:
    """Which of ``targets`` (locals of fn) are read, transitively through
    local assignments, starting from ``start``; with the site of the first
    read found."""
    hits: Dict[str, Site] = {}
    seen: Set[str] = set()
    work: List[ast.expr] = [start]
    while work:
        e = work.pop()
        for r in expr_reads(e, fn.file):
            if r.kind != "name":
                continue
            if r.name in targets:
                hits.setdefault(r.name, r.site)
            elif r.name in fn.assigns and r.name not in seen:
                seen.add(r.name)
                work.extend(ae for ae, _ in fn.assigns[r.name])
    return hits


def _suite_metrics(suite_fn: FunctionInfo) -> Tuple[Tuple[str, ...], Site]:
    """The latency metric names: the keys of the workload-dict literal the
    paper suite builds (``{"ttft": ..., "tpot": ...}``)."""
    for _, exprs in suite_fn.assigns.items():
        for aexpr, asite in exprs:
            if isinstance(aexpr, ast.Dict) and aexpr.keys and all(
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                    for k in aexpr.keys):
                return tuple(k.value for k in aexpr.keys), asite
    raise AnalysisError(
        f"{suite_fn.qualname}: no workload-dict literal found")


@lru_cache(maxsize=1)
def extract_influence_graph() -> InfluenceGraph:
    """Extract (and cache) the influence graph from the port's perfmodel
    source (``src/repro_torch/perfmodel/``)."""
    idx = ModuleIndex.build(_perfmodel_modules())
    return _extract(idx)


@lru_cache(maxsize=1)
def _primary_cached() -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(extract_influence_graph().primary.items()))


def primary_resources() -> Dict[str, str]:
    """stall class -> the parameter that most directly relieves it, derived
    from the perfmodel source (the reference replaced the hand-coded AHK
    tables of its ``core/llm.py`` / ``core/strategy.py`` with it)."""
    return dict(_primary_cached())


def derived_to_metrics() -> Dict[str, Set[str]]:
    """Extracted replacement for the hand table
    ``repro_torch.core.quale_ast.DERIVED_TO_METRICS`` names.

    Differs from the old hand table in one honest way: the passthrough key
    ``vector_width`` is NOT read by any op-time term (only
    ``vector_flops`` is), so it maps to no latency metric here; the old
    table's entry was redundant for the param-level map."""
    return extract_influence_graph().derived_to_metrics()


def derive_influence_map_from_source() -> Dict[str, Set[str]]:
    """param -> set of PPA metrics, from source over the FULL perfmodel
    surface (signature-compatible with the deprecated quale_ast version,
    which only analyzed two hardware functions)."""
    return extract_influence_graph().param_metrics()


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
    src_s_by_stall = graph.stall_params()
    src_s: Dict[str, Set[str]] = {p: set() for p in graph.params}
    for c, ps in src_s_by_stall.items():
        for p in ps:
            src_s[p].add(c)
    ma, mp, ms = _diff(src_m, probed.metric_edges, graph.params)
    sa, sp, ss = _diff(src_s, probed.stall_edges, graph.params)
    return RuleAudit(metric_agree=ma, metric_probe_only=mp,
                     metric_source_only=ms, stall_agree=sa,
                     stall_probe_only=sp, stall_source_only=ss)


def load_artifact(path: Optional[Path] = None) -> InfluenceGraph:
    """The checked-in graph (``influence_graph.json``, the reference's
    extraction, its sites the reference's lines) or the one at `path`."""
    p = path or ARTIFACT_PATH
    return InfluenceGraph.from_json(json.loads(p.read_text()))
