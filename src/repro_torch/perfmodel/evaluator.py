"""Unified tiered Evaluator API: ONE PPA contract for every consumer.

* :class:`EvalRequest`  — design-index batch + workload subset + detail
  level (``objectives`` | ``ppa`` | ``stalls``);
* :class:`PPAReport`    — the structured host-side result (per-workload
  latencies, area, stall attribution, per-op breakdown) with
  :meth:`PPAReport.stall_report` bridging to the Strategy Engine;
* :class:`ModelEvaluator` — the analytical-model implementation: one
  :meth:`~ModelEvaluator.evaluate` decodes the batch, derives the hardware
  once and computes every workload's op terms on the device, then brings
  the result to the host once (one *dispatch*, counted in ``dispatches``);
* a **backend registry** (``roofline`` | ``compass`` | ``cuda``):
  ``cuda`` routes the ``objectives`` dispatch through the hand-written
  ``ppa_eval`` kernel, and ``backend="auto"`` times the candidates on the
  card and keeps the fastest;
* **tiers**: ``proxy`` (roofline), ``target`` (LLMCompass-calibrated) and
  ``oracle`` — the exhaustive :class:`~repro_torch.perfmodel.sweep.
  SweepEngine` front wrapped as :class:`OracleEvaluator`, optionally
  memoized on disk (``oracle_store=``);
* **suites**: ``paper`` (the GPT-3 pair) and ``zoo`` (every assigned
  architecture config as a (prefill, decode) scenario: all 20 workloads in
  one stacked dispatch, or one ``ppa_eval`` launch on ``backend="cuda"``).

Every evaluator runs on one torch device, the CUDA device unless the caller
passes ``device="cpu"``.  Reports are numpy arrays on the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.perfmodel.critical_path import StallReport, build_report
from repro_torch.perfmodel.designspace import DesignSpace, SPACE
from repro_torch.perfmodel.hardware import derive_hardware
from repro_torch.perfmodel.roofline import (RooflineModel, _bucketed_call,
                                            _space_key, _workload_fingerprint,
                                            stacked_workload_batches)
from repro_torch.perfmodel.workload import Scenario, WorkloadStack

DETAILS = ("objectives", "ppa", "stalls")
TIERS = ("proxy", "target", "oracle")
SUITES = ("paper", "zoo")

_DETAIL_LEVEL = {name: i for i, name in enumerate(DETAILS)}


# ---------------------------------------------------------------------------
# request / report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EvalRequest:
    """One evaluation call: design-index batch, workload subset, detail.

    idx:       (n, n_params) int32 choice-index vectors (or a single vector).
    detail:    "objectives" (latency per workload + area),
               "ppa" (adds the per-op time breakdown),
               "stalls" (adds per-stall-class attribution + per-op classes).
    workloads: subset of the evaluator's workload names; None = all.
    """
    idx: np.ndarray
    detail: str = "objectives"
    workloads: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.detail not in DETAILS:
            raise ValueError(f"detail must be one of {DETAILS}, "
                             f"got {self.detail!r}")


@dataclasses.dataclass
class PPAReport:
    """Structured PPA result: numpy arrays on the host.

    objectives follow the repo convention ``[*latencies, area]`` in workload
    order — for the paper workloads that is ``[ttft, tpot, area]``.
    """
    workloads: Tuple[str, ...]
    detail: str
    area: np.ndarray                                # (n,)
    latency: Dict[str, np.ndarray]                  # workload -> (n,)
    stall: Optional[Dict[str, np.ndarray]] = None   # workload -> (n, 4)
    op_time: Optional[Dict[str, np.ndarray]] = None
    op_class: Optional[Dict[str, np.ndarray]] = None
    op_names: Optional[Dict[str, tuple]] = None

    @property
    def n(self) -> int:
        return int(self.area.shape[0])

    @property
    def objectives(self) -> np.ndarray:
        """(n, len(workloads) + 1) objective matrix [*latencies, area]."""
        cols = [self.latency[w] for w in self.workloads] + [self.area]
        return np.stack(cols, axis=1)

    def stall_report(self, workload: Optional[str] = None, i: int = 0,
                     top: int = 5) -> StallReport:
        """Critical-path report for design row `i` on one workload."""
        if self.detail != "stalls":
            raise ValueError(
                f"stall_report needs detail='stalls', have {self.detail!r}")
        w = workload if workload is not None else self.workloads[0]
        return build_report(
            self.latency[w][i], self.area[i], self.stall[w][i],
            self.op_time[w][i], self.op_class[w][i], self.op_names[w],
            top=top)

    def stall_reports(self, i: int = 0, top: int = 5) -> Dict[str, StallReport]:
        return {w: self.stall_report(w, i, top) for w in self.workloads}

    def row(self, i: int) -> "PPAReport":
        """Single-design view of batch row `i`."""
        def sl(d):
            return {nm: v[i:i + 1] for nm, v in d.items()} if d else None
        return PPAReport(
            workloads=self.workloads, detail=self.detail,
            area=self.area[i:i + 1],
            latency={nm: self.latency[nm][i:i + 1] for nm in self.workloads},
            stall=sl(self.stall), op_time=sl(self.op_time),
            op_class=sl(self.op_class), op_names=self.op_names)


class Evaluator(Protocol):
    """The one PPA contract: everything downstream programs against this."""
    space: DesignSpace
    workloads: Tuple[str, ...]
    tier: str

    def evaluate(self, request: EvalRequest) -> PPAReport: ...

    def objectives(self, idx: np.ndarray) -> np.ndarray: ...


# ---------------------------------------------------------------------------
# shared per-design report-row cache
# ---------------------------------------------------------------------------

class RowCache:
    """Bounded LRU of single-design :class:`PPAReport` rows.

    Entries are keyed by the design row's index bytes and hold the
    highest-detail report seen for that design.  A lookup hits only when the
    cached detail covers the requested level AND the cached report covers
    the requested workloads.  Eviction is strictly LRU.  Thread-safe.
    """

    def __init__(self, capacity: int = 65_536):
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._d: "OrderedDict[bytes, Tuple[int, PPAReport]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    @staticmethod
    def key(row: np.ndarray) -> bytes:
        return np.ascontiguousarray(row, dtype=np.int32).tobytes()

    def get(self, key: bytes, detail: str,
            names: Tuple[str, ...]) -> Optional[PPAReport]:
        """The cached row, or None if absent / too shallow / wrong suite."""
        level = _DETAIL_LEVEL[detail]
        with self._lock:
            ent = self._d.get(key)
            if (ent is None or ent[0] < level
                    or not set(names) <= set(ent[1].workloads)):
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return ent[1]

    def get_any(self, key: bytes,
                names: Tuple[str, ...]) -> Optional[Tuple[str, PPAReport]]:
        """The cached row at WHATEVER detail it has — ``(detail, row)`` —
        or None if absent / wrong suite."""
        with self._lock:
            ent = self._d.get(key)
            if ent is None or not set(names) <= set(ent[1].workloads):
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return DETAILS[ent[0]], ent[1]

    def put(self, key: bytes, detail: str, row: PPAReport) -> None:
        """Insert one single-design report row (never downgrades)."""
        level = _DETAIL_LEVEL[detail]
        with self._lock:
            ent = self._d.get(key)
            if (ent is not None and ent[0] >= level
                    and set(row.workloads) <= set(ent[1].workloads)):
                self._d.move_to_end(key)
                return
            self._d[key] = (level, row)
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    model_cls: type            # RooflineModel subclass providing the op terms
    kernel: bool = False       # route the objectives dispatch through the
                               # hand-written CUDA ppa_eval kernel

_BACKENDS: Dict[str, BackendSpec] = {}


def register_backend(name: str, model_cls: type, *, kernel: bool = False) -> None:
    _BACKENDS[name] = BackendSpec(name=name, model_cls=model_cls, kernel=kernel)


def backend_names() -> Tuple[str, ...]:
    return tuple(_BACKENDS)


def _backend(name: str) -> BackendSpec:
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; "
                         f"registered: {sorted(_BACKENDS)}")
    return _BACKENDS[name]


# tier -> default backend for model construction
TIER_BACKEND = {"proxy": "roofline", "target": "compass"}

_AUTO_CACHE: Dict[tuple, str] = {}


def _bare_roofline(models: Mapping[str, RooflineModel]) -> bool:
    return all((m.op_overhead_s, m.nonoverlap, m.mem_efficiency) == (0.0, 0.0, 1.0)
               for m in models.values())


def homogeneous_models(models: Mapping[str, RooflineModel]) -> bool:
    """True when every model shares one op-term implementation (class +
    compass knobs) — the eligibility rule for the stacked evaluator path."""
    return len({(type(m), m.op_overhead_s, m.nonoverlap, m.mem_efficiency)
                for m in models.values()}) == 1


def resolve_backend(backend: Optional[str],
                    models: Mapping[str, RooflineModel],
                    device: torch.device) -> str:
    """Map None/"auto" to a concrete backend for these models.

    "auto" times the candidate objectives dispatches on a probe batch on
    the CUDA device and keeps the fastest (memoized per process + device).
    Only bare-roofline models are eligible for the kernel; compass-tier
    knobs, or a device that is not CUDA, keep the torch roofline path.
    """
    if backend is None:
        return "roofline"
    if backend != "auto":
        spec = _backend(backend)
        if spec.kernel and not _bare_roofline(models):
            raise ValueError(
                f"backend={backend!r} implements the bare roofline tier; "
                "these models carry compass-tier knobs the kernel ignores")
        return backend
    if not _bare_roofline(models) or device.type != "cuda":
        return "roofline"
    key = (str(device),
           tuple(_workload_fingerprint(m.wl) for m in models.values()))
    cached = _AUTO_CACHE.get(key)
    if cached is None:
        cached = _benchmark_backends(models, device)
        _AUTO_CACHE[key] = cached
    return cached


def _benchmark_backends(models: Mapping[str, RooflineModel],
                        device: torch.device, probe: int = 1024) -> str:
    """Time each kernel-capable candidate's objectives dispatch."""
    best_name, best_t = "roofline", np.inf
    rng = np.random.default_rng(0)
    space = next(iter(models.values())).space
    idx = space.sample(rng, probe)
    rep_cls = type(next(iter(models.values())))
    for name, spec in _BACKENDS.items():
        if spec.model_cls is not rep_cls and not spec.kernel:
            continue
        ev = ModelEvaluator(models, backend=name, device=device)
        ev.objectives(idx)                      # build + warm
        t0 = time.perf_counter()
        ev.objectives(idx)
        dt = time.perf_counter() - t0
        if dt < best_t:
            best_name, best_t = name, dt
    return best_name


# ---------------------------------------------------------------------------
# the analytical-model evaluator (proxy / target tiers)
# ---------------------------------------------------------------------------

class ModelEvaluator:
    """Evaluator over a set of named workload models sharing one design space.

    One :meth:`evaluate` is one device dispatch regardless of the number of
    workloads or the detail level: the batch is decoded and its hardware
    derived once, every workload's op terms are computed on the device, and
    the outputs come back to the host together.  ``dispatches`` counts them
    (the DSE loop costs one per step).
    """

    def __init__(self, models: Mapping[str, RooflineModel], *,
                 tier: str = "proxy", backend: Optional[str] = None,
                 scenarios: Optional[Tuple[Scenario, ...]] = None,
                 stacked: Optional[bool] = None,
                 device: DeviceLike = None):
        if not models:
            raise ValueError("need at least one workload model")
        self.models: Dict[str, RooflineModel] = dict(models)
        spaces = {id(m.space): m.space for m in self.models.values()}
        if len(spaces) > 1:
            keys = {_space_key(s) for s in spaces.values()}
            if len(keys) > 1:
                raise ValueError("all workload models must share one design space")
        self.space: DesignSpace = next(iter(self.models.values())).space
        self.tier = tier
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.models, self.device)
        self.scenarios = scenarios
        # stacked path: ONE op-term pass over the deduped union of all
        # workloads' op tables — bit-identical to the per-workload loop.
        eligible = homogeneous_models(self.models)
        if stacked and not eligible:
            raise ValueError(
                "stacked=True needs every workload model to share one class "
                "and compass-knob set (their op terms fuse into one pass)")
        self.stacked = eligible if stacked is None else bool(stacked)
        self.dispatches = 0
        # a sharded evaluator's thread workers share this evaluator
        self._count_lock = threading.Lock()
        self._fns: Dict[tuple, Callable] = {}
        self._stacks: Dict[Tuple[str, ...], WorkloadStack] = {}

    # -- identity ------------------------------------------------------
    @property
    def workloads(self) -> Tuple[str, ...]:
        return tuple(self.models)

    def _stack(self, names: Tuple[str, ...]) -> WorkloadStack:
        stack = self._stacks.get(names)
        if stack is None:
            stack = WorkloadStack.build({nm: self.models[nm].wl
                                         for nm in names})
            self._stacks[names] = stack
        return stack

    # -- device path ---------------------------------------------------
    def _fused_fn(self, detail: str, names: Tuple[str, ...]) -> Callable:
        fn = self._fns.get((detail, names))
        if fn is None:
            if _backend(self.backend).kernel and detail == "objectives":
                fn = self._build_kernel_objectives(names)
            else:
                fn = self._build_traced(detail, names)
            self._fns[(detail, names)] = fn
        return fn

    def _build_traced(self, detail: str, names: Tuple[str, ...]) -> Callable:
        models = {nm: self.models[nm] for nm in names}

        def hardware(idx: torch.Tensor):
            hw = derive_hardware(self.space.decode(idx))     # once per batch
            return hw, {kk: vv[:, None] for kk, vv in hw.items()}

        if self.stacked:
            stack = self._stack(names)
            rep_model = models[names[0]]

            def fused(idx: torch.Tensor) -> Dict:
                hw, hwb = hardware(idx)
                return {"area": hw["area_mm2"],
                        "per_workload": stacked_workload_batches(
                            rep_model, stack, hwb, detail)}

            return fused

        def fused(idx: torch.Tensor) -> Dict:
            hw, hwb = hardware(idx)
            return {"area": hw["area_mm2"],
                    "per_workload": {nm: m._workload_batch(hwb, detail)
                                     for nm, m in models.items()}}

        return fused

    def _build_kernel_objectives(self, names: Tuple[str, ...]) -> Callable:
        """Objectives dispatch through the CUDA ppa_eval kernel."""
        from repro_torch.kernels.ppa_eval import (kernel_tables,
                                                  ppa_eval_workloads)
        tables = kernel_tables([self.models[nm].wl for nm in names],
                               self.device)

        def fused(idx: torch.Tensor) -> Dict:
            lat, area, _ = ppa_eval_workloads(
                self.space.decode_values(idx), tables)
            return {"area": area,
                    "per_workload": {nm: {"latency": t}
                                     for nm, t in zip(names, lat)}}

        return fused

    # -- public API -----------------------------------------------------
    def evaluate(self, request: EvalRequest) -> PPAReport:
        names = (self.workloads if request.workloads is None
                 else tuple(request.workloads))
        unknown = set(names) - set(self.models)
        if unknown:
            raise KeyError(f"unknown workloads {sorted(unknown)}; "
                           f"have {self.workloads}")
        fn = self._fused_fn(request.detail, names)
        out = _bucketed_call(fn, request.idx, self.device)   # ONE dispatch
        with self._count_lock:
            self.dispatches += 1
        per = out["per_workload"]
        detail = request.detail
        rep = PPAReport(
            workloads=names, detail=detail, area=out["area"],
            latency={nm: per[nm]["latency"] for nm in names})
        if detail in ("ppa", "stalls"):
            rep.op_time = {nm: per[nm]["op_time"] for nm in names}
            rep.op_names = {nm: tuple(self.models[nm].wl.op_names)
                            for nm in names}
        if detail == "stalls":
            rep.stall = {nm: per[nm]["stall"] for nm in names}
            rep.op_class = {nm: per[nm]["op_class"] for nm in names}
        return rep

    def objectives(self, idx: np.ndarray) -> np.ndarray:
        """(n, len(workloads)+1) objectives [*latencies, area], one dispatch."""
        return self.evaluate(EvalRequest(idx, detail="objectives")).objectives

    def ppa(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="ppa"))

    def stalls(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="stalls"))

    # baseline drivers accept plain callables; the evaluator IS one
    def __call__(self, idx: np.ndarray) -> np.ndarray:
        return self.objectives(idx)


# ---------------------------------------------------------------------------
# oracle tier: the exhaustive sweep front as ground truth
# ---------------------------------------------------------------------------

class OracleEvaluator:
    """Wraps a base evaluator with the exhaustive-sweep ground truth.

    Point evaluations delegate to the base; the oracle adds the exact
    full-space Pareto front from :class:`~repro_torch.perfmodel.sweep.
    SweepEngine` — swept lazily once, or handed in as ``result=`` when the
    caller already swept with the same engine settings — so campaign
    metrics can be normalized against ground truth (``normalized_phv``,
    ``regret``).

    ``oracle_store=`` opts into the persistent oracle store: ``True`` uses
    ``~/.cache/repro_torch-oracle/`` (the port's own, never the
    reference's directory), a string names a directory.  The sweep
    artifact is keyed by the engine's configuration fingerprint (space
    cards, backend, workload fingerprints, model classes, stop + sweep
    knobs), so a repeat OracleEvaluator is a ``load_sweep_result`` instead
    of a re-sweep; a corrupt artifact is quarantined and re-swept, never
    trusted.
    """

    tier = "oracle"

    def __init__(self, base: ModelEvaluator, *, stop: Optional[int] = None,
                 sweep_kwargs: Optional[dict] = None, result=None,
                 oracle_store=None):
        self.base = base
        self.space = base.space
        self.stop = stop                      # None = the full space
        self._sweep_kwargs = dict(sweep_kwargs or {})
        self.oracle_store = oracle_store
        self._result = result
        self._phv_cache: Dict[bytes, float] = {}

    @property
    def workloads(self) -> Tuple[str, ...]:
        return self.base.workloads

    @property
    def dispatches(self) -> int:
        return self.base.dispatches

    def evaluate(self, request: EvalRequest) -> PPAReport:
        return self.base.evaluate(request)

    def objectives(self, idx: np.ndarray) -> np.ndarray:
        return self.base.objectives(idx)

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        return self.base.objectives(idx)

    # -- ground truth ---------------------------------------------------
    def _store_path(self, eng) -> Optional[Tuple[str, str]]:
        """(artifact path, content key) under the oracle store, or None
        when the store is off."""
        if not self.oracle_store:
            return None
        from repro_torch.perfmodel.sweep import DEFAULT_ORACLE_STORE
        root = (DEFAULT_ORACLE_STORE if self.oracle_store is True
                else str(self.oracle_store))
        root = os.path.expanduser(root)
        knobs = "|".join(f"{k}={self._sweep_kwargs[k]}"
                         for k in sorted(self._sweep_kwargs))
        key = f"{eng.fingerprint()}|stop={self.stop}|{knobs}"
        digest = hashlib.sha256(key.encode()).hexdigest()[:32]
        return os.path.join(root, f"oracle-{digest}.npz"), key

    def sweep_result(self):
        """The (memoized) exhaustive sweep over [0, stop or size) — loaded
        from the oracle store when enabled and populated, swept (and
        stored) otherwise."""
        if self._result is not None:
            return self._result
        from repro_torch.perfmodel.sweep import (SweepEngine,
                                                 load_sweep_result,
                                                 save_sweep_result)
        eng = SweepEngine(self.base, **self._sweep_kwargs)
        loc = self._store_path(eng)
        if loc is None:
            self._result = eng.run(0, self.stop)
            return self._result
        path, key = loc
        if os.path.exists(path):
            try:
                self._result = load_sweep_result(path, key=key)
                return self._result
            except ValueError as exc:
                q = path + ".quarantined"
                try:
                    os.replace(path, q)
                except OSError:
                    q = "<could not rename>"
                warnings.warn(f"oracle store artifact {path} is invalid "
                              f"({exc}); quarantined to {q} — re-sweeping",
                              RuntimeWarning, stacklevel=2)
        self._result = eng.run(0, self.stop)
        save_sweep_result(path, self._result, key=key)
        return self._result

    def front(self) -> np.ndarray:
        """Exact Pareto-front objective rows (p, n_obj)."""
        return self.sweep_result().pareto_y

    def front_idx(self) -> np.ndarray:
        return self.sweep_result().pareto_idx(self.space)

    def oracle_phv(self, ref_point: np.ndarray) -> float:
        """Hypervolume of the exhaustive front w.r.t. `ref_point`."""
        from repro_torch.core.pareto import hypervolume
        ref = np.asarray(ref_point, dtype=np.float64)
        key = ref.tobytes()
        if key not in self._phv_cache:
            self._phv_cache[key] = hypervolume(self.front(), ref)
        return self._phv_cache[key]

    def normalized_phv(self, phv: float, ref_point: np.ndarray) -> float:
        """Campaign PHV as a fraction of the exhaustive-front PHV."""
        oracle = self.oracle_phv(ref_point)
        return float(phv) / oracle if oracle > 0 else 0.0

    def regret(self, y: np.ndarray) -> np.ndarray:
        """Per-objective relative regret of a campaign's best points vs the
        true optima: (best_found - best_possible) / best_possible."""
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        best_true = self.sweep_result().topk_val[:, 0]
        if y.shape[1] != best_true.shape[0]:
            raise ValueError(
                f"regret expects {best_true.shape[0]}-objective rows "
                f"(the oracle front's space), got {y.shape[1]}")
        best_found = y.min(axis=0)
        return (best_found - best_true) / np.maximum(best_true, 1e-300)


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def make_evaluator(workloads: Mapping[str, "object"], *, tier: str = "proxy",
                   backend: Optional[str] = None,
                   space: DesignSpace = SPACE,
                   scenarios: Optional[Tuple[Scenario, ...]] = None,
                   stacked: Optional[bool] = None,
                   device: DeviceLike = None) -> ModelEvaluator:
    """Build a ModelEvaluator from {name: Workload} at a fidelity tier."""
    if tier not in TIER_BACKEND:
        raise ValueError(f"tier must be one of {sorted(TIER_BACKEND)} here; "
                         "use get_evaluator('oracle') for the oracle tier")
    cls = _backend(TIER_BACKEND[tier]).model_cls
    models = {nm: cls(wl, space) for nm, wl in workloads.items()}
    return ModelEvaluator(models, tier=tier, backend=backend,
                          scenarios=scenarios, stacked=stacked, device=device)


_PAPER_EVALUATORS: Dict[tuple, "Evaluator"] = {}


def get_evaluator(tier: str = "proxy", backend: Optional[str] = None,
                  *, oracle_stop: Optional[int] = None,
                  oracle_store=None,
                  workers: int = 1, mode: str = "auto",
                  suite: str = "paper",
                  device: DeviceLike = None) -> Evaluator:
    """The paper-workload (or zoo-portfolio) evaluator per tier (memoized
    per device).

    tier="proxy"  -> roofline models (cheap acquisition tier);
    tier="target" -> compass models (the budgeted high-fidelity tier);
    tier="oracle" -> OracleEvaluator over the chosen backend's models
                     (default roofline), exposing the exhaustive front.
    backend: "roofline" | "compass" | "cuda" | "auto" | None.
    oracle_store: opt-in persistent sweep-artifact store for the oracle
             tier (``True`` = ``~/.cache/repro_torch-oracle/``, or a
             directory path).
    workers: > 1 wraps the evaluator in a :class:`~repro_torch.distributed.
             sharded.ShardedEvaluator` that fans each EvalRequest's batch
             across N workers (`mode`: "thread" | "process" | "device" |
             "inline" | "auto"); the report stays bit-identical to the
             local path.  ``workers=1`` is the plain evaluator, whatever
             the mode.
    suite: "paper" — the GPT-3 (ttft, tpot) pair, one scenario;
           "zoo"   — every assigned architecture config as a scenario
           (``<arch>:prefill`` / ``<arch>:decode`` workload pairs from
           :func:`~repro_torch.perfmodel.workload.zoo_suite`), all
           workloads in ONE stacked dispatch; ``.scenarios`` drives the
           portfolio sweep.
    device:  the torch device; None = the CUDA device (raises without one).
    """
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if suite not in SUITES:
        raise ValueError(f"suite must be one of {SUITES}, got {suite!r}")
    from repro_torch.distributed.sharded import MODES  # leaf dep
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    workers = max(1, int(workers))
    if workers == 1:
        mode = "auto"      # inert knobs: collapse onto the memoized base key
    dev = resolve_device(device)
    key = (tier, backend, oracle_stop, workers, mode, suite,
           None if not oracle_store else str(oracle_store), str(dev))
    cached = _PAPER_EVALUATORS.get(key)
    if cached is not None:
        return cached
    from repro_torch.perfmodel.workload import paper_suite, zoo_suite
    if tier == "oracle":
        base_backend = backend or "roofline"
        base_tier = "target" if base_backend == "compass" else "proxy"
        base = get_evaluator(base_tier, base_backend, workers=workers,
                             mode=mode, suite=suite, device=dev)
        ev: Evaluator = OracleEvaluator(base, stop=oracle_stop,
                                        oracle_store=oracle_store)
    else:
        model_backend = backend if backend not in (None, "auto", "cuda") \
            else TIER_BACKEND[tier]
        cls = _backend(model_backend).model_cls
        wls, scenarios = paper_suite() if suite == "paper" else zoo_suite()
        models = {nm: cls(wl) for nm, wl in wls.items()}
        ev = ModelEvaluator(models, tier=tier, backend=backend,
                            scenarios=scenarios, device=dev)
        if workers > 1:
            from repro_torch.distributed.sharded import ShardedEvaluator
            ev = ShardedEvaluator(ev, workers=workers, mode=mode)
    _PAPER_EVALUATORS[key] = ev
    return ev


_MODEL_EVALUATORS: Dict[tuple, ModelEvaluator] = {}


def evaluator_for_model(model: RooflineModel, name: str = "lat", *,
                        device: DeviceLike = None) -> ModelEvaluator:
    """Memoized single-workload evaluator for one model instance."""
    dev = resolve_device(device)
    key = (id(model), str(dev))
    ev = _MODEL_EVALUATORS.get(key)
    if ev is None or ev.models.get(name) is not model:
        ev = ModelEvaluator({name: model}, device=dev)
        if len(_MODEL_EVALUATORS) >= 256:     # bound the id-keyed memo
            _MODEL_EVALUATORS.clear()
        _MODEL_EVALUATORS[key] = ev
    return ev


def pair_view(evaluator, names: Tuple[str, str]) -> Evaluator:
    """A two-workload view over ``names`` of a model-backed evaluator,
    sharing its model objects and device."""
    names = tuple(names)
    if tuple(evaluator.workloads) == names:
        return evaluator
    models = evaluator.models
    unknown = set(names) - set(models)
    if unknown:
        raise KeyError(f"unknown workloads {sorted(unknown)}; "
                       f"have {tuple(models)}")
    backend = getattr(evaluator, "backend", None)
    return ModelEvaluator({nm: models[nm] for nm in names},
                          tier=evaluator.tier,
                          backend=backend if backend in _BACKENDS else None,
                          device=evaluator.device)


def as_evaluator(obj, *, device: DeviceLike = None) -> Evaluator:
    """Coerce onto the Evaluator contract: an Evaluator passes through; a
    single model becomes a (memoized) single-workload evaluator."""
    if hasattr(obj, "evaluate") and hasattr(obj, "workloads"):
        return obj
    if isinstance(obj, RooflineModel):
        return evaluator_for_model(obj, device=device)
    raise TypeError(f"cannot interpret {type(obj).__name__} as an Evaluator")


# default registry entries
register_backend("roofline", RooflineModel)
from repro_torch.perfmodel.compass import CompassModel  # noqa: E402  (leaf import)
register_backend("compass", CompassModel)
register_backend("cuda", RooflineModel, kernel=True)
