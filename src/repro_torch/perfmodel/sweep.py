"""Streaming full-space sweep engine: every design in [0, 4.7M) on device.

:class:`SweepEngine` streams the flat id range through the torch roofline
model (or the CUDA ``ppa_eval`` kernel) in fixed-size chunks, with

* mixed-radix unranking on the device — no host-side ``flat_to_idx``
  materialization of 4.7M index vectors;
* per-chunk on-device reduction: a running top-k per objective, the count
  of designs strictly dominating the reference point, optional per-stall-
  class top-k seeds, and a bounded dominance filter that kills ~all
  dominated points before anything leaves the device;
* an exact host-side :class:`~repro_torch.core.pareto.ParetoArchive`
  absorbing the few filter survivors per chunk, so the final front equals
  the brute-force ``pareto_front`` of all evaluated points (while under
  archive capacity).  A single-scenario chunk's survivors are screened on
  the device against each other and a mirror of the archive
  (:func:`~repro_torch.kernels.pareto_reduce.pareto_reduce`), and only the
  entering rows and the dead incumbents' flags reach the host, which
  applies them (``ParetoArchive.apply``: the archive ``insert`` of the
  survivors would give, bit for bit);
* ``run(workers=N)``: the range splits into N contiguous chunk-aligned
  spans streamed on a thread pool (one device, each span with its own
  carry, archive and checkpoint file), and the host merge reproduces the
  one-process result exactly;
* checkpoint/resume of partial sweeps (atomic, sha256-digested; a corrupt
  file is quarantined, never resumed);
* fault injection and replay: ``run(fault_plan=, span_retry=)`` fires a
  seeded :class:`~repro_torch.distributed.faults.FaultPlan` per (span,
  chunk) and replays a crashed span from its own checkpoint (or from
  scratch), so a chaotic sweep equals a clean one bit for bit;
* observability: run/chunk/id counters and a per-chunk wall-time
  histogram in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (``telemetry()``), and ``sweep.run`` / ``sweep.span`` trace spans;
* ``chunk_size="auto"``: a short timed probe over ``chunk_candidates``
  picks the fastest chunk size (memoized per process);
* ``shard=True``: each chunk's designs split evenly over the local CUDA
  devices, each part evaluated on its own card and the results brought
  back to the engine's for the reduction (a no-op on one device; the
  chunk rounds up to a multiple of the device count);
* **portfolio mode**: an evaluator carrying several
  :class:`~repro_torch.perfmodel.workload.Scenario`\\ s (e.g.
  ``get_evaluator(suite="zoo")``) streams the id range ONCE — one op-term
  pass over the deduped workload union per chunk — while keeping
  per-scenario top-k, exact Pareto archives and stall-class seeds AND a
  robust front under ``robust="worst" | "geomean"`` scalarization of the
  reference-normalized scenario latencies.  The result's top-level front is
  the robust one; ``SweepResult.per_scenario`` holds each scenario's own.

Ties follow the reference (``lax.top_k``: the lower position wins), here
through stable sorts: the running carry comes before the chunk and ids
ascend within a chunk, so the earlier id wins.  Every sum over ops is the
left-to-right :func:`~repro_torch.perfmodel.roofline._seq_sum`, so a
scenario's objectives in the portfolio step equal the stacked evaluator's
and the pair sweep's bit for bit.

Objectives follow the repo convention: ``[ttft, tpot, area]`` per scenario
(prefill latency, decode latency, area), all minimized.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import os
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pareto import ParetoArchive
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pareto_reduce import entrants, pareto_reduce
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import PROCESS_TRACER
from repro_torch.runtime.fault import RetryPolicy, run_with_retries
from repro_torch.perfmodel.designspace import DesignSpace, SPACE, A100_REFERENCE
from repro_torch.perfmodel.hardware import derive_hardware
from repro_torch.perfmodel.roofline import (_dominant_class, _seq_sum,
                                            _workload_fingerprint,
                                            ops_to_tensors)
from repro_torch.perfmodel.workload import WorkloadStack

_FMT_VERSION = 3        # v3 adds portfolio (multi-scenario) checkpoints
_N_STALL = 4            # stall classes in carry order (critical_path order)
BACKENDS = ("roofline", "cuda")
ROBUST = ("worst", "geomean")

# chunk_size="auto" probe results, memoized per (device type, backend, config)
_CHUNK_AUTO_CACHE: Dict[tuple, int] = {}
_NO_SPAN = contextlib.nullcontext()      # a worker span the tracer skipped


def _device_count(device: torch.device) -> int:
    """The local devices a sharded sweep spreads over: every CUDA device
    for an engine on the card, the engine's one device otherwise."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _shard_devices(device: torch.device, n: int) -> List[torch.device]:
    """The n local devices a chunk splits over."""
    return [torch.device(device.type, i) for i in range(n)]


def _np(x) -> np.ndarray:
    """A carry leaf (tensor on any device, or numpy) as a host array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _state_digest(payload: Dict) -> str:
    """sha256 over the checkpoint payload (sorted keys; dtype + shape +
    bytes per entry) — detects truncated or bit-flipped files before their
    garbage reaches a resumed sweep."""
    h = hashlib.sha256()
    for k in sorted(payload):
        if k == "digest":
            continue
        arr = np.asarray(payload[k])
        h.update(k.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# on-device pieces
# --------------------------------------------------------------------------

def _unrank(flat: torch.Tensor, cards: Tuple[int, ...]) -> torch.Tensor:
    """Mixed-radix unrank on device: (c,) int32 flat ids -> (c, n_params)
    int32.  Matches ``DesignSpace.flat_to_idx`` (last parameter fastest)."""
    cols = []
    rem = flat
    for c in reversed(cards):
        cols.append(rem % c)
        rem = rem // c
    return torch.stack(cols[::-1], dim=1).to(torch.int32)


def _smallest_k(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest values along the last axis, ascending;
    ties keep the lower position first (the order ``lax.top_k(-vals, k)``
    gives)."""
    return torch.sort(vals, dim=-1, stable=True).indices[..., :k]


def _dominated_on_device(filt: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(f, m) filter rows x (c, m) points -> (c,) dominated mask; +inf
    filter rows can never dominate anything."""
    f = filt.shape[0]
    c, m = ys.shape
    all_le = torch.ones((c, f), dtype=torch.bool, device=ys.device)
    any_lt = torch.zeros((c, f), dtype=torch.bool, device=ys.device)
    for j in range(m):
        fj = filt[:, j][None, :]
        yj = ys[:, j][:, None]
        all_le &= fj <= yj
        any_lt |= fj < yj
    return (all_le & any_lt).any(dim=1)


def _merge_rows(vals: torch.Tensor, cand: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of (r, n) values and candidate ids: the k smallest values and
    their ids (stable: the earlier position wins a tie)."""
    sel = _smallest_k(vals, k)
    return torch.gather(vals, 1, sel), torch.gather(cand, 1, sel)


@dataclasses.dataclass
class SweepResult:
    n_evaluated: int
    n_superior: int               # designs strictly dominating the reference
    pareto_y: np.ndarray          # (p, 3) exact front of evaluated points
    pareto_ids: np.ndarray        # (p,) flat design ids of the front
    topk_val: np.ndarray          # (3, k) best objective values seen
    topk_ids: np.ndarray          # (3, k) their flat design ids
    ref_point: np.ndarray
    seconds: float
    points_per_sec: float
    archive_truncated: bool       # capacity pruning fired (front then inexact)
    stall_topk_val: Optional[np.ndarray] = None   # (4, k) best rank key
    stall_topk_ids: Optional[np.ndarray] = None   # (4, k) per dominant stall
    archive_capacity: Optional[int] = None
    # ---- portfolio sweeps: the top-level fields above describe the ROBUST
    # objectives [robust_prefill, robust_decode, area] (reference-normalized
    # latencies scalarized across scenarios); per-scenario results nest here
    scenario_names: Optional[Tuple[str, ...]] = None
    robust: Optional[str] = None                  # "worst" | "geomean"
    per_scenario: Optional[Dict[str, "SweepResult"]] = None

    def pareto_idx(self, space: DesignSpace = SPACE) -> np.ndarray:
        """Front design-index vectors (p, n_params)."""
        return space.flat_to_idx(self.pareto_ids)

    def scenario(self, name: str) -> "SweepResult":
        """One scenario's own sweep result (portfolio sweeps only)."""
        if not self.per_scenario:
            raise ValueError("not a portfolio sweep result")
        if name not in self.per_scenario:
            raise KeyError(f"unknown scenario {name!r}; "
                           f"have {self.scenario_names}")
        return self.per_scenario[name]

    def stall_seeds(self, space: DesignSpace = SPACE,
                    scenario: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Per-stall-class seed designs for bottleneck-guided DSE:
        {stall class -> (k', n_params) index vectors}, the best designs
        (under the engine's ``stall_rank`` key) whose dominant stall is that
        class.  A class no swept design was dominated by comes back EMPTY.

        On a portfolio result, ``scenario=<name>`` selects that scenario's
        seed classes; ``scenario=None`` flattens every scenario into
        ``"<scenario>:<stall class>"`` keys."""
        if self.per_scenario is not None:
            if scenario is not None:
                return self.scenario(scenario).stall_seeds(space)
            return {f"{nm}:{cls}": arr
                    for nm in self.scenario_names
                    for cls, arr in
                    self.per_scenario[nm].stall_seeds(space).items()}
        if scenario is not None:
            raise ValueError("scenario= is only valid on portfolio results")
        if self.stall_topk_ids is None:
            raise ValueError("sweep ran without stall_topk; no stall seeds")
        from repro_torch.perfmodel.critical_path import STALL_CLASSES
        out = {}
        for c, name in enumerate(STALL_CLASSES):
            ids = self.stall_topk_ids[c]
            out[name] = space.flat_to_idx(ids[ids >= 0])
        return out


class SweepEngine:
    """Chunked streaming evaluation of the full (or a partial) design space.

    Parameters
    ----------
    ttft_model, tpot_model:
        Either a two-workload (or multi-scenario) :class:`~repro_torch.
        perfmodel.evaluator.ModelEvaluator` as the single first argument,
        or a RooflineModel/CompassModel pair for the two latency objectives,
        evaluated on ``device`` (default: the CUDA device).
    stall_topk:
        When > 0, the chunk step also attributes stalls (the TTFT or each
        scenario's prefill workload) and keeps the `stall_topk` best designs
        per dominant stall class.
    stall_rank:
        Ranking key for the per-stall-class top-k: ``"ttft"`` (default) or
        ``"ref"`` — the minimax objective ratio vs the reference point.
    chunk_size:
        Designs per device step (default 131,072; 65,536 for a portfolio),
        or ``"auto"`` to pick the fastest of ``chunk_candidates`` by a
        short timed probe (memoized per process).  On the ``cuda`` backend
        rounded up to whole 256-design kernel blocks.
    topk, filter_size, local_filter, archive_capacity:
        Running best-k per objective; rows of the on-device dominance filter
        synced from the host archive; per-objective (and log-sum) chunk-local
        killer rows; bound on the host Pareto archive.
    backend:
        ``"roofline"`` evaluates chunks with the torch op-term model;
        ``"cuda"`` through the ``ppa_eval`` kernel (bare roofline tier, pair
        sweeps only).  ``None`` (default) follows the evaluator.
    shard:
        Split each chunk's designs over all local CUDA devices (a no-op on
        one device).  The chunk rounds up to a multiple of the device
        count, and on the ``cuda`` backend to ``lcm(devices, 256)``.
    robust:
        Portfolio scalarization of the reference-normalized latencies:
        ``"worst"`` (max over scenarios) or ``"geomean"``.
    registry / tracer:
        Optional :class:`~repro_torch.obs.metrics.MetricsRegistry` and
        tracer; the engine registers run/chunk/id counters and a per-chunk
        wall time histogram, and wraps ``run`` / worker spans in trace
        spans, each chunk in ``sweep.chunk`` tiled by its phases
        (``sweep.filter``, ``sweep.step``, ``sweep.sync``,
        ``sweep.insert``) and the final merge in ``sweep.reduce``.
        Defaults: a private registry, and the process's tracer
        (:data:`~repro_torch.obs.trace.PROCESS_TRACER`, on while
        ``torch.profiler`` records).
    """

    def __init__(self, ttft_model, tpot_model=None,
                 space: DesignSpace = SPACE, *,
                 chunk_size: Union[int, str, None] = None, topk: int = 16,
                 filter_size: int = 128, local_filter: int = 32,
                 archive_capacity: Union[int, str, None] = 16_384,
                 ref_point: Optional[np.ndarray] = None,
                 backend: Optional[str] = None,
                 stall_topk: int = 0, stall_rank: str = "ttft",
                 robust: str = "worst", shard: bool = False,
                 chunk_candidates: Tuple[int, ...] = (65_536, 131_072,
                                                      262_144),
                 device: DeviceLike = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        scenarios = None
        if tpot_model is None and hasattr(ttft_model, "models"):
            evaluator = ttft_model
            if device is not None and resolve_device(device) != evaluator.device:
                raise ValueError(
                    f"device={device!r} differs from the evaluator's "
                    f"{evaluator.device}; the sweep runs on the evaluator's")
            if len(evaluator.workloads) < 2:
                raise ValueError("sweep needs a two-workload evaluator "
                                 "(ttft + tpot)")
            scenarios = getattr(evaluator, "scenarios", None)
            if scenarios is not None and len(scenarios) > 1:
                if backend not in (None, "roofline"):
                    raise ValueError("portfolio sweeps run on the torch "
                                     "roofline path; backend must stay "
                                     "'roofline'")
                if evaluator.backend == "cuda":
                    raise ValueError("portfolio sweeps need a torch-backend "
                                     "evaluator (backend='roofline'), not "
                                     "'cuda'")
            else:
                scenarios = None
            ttft_model = evaluator.models[evaluator.workloads[0]]
            tpot_model = evaluator.models[evaluator.workloads[1]]
            space = evaluator.space
        elif tpot_model is None:
            raise TypeError("SweepEngine needs a ModelEvaluator or a (ttft, "
                            f"tpot) model pair, got {type(ttft_model).__name__}")
        else:
            from repro_torch.perfmodel.evaluator import ModelEvaluator
            evaluator = ModelEvaluator({"ttft": ttft_model,
                                        "tpot": tpot_model}, device=device)
        if backend is None:
            backend = "cuda" if evaluator.backend == "cuda" else "roofline"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
        if backend == "cuda":
            for m in (ttft_model, tpot_model):
                if (m.op_overhead_s, m.nonoverlap, m.mem_efficiency) != (0.0, 0.0, 1.0):
                    raise ValueError(
                        "backend='cuda' implements the bare roofline tier; "
                        f"{type(m).__name__} carries compass-tier knobs the "
                        "kernel ignores — use backend='roofline'")
        if stall_rank not in ("ttft", "ref"):
            raise ValueError(f"stall_rank must be 'ttft' or 'ref', "
                             f"got {stall_rank!r}")
        if robust not in ROBUST:
            raise ValueError(f"robust must be one of {ROBUST}, got {robust!r}")
        if isinstance(archive_capacity, str) and archive_capacity != "auto":
            raise ValueError("archive_capacity must be an int, None or "
                             f"'auto', got {archive_capacity!r}")
        self.ttft_model = ttft_model
        self.tpot_model = tpot_model
        self.evaluator = evaluator
        self.device = evaluator.device
        self.space = space
        self.size = space.size
        self.topk = int(topk)
        self.stall_topk = int(stall_topk)
        self.stall_rank = stall_rank
        self.robust = robust
        self.filter_size = int(filter_size)
        self.local_filter = int(local_filter)
        self.backend = backend
        self.archive_capacity = archive_capacity
        self.shard = bool(shard)
        ndev = _device_count(self.device) if shard else 1
        self._shard_devs = (_shard_devices(self.device, ndev) if ndev > 1
                            else [])
        self._on_device: Dict[str, object] = {}
        self._cards = tuple(int(c) for c in space.cardinalities)

        # ---- portfolio mode: S > 1 scenarios over one stacked op union ----
        self.scenarios = scenarios
        self._portfolio = scenarios is not None
        if self._portfolio:
            self._init_portfolio(ref_point)
        else:
            if ref_point is None:
                ref_idx = space.encode_nearest(A100_REFERENCE)[None, :]
                ref_point = self.evaluator.objectives(ref_idx)[0]
            self.ref_point = np.asarray(ref_point, dtype=np.float64)
            self._ref = torch.as_tensor(self.ref_point, dtype=torch.float32,
                                        device=self.device)
            # the on-device reduction's sort key: objectives in units of
            # the reference's (ones where a reference entry is not usable)
            w = 1.0 / np.abs(self.ref_point)
            self._key_weights = tuple(float(x) if 0.0 < x < np.inf else 1.0
                                      for x in w)

        if chunk_size is None:
            # portfolio chunks stream ~10x the op rows per id
            chunk_size = 65_536 if self._portfolio else 131_072
        if isinstance(chunk_size, str):
            if chunk_size != "auto":
                raise ValueError(
                    f"chunk_size must be an int or 'auto', got {chunk_size!r}")
            chunk_size = self._autotune_chunk(chunk_candidates)
        chunk_size = int(chunk_size)
        # the chunk divides by the shard count, and on the cuda backend by
        # the kernel's block (ids past `stop` are masked)
        multiple = max(ndev, 1)
        if backend == "cuda":
            from repro_torch.kernels.ppa_eval.ops import BLOCK, kernel_tables
            multiple = math.lcm(multiple, BLOCK)
            self._tables = kernel_tables([ttft_model.wl, tpot_model.wl],
                                         self.device)
        chunk_size += (-chunk_size) % multiple
        self.chunk_size = chunk_size
        self._iota = torch.arange(self.chunk_size, dtype=torch.int32,
                                  device=self.device)

        self.tracer = tracer if tracer is not None else PROCESS_TRACER
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._c_runs = self.metrics.counter(
            "sweep_runs", "completed run() calls")
        self._c_chunks = self.metrics.counter(
            "sweep_chunks", "device chunk steps executed")
        self._c_ids = self.metrics.counter(
            "sweep_ids", "design ids evaluated (valid rows)")
        self._h_chunk = self.metrics.histogram(
            "sweep_chunk_s", "wall time per chunk step incl. host reduce (s)")

    def _init_portfolio(self, ref_point: Optional[np.ndarray]) -> None:
        """Union op table, per-workload gather layout and references."""
        from repro_torch.perfmodel.evaluator import homogeneous_models
        models = self.evaluator.models
        if not homogeneous_models(models):
            raise ValueError("portfolio sweeps need homogeneous workload "
                             "models (one class + compass-knob set)")
        scenarios, dev = self.scenarios, self.device
        self._wl_order = tuple(nm for s in scenarios
                               for nm in (s.prefill, s.decode))
        stack = WorkloadStack.build({nm: models[nm].wl
                                     for nm in self._wl_order})
        self._stack = stack
        self._rep_model = models[self._wl_order[0]]
        self._uops = ops_to_tensors(stack.unique, dev)
        self._uops["count"] = torch.ones(stack.n_unique, dtype=torch.float32,
                                         device=dev)
        # every workload's ops as one zero-padded (W, L) gather out of the
        # union: padding takes count 0, and a +0 at the end of a
        # left-to-right sum of non-negative terms changes no bit
        width = max(stack.op_map[nm].shape[0] for nm in self._wl_order)
        gather = np.zeros((len(self._wl_order), width), dtype=np.int64)
        counts = np.zeros((len(self._wl_order), width), dtype=np.float64)
        for w, nm in enumerate(self._wl_order):
            n = stack.op_map[nm].shape[0]
            gather[w, :n] = stack.op_map[nm]
            counts[w, :n] = stack.counts[nm]
        self._gather = torch.as_tensor(gather, device=dev)
        self._gcount = torch.as_tensor(counts, dtype=torch.float32,
                                       device=dev)
        # per-scenario dominance filters stay lean: the host archive is
        # exact regardless, and S+1 group filters traverse (c, S+1, f)
        self._pf_rows = max(8, min(self.filter_size // 4, 32))
        n_scen = len(scenarios)
        if ref_point is None:
            ref_points = self._scenario_refs()
        else:
            ref_points = np.asarray(ref_point, dtype=np.float64)
            if ref_points.shape != (n_scen, 3):
                raise ValueError(
                    f"portfolio ref_point must be ({n_scen}, 3) — one "
                    f"[prefill, decode, area] row per scenario — got "
                    f"shape {ref_points.shape}")
        self.ref_points = ref_points
        # the robust reference: every normalized latency is 1 at the
        # reference design, area is the raw reference area
        self.ref_point = np.array([1.0, 1.0, float(ref_points[0, 2])])
        self._refs_all = torch.as_tensor(
            np.concatenate([ref_points, self.ref_point[None, :]]),
            dtype=torch.float32, device=dev)                  # (S+1, 3)

    def _scenario_refs(self) -> np.ndarray:
        """(S, 3) reference [prefill, decode, area] per scenario (A100)."""
        from repro_torch.perfmodel.evaluator import EvalRequest
        ref_idx = self.space.encode_nearest(A100_REFERENCE)[None, :]
        rep = self.evaluator.evaluate(EvalRequest(ref_idx,
                                                  detail="objectives"))
        return np.array([[float(rep.latency[s.prefill][0]),
                          float(rep.latency[s.decode][0]),
                          float(rep.area[0])] for s in self.scenarios])

    def _autotune_chunk(self, candidates: Tuple[int, ...]) -> int:
        """Timed probe: one warmed chunk step per candidate size, keep the
        highest-throughput one (memoized per process).  Probe engines
        inherit the shard flag, so a sharded sweep is tuned on the sharded
        path."""
        if not candidates:
            raise ValueError("chunk_size='auto' needs a non-empty "
                             "chunk_candidates tuple")
        key = (self.device.type, self.backend, self.fingerprint(),
               int(self.stall_topk), self.shard,
               tuple(int(c) for c in candidates))
        cached = _CHUNK_AUTO_CACHE.get(key)
        if cached is not None:
            return cached
        best, best_rate = int(candidates[0]), -1.0
        for cand in candidates:
            eng = SweepEngine(
                self.evaluator, chunk_size=int(cand), topk=self.topk,
                filter_size=self.filter_size, local_filter=self.local_filter,
                archive_capacity=self.archive_capacity,
                ref_point=(self.ref_points if self._portfolio
                           else self.ref_point),
                backend=self.backend, robust=self.robust, shard=self.shard,
                stall_topk=self.stall_topk, stall_rank=self.stall_rank)
            span = min(eng.chunk_size, self.size)
            eng.run(0, span)                       # build + warm
            t0 = time.perf_counter()
            eng.run(0, span)
            rate = span / max(time.perf_counter() - t0, 1e-9)
            if rate > best_rate:
                best, best_rate = int(eng.chunk_size), rate
        _CHUNK_AUTO_CACHE[key] = best
        return best

    # ------------------------------------------------------------------
    def _sharded(self, fn, idx: torch.Tensor):
        """fn(idx) -> (ys, dom or None), with idx's rows split evenly over
        the shard devices when there are several: each part on its own
        device, the parts' results back on the engine's, in order."""
        devs = self._shard_devs
        if not devs:
            return fn(idx)
        outs = [fn(part.to(d, non_blocking=True))
                for d, part in zip(devs, idx.chunk(len(devs)))]
        ys = torch.cat([o[0].to(self.device) for o in outs])
        dom = (None if outs[0][1] is None
               else torch.cat([o[1].to(self.device) for o in outs]))
        return ys, dom

    def _tables_on(self, device: torch.device) -> dict:
        """Per-device copies of the chunk step's constant tensors."""
        key = str(device)
        if key not in self._on_device:
            if device == self.device:
                self._on_device[key] = self
            elif self._portfolio:
                self._on_device[key] = types.SimpleNamespace(
                    _uops={k: v.to(device) for k, v in self._uops.items()},
                    _gather=self._gather.to(device),
                    _gcount=self._gcount.to(device))
            else:
                self._on_device[key] = types.SimpleNamespace(
                    _tables=dataclasses.replace(
                        self._tables, ops=self._tables.ops.to(device)))
        return self._on_device[key]

    def _chunk_eval(self, idx: torch.Tensor):
        """(c, n_params) int32 -> ((c, 3) objectives, dominant-stall (c,)
        or None).  Decode + hardware derivation run once per chunk; stall
        attribution only when stall_topk is enabled."""
        if self.backend == "cuda":
            from repro_torch.kernels.ppa_eval import ppa_eval_workloads
            lat, area, stall = ppa_eval_workloads(
                self.space.decode_values(idx),
                self._tables_on(idx.device)._tables)
            ys = torch.stack([lat[0], lat[1], area], dim=1)
            dom = (torch.argmax(stall[0], dim=1).to(torch.int32)
                   if self.stall_topk else None)
            return ys, dom
        hw = derive_hardware(self.space.decode(idx))
        hwb = {kk: vv[:, None] for kk, vv in hw.items()}
        detail_t = "stalls" if self.stall_topk else "objectives"
        out_t = self.ttft_model._workload_batch(hwb, detail_t)
        out_p = self.tpot_model._workload_batch(hwb, "objectives")
        ys = torch.stack([out_t["latency"], out_p["latency"], hw["area_mm2"]],
                         dim=1)
        dom = (torch.argmax(out_t["stall"], dim=1).to(torch.int32)
               if self.stall_topk else None)
        return ys, dom

    def _step(self, carry: Dict[str, torch.Tensor], start: int, stop: int,
              filt: torch.Tensor):
        """One chunk step: unrank -> evaluate -> reduce."""
        if self._portfolio:
            return self._step_portfolio(carry, start, stop, filt)
        ids = self._iota + start
        valid = ids < stop
        idx = _unrank(torch.clamp(ids, max=self.size - 1), self._cards)
        ys, dom = self._sharded(self._chunk_eval, idx)        # (c, 3), (c,)
        ysm = torch.where(valid[:, None], ys, math.inf)

        # ---- reference-superiority count (exact, streaming) ----
        ref = self._ref
        sup = (ysm < ref[None, :]).all(dim=1)
        out = {"n_super": carry["n_super"] + sup.sum(),
               "n_eval": carry["n_eval"] + valid.sum()}

        # ---- running top-k per objective ----
        vals_o, ids_o = [], []
        for o in range(3):
            vals = torch.cat([carry["topk_val"][o], ysm[:, o]])
            cand = torch.cat([carry["topk_id"][o], ids])
            sel = _smallest_k(vals, self.topk)
            vals_o.append(vals[sel])
            ids_o.append(cand[sel])
        out["topk_val"] = torch.stack(vals_o)
        out["topk_id"] = torch.stack(ids_o)

        # ---- running top-k per dominant stall class (optional) ----
        if self.stall_topk:
            if self.stall_rank == "ref":
                # minimax objective ratio vs the reference (< 1 dominates)
                lat = (ysm / ref[None, :]).max(dim=1).values
            else:
                lat = ysm[:, 0]                               # rank by TTFT
            vals_c, ids_c = [], []
            for c in range(_N_STALL):
                lat_c = torch.where(dom == c, lat, math.inf)
                vals = torch.cat([carry["stall_topk_val"][c], lat_c])
                cand = torch.cat([carry["stall_topk_id"][c], ids])
                sel = _smallest_k(vals, self.stall_topk)
                vals_c.append(vals[sel])
                ids_c.append(torch.where(torch.isfinite(vals[sel]), cand[sel],
                                         -1))
            out["stall_topk_val"] = torch.stack(vals_c)
            out["stall_topk_id"] = torch.stack(ids_c)

        # ---- streaming Pareto reduction ----
        # archive filter (synced from host) + chunk-local killer rows:
        # per-objective minima and smallest log-products dominate most of
        # the chunk, so the cold-start chunk also reduces on device.
        L = self.local_filter
        locals_ = [ysm[_smallest_k(ysm[:, o], L)] for o in range(3)]
        logsum = _seq_sum(torch.log(torch.clamp(ysm, min=1e-300)))
        locals_.append(ysm[_smallest_k(logsum, L)])
        full_filt = torch.cat([filt] + locals_, dim=0)
        survivor = valid & ~_dominated_on_device(full_filt, ysm)
        return out, survivor, ys, ids

    # ---------------- portfolio (multi-scenario) chunk step ----------------
    def _chunk_eval_portfolio(self, idx: torch.Tensor):
        """(c, n_params) -> ((c, S, 3) per-scenario objectives, (c, S)
        dominant prefill stall or None).

        ONE op-term pass over the deduped union; every workload's rows are
        gathered back out of it into one (c, W, L) tensor with its own
        counts multiplied in, and summed left to right in op order — the
        stacked evaluator's arithmetic, so each scenario's objectives and
        stall classes equal the evaluator's and the pair sweep's bit for
        bit."""
        hw = derive_hardware(self.space.decode(idx))
        hwb = {kk: vv[:, None] for kk, vv in hw.items()}
        on = self._tables_on(idx.device)
        t = self._rep_model._op_terms(hwb, ops=on._uops)
        t_op = t["t_unit"][:, on._gather] * on._gcount       # (c, W, L)
        lat = _seq_sum(t_op)                                 # (c, W)
        c, S = idx.shape[0], len(self.scenarios)
        ys = torch.stack([lat[:, 0::2], lat[:, 1::2],
                          hw["area_mm2"][:, None].expand(c, S)], dim=2)
        dom = None
        if self.stall_topk:
            dom_u = _dominant_class(t)                       # (c, U)
            dom_p = dom_u[:, on._gather[0::2]]               # (c, S, L)
            t_p = t_op[:, 0::2]
            stall = torch.stack(
                [_seq_sum(torch.where(dom_p == k, t_p, 0.0))
                 for k in range(_N_STALL)], dim=2)           # (c, S, 4)
            dom = torch.argmax(stall, dim=2).to(torch.int32)
        return ys, dom

    def _robust_objectives(self, ys_s: torch.Tensor) -> torch.Tensor:
        """(c, S, 3) -> (c, 3) scalarized [robust_p, robust_d, area]: the
        reference-normalized latency aggregated across scenarios (worst
        case or geometric mean), plus the shared raw area."""
        S = len(self.scenarios)
        ratio = ys_s[:, :, :2] / self._refs_all[None, :S, :2]
        if self.robust == "worst":
            r = ratio.max(dim=1).values
        else:
            logs = torch.log(torch.clamp(ratio, min=1e-300))
            r = torch.exp(_seq_sum(logs.transpose(1, 2)) / S)
        return torch.cat([r, ys_s[:, 0, 2:3]], dim=1)

    def _step_portfolio(self, carry: Dict[str, torch.Tensor], start: int,
                        stop: int, filt: torch.Tensor):
        """One portfolio chunk step.  Group axis: S scenarios then the
        robust scalarization (index S); every reduction is batched across
        groups."""
        S = len(self.scenarios)
        S1, k, c = S + 1, self.topk, self.chunk_size
        ids = self._iota + start
        valid = ids < stop
        idx = _unrank(torch.clamp(ids, max=self.size - 1), self._cards)
        ys_s, dom = self._sharded(self._chunk_eval_portfolio,
                                  idx)                    # (c,S,3), (c,S)
        ys_r = self._robust_objectives(ys_s)              # (c,3)
        ys_all = torch.cat([ys_s, ys_r[:, None, :]], dim=1)
        ysm = torch.where(valid[:, None, None], ys_all, math.inf)
        refs_all = self._refs_all

        # ---- per-group reference-superiority counts ----
        sup = (ysm < refs_all[None, :, :]).all(dim=2)     # (c, S1)
        out = {"n_super": carry["n_super"] + sup.sum(dim=0),
               "n_eval": carry["n_eval"] + valid.sum()}

        # ---- running top-k, batched over (S1 x 3) rows ----
        rows = ysm.permute(1, 2, 0).reshape(S1 * 3, c)
        vals, cand = _merge_rows(
            torch.cat([carry["topk_val"].reshape(S1 * 3, k), rows], dim=1),
            torch.cat([carry["topk_id"].reshape(S1 * 3, k),
                       ids[None, :].expand(S1 * 3, c)], dim=1), k)
        out["topk_val"] = vals.reshape(S1, 3, k)
        out["topk_id"] = cand.reshape(S1, 3, k)

        # ---- per-scenario stall-class top-k (optional), batched ----
        if self.stall_topk:
            sk = self.stall_topk
            if self.stall_rank == "ref":
                rank = (ysm[:, :S, :] / refs_all[None, :S, :]).max(dim=2).values
            else:
                rank = ysm[:, :S, 0]                      # scenario prefill
            hit = dom[:, :, None] == torch.arange(
                _N_STALL, device=self.device)[None, None, :]
            masked = torch.where(hit, rank[:, :, None], math.inf)  # (c,S,4)
            rows = masked.permute(1, 2, 0).reshape(S * _N_STALL, c)
            vals, cand = _merge_rows(
                torch.cat([carry["stall_topk_val"].reshape(S * _N_STALL, sk),
                           rows], dim=1),
                torch.cat([carry["stall_topk_id"].reshape(S * _N_STALL, sk),
                           ids[None, :].expand(S * _N_STALL, c)], dim=1), sk)
            out["stall_topk_val"] = vals.reshape(S, _N_STALL, sk)
            out["stall_topk_id"] = torch.where(
                torch.isfinite(vals), cand, -1).reshape(S, _N_STALL, sk)

        # ---- streaming Pareto reduction, batched over all S1 groups ----
        # chunk-local killer rows: each group's per-objective minima plus
        # its best reference-normalized sum (4 rows a group)
        normsum = _seq_sum(ysm / refs_all[None, :, :])         # (c, S1)
        keys = torch.cat([ysm, normsum[:, :, None]], dim=2)    # (c, S1, 4)
        sel = torch.argmin(keys, dim=0)                        # (S1, 4)
        locals_ = torch.gather(ysm.transpose(0, 1), 1,
                               sel[:, :, None].expand(S1, 4, 3))
        full_filt = torch.cat([filt, locals_], dim=1)          # (S1, f+4, 3)
        all_le = torch.ones((c, S1, full_filt.shape[1]), dtype=torch.bool,
                            device=self.device)
        any_lt = torch.zeros_like(all_le)
        for j in range(3):
            fj = full_filt[None, :, :, j]
            yj = ysm[:, :, j][:, :, None]
            all_le &= fj <= yj
            any_lt |= fj < yj
        dominated = (all_le & any_lt).any(dim=2)               # (c, S1)
        survivor = valid[:, None] & ~dominated
        return out, survivor, ys_all, ids

    # ------------------------------------------------------------------
    @property
    def _n_groups(self) -> int:
        """Archive/filter groups: S scenarios + the robust front, or 1."""
        return len(self.scenarios) + 1 if self._portfolio else 1

    def _fresh_state(self, start: int) -> Dict:
        k, dev, f32, i32 = self.topk, self.device, torch.float32, torch.int32
        lead = (self._n_groups,) if self._portfolio else ()
        carry = {
            "n_super": torch.zeros(lead, dtype=torch.int64, device=dev),
            "n_eval": torch.zeros((), dtype=torch.int64, device=dev),
            "topk_val": torch.full(lead + (3, k), math.inf, dtype=f32,
                                   device=dev),
            "topk_id": torch.full(lead + (3, k), -1, dtype=i32, device=dev),
        }
        if self.stall_topk:
            slead = (len(self.scenarios),) if self._portfolio else ()
            shape = slead + (_N_STALL, self.stall_topk)
            carry["stall_topk_val"] = torch.full(shape, math.inf, dtype=f32,
                                                 device=dev)
            carry["stall_topk_id"] = torch.full(shape, -1, dtype=i32,
                                                device=dev)
        return {"next": int(start), "carry": carry,
                "archives": [ParetoArchive(3, capacity=self.archive_capacity)
                             for _ in range(self._n_groups)]}

    def _filter_from_archive(self, archive: ParetoArchive,
                             rows: Optional[int] = None) -> np.ndarray:
        """Up to `rows` (default filter_size) spread-out front rows, +inf
        padded."""
        rows = self.filter_size if rows is None else int(rows)
        filt = np.full((rows, 3), np.inf, dtype=np.float32)
        n = len(archive)
        if n:
            order = np.argsort(archive.y.sum(axis=1), kind="stable")
            take = order[np.linspace(0, n - 1, min(n, rows))
                         .astype(np.int64)]
            filt[: take.size] = archive.y[take]
        return filt

    def _filter_and_front(self, archives: List[ParetoArchive],
                          rows: Optional[int]
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The chunk's dominance filter on the device and, for one scenario,
        the archive's rows after it in the same copy (float32: the archive
        holds float32 objectives, so the copy is exact); a portfolio's
        (S+1, rows, 3) filters and no front."""
        if self._portfolio:
            filt = np.stack([self._filter_from_archive(a, rows)
                             for a in archives])
            return torch.as_tensor(filt, device=self.device), None
        a = archives[0]
        both = np.concatenate([self._filter_from_archive(a, rows),
                               a.y.astype(np.float32)])
        both = torch.as_tensor(both, device=self.device)
        return both[:self.filter_size], both[self.filter_size:]

    def fingerprint(self) -> str:
        """Identity of (space, workloads, knobs) — the reference's format."""
        if self._portfolio:
            parts = [str(self._cards), self.backend,
                     f"robust={self.robust}",
                     type(self._rep_model).__qualname__]
            for s in self.scenarios:
                parts.append(f"{s.name}="
                             + _workload_fingerprint(
                                 self.evaluator.models[s.prefill].wl)
                             + ":"
                             + _workload_fingerprint(
                                 self.evaluator.models[s.decode].wl))
        else:
            parts = [
                str(self._cards), self.backend,
                _workload_fingerprint(self.ttft_model.wl),
                _workload_fingerprint(self.tpot_model.wl),
                type(self.ttft_model).__qualname__,
                type(self.tpot_model).__qualname__,
            ]
        if self.stall_rank != "ttft":
            parts.append(f"stall_rank={self.stall_rank}")
        return "|".join(parts)

    # ------------------------------------------------------------------
    def run(self, start: int = 0, stop: Optional[int] = None, *,
            workers: int = 1,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            resume_from: Optional[str] = None,
            progress: bool = False,
            fault_plan=None,
            span_retry: Optional[RetryPolicy] = None) -> SweepResult:
        """Sweep flat ids [start, stop) and reduce to a SweepResult.

        ``workers=N`` splits the range into N contiguous chunk-aligned spans
        streamed on a thread pool (each with its own carry and archive, all
        on the engine's device); the host merge reproduces the one-process
        result exactly.  ``checkpoint_path``/``checkpoint_every`` persist
        partial state every N chunks, atomically (tmp + ``os.replace``) with
        a content digest; ``resume_from`` restores it (and overrides
        ``start``).  A corrupt or truncated checkpoint is quarantined
        (renamed ``*.quarantined`` with a RuntimeWarning) and the span
        restarts fresh; a checkpoint of another configuration refuses.
        Multi-worker runs keep one checkpoint file per worker
        (``{path}.w{i}of{N}``), so a resume must use the same range and
        worker count.

        ``fault_plan`` injects a seeded :class:`~repro_torch.distributed.
        faults.FaultPlan` into the span loop (worker = span index, dispatch
        = chunk ordinal): a ``crash`` event aborts the span, which is then
        REPLAYED under ``span_retry`` (default: 2 retries) from its own
        last checkpoint if one exists, from scratch otherwise; a ``slow``
        event sleeps its delay.  The streamed reduction is deterministic
        either way, so the merged result equals a fault-free run bit for
        bit.
        """
        stop = self.size if stop is None else min(int(stop), self.size)
        workers = max(1, int(workers))
        tr = self.tracer
        t0 = time.perf_counter()
        with tr.span("sweep.run", start=int(start), stop=int(stop),
                     workers=workers):
            parent = tr.current_ctx()
            if workers == 1:
                states = [self._run_span(
                    0, start, stop, checkpoint_path=checkpoint_path,
                    checkpoint_every=checkpoint_every,
                    resume_from=resume_from,
                    progress=progress, label="", fp_extra="",
                    fault_plan=fault_plan, span_retry=span_retry,
                    trace_parent=parent)]
            else:
                spans = self._worker_spans(start, stop, workers)
                n = len(spans)
                with ThreadPoolExecutor(max_workers=n,
                                        thread_name_prefix="sweep") as ex:
                    futs = []
                    for w, (s0, s1) in enumerate(spans):
                        suffix = f".w{w}of{n}"
                        futs.append(ex.submit(
                            self._run_span, w, s0, s1,
                            checkpoint_path=(f"{checkpoint_path}{suffix}"
                                             if checkpoint_path else None),
                            checkpoint_every=checkpoint_every,
                            resume_from=(f"{resume_from}{suffix}"
                                         if resume_from else None),
                            progress=progress, label=f"w{w}: ",
                            fp_extra=f"|span={s0}:{s1}",
                            fault_plan=fault_plan, span_retry=span_retry,
                            trace_parent=parent))
                    states = [f.result() for f in futs]
            self._c_runs.inc()
        with tr.span("sweep.reduce", parent=parent):
            return self._reduce_states(states, time.perf_counter() - t0)

    def _run_span(self, worker: int, start: int, stop: int, *,
                  checkpoint_path: Optional[str],
                  checkpoint_every: Optional[int],
                  resume_from: Optional[str], progress: bool,
                  label: str, fp_extra: str,
                  fault_plan=None,
                  span_retry: Optional[RetryPolicy] = None,
                  trace_parent=None) -> Dict:
        """One worker span, replayed on crash: a failed attempt resumes
        from the span's own atomic checkpoint when one exists, from
        scratch otherwise — deterministic either way.

        ``trace_parent`` is the sweep.run span ctx: worker spans run on
        pool threads, so parenting is explicit, not thread-inherited."""
        tr = self.tracer
        sp = (tr.start("sweep.span", parent=trace_parent, detached=True,
                       worker=worker, start=int(start), stop=int(stop))
              if tr.enabled else None)

        def attempt(resume: Optional[str]) -> Dict:
            return self._run_range(
                start, stop, checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, resume_from=resume,
                progress=progress, label=label, fp_extra=fp_extra,
                fault_plan=fault_plan, worker_slot=worker)

        try:
            if fault_plan is None and span_retry is None:
                with tr.activate(sp) if sp is not None else _NO_SPAN:
                    return attempt(resume_from)
            policy = (span_retry if span_retry is not None
                      else RetryPolicy(max_retries=2,
                                       retryable=(RuntimeError,)))
            resume = {"from": resume_from}

            def restore(attempt_no: int) -> None:
                if sp is not None:
                    sp.attrs["replays"] = attempt_no
                resume["from"] = None
                if checkpoint_path:
                    f = (checkpoint_path if checkpoint_path.endswith(".npz")
                         else f"{checkpoint_path}.npz")
                    if os.path.exists(f):
                        resume["from"] = checkpoint_path

            with tr.activate(sp) if sp is not None else _NO_SPAN:
                return run_with_retries(lambda: attempt(resume["from"]),
                                        restore, policy)
        except Exception as exc:
            if sp is not None:
                sp.attrs["error"] = str(exc)
                tr.finish(sp, status="error")
            raise
        finally:
            if sp is not None:
                tr.finish(sp)      # idempotent: no-op on the error path

    def _worker_spans(self, start: int, stop: int,
                      workers: int) -> List[Tuple[int, int]]:
        """Contiguous chunk-aligned spans covering [start, stop) — every
        worker streams the same chunk sequence a single process would."""
        n_chunks = -(-max(0, stop - start) // self.chunk_size)
        if n_chunks == 0:
            return [(start, stop)]
        per = -(-n_chunks // min(workers, n_chunks))
        spans, s = [], start
        while s < stop:
            e = min(stop, s + per * self.chunk_size)
            spans.append((s, e))
            s = e
        return spans

    def _absorb(self, archives: List[ParetoArchive], survivor: torch.Tensor,
                ys: torch.Tensor, ids: torch.Tensor,
                front: Optional[torch.Tensor]) -> None:
        """Bring a chunk's filter survivors into the host archives.  The
        span ``sweep.sync`` is where the host waits for the chunk's kernels
        (attr ``survivors``: the rows the exact pass screens; for one
        scenario also ``entered``: the rows the archive receives), ``sweep.
        insert`` the archive's update.

        One scenario: the survivors are screened on the device against
        each other and `front`, the archive's rows as the filter's copy
        carried them (:func:`pareto_reduce`), and only the entering rows
        and the dead incumbents' flags are copied over and applied.  A
        portfolio copies every row that survives in some group and inserts
        it into each group's archive."""
        tr = self.tracer
        if not self._portfolio:
            with tr.span("sweep.sync") as sp:
                head, rows = pareto_reduce(ys, front, keep=survivor, ids=ids,
                                           weights=self._key_weights)
                n, y_in, ids_in, dead = entrants(head, rows)
                if sp.recording:
                    sp.attrs["survivors"] = n
                    sp.attrs["entered"] = len(ids_in)
            with tr.span("sweep.insert"):
                archives[0].apply(y_in, ids_in, dead, n)
            return
        with tr.span("sweep.sync") as sp:
            keep = torch.nonzero(survivor.any(dim=1)).squeeze(1)
            n = keep.numel()
            if n:
                mask = survivor[keep].cpu().numpy()               # (r, S1)
                ys_np, ids_np = ys[keep].cpu().numpy(), ids[keep].cpu().numpy()
            if sp.recording:
                sp.attrs["survivors"] = n
        with tr.span("sweep.insert"):
            if not n:
                return
            for g, a in enumerate(archives):
                mg = mask[:, g]
                if mg.any():
                    a.insert(ys_np[mg, g, :], ids=ids_np[mg])

    def _run_range(self, start: int, stop: int, *,
                   checkpoint_path: Optional[str] = None,
                   checkpoint_every: Optional[int] = None,
                   resume_from: Optional[str] = None,
                   progress: bool = False, label: str = "",
                   fp_extra: str = "", fault_plan=None,
                   worker_slot: int = 0) -> Dict:
        """Stream one contiguous id span; returns its final state dict
        (plus the resumed-eval count under ``"resumed"``).  ``fault_plan``
        fires (``worker_slot``, chunk ordinal) before each chunk."""
        state = self._load(resume_from, fp_extra) if resume_from else None
        if state is None:          # no checkpoint, or quarantined as corrupt
            state = self._fresh_state(start)
        archives = state["archives"]
        n_eval_resumed = int(state["carry"]["n_eval"])
        rows = self._pf_rows if self._portfolio else None
        tr = self.tracer
        t0 = time.perf_counter()
        chunk_i = 0
        while state["next"] < stop:
            if fault_plan is not None:
                ev = fault_plan.fire(worker_slot, chunk_i)
                if ev is not None and ev.kind == "crash":
                    from repro_torch.distributed.faults import WorkerFault
                    raise WorkerFault(f"injected sweep crash: worker "
                                      f"{worker_slot} chunk {chunk_i}")
                if ev is not None and ev.kind == "slow":
                    time.sleep(ev.delay_s)
            t_chunk = time.perf_counter()
            with tr.span("sweep.chunk"):
                s = state["next"]
                with tr.span("sweep.filter"):
                    filt, front = self._filter_and_front(archives, rows)
                # ids >= stop are masked invalid on device, so a partial
                # final chunk (or a truncated-range sweep) stays exact
                with tr.span("sweep.step"):            # enqueues only
                    carry, survivor, ys, ids = self._step(state["carry"], s,
                                                          stop, filt)
                self._absorb(archives, survivor, ys, ids, front)
                # clamp to `stop`: a later resume with a larger stop must
                # re-visit the ids beyond it
                state["next"] = min(s + self.chunk_size, stop)
                state["carry"] = carry
                chunk_i += 1
                self._c_chunks.inc()
                self._c_ids.inc(state["next"] - s)
                self._h_chunk.observe(time.perf_counter() - t_chunk)
            if progress:
                here = int(carry["n_eval"]) - n_eval_resumed
                print(f"{label}sweep: {state['next']:,}/{stop:,} ids  "
                      f"front={len(archives[-1])}  "
                      f"{here / max(time.perf_counter() - t0, 1e-9):,.0f} "
                      f"ids/s", flush=True)
            if (checkpoint_path and checkpoint_every
                    and chunk_i % checkpoint_every == 0):
                self._save(checkpoint_path, state, fp_extra)
        if checkpoint_path:
            self._save(checkpoint_path, state, fp_extra)
        state["resumed"] = n_eval_resumed
        return state

    @staticmethod
    def _merge_topk_rows(states: List[Dict], key_val: str, key_id: str,
                         rows: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stable span-order merge of per-worker running top-k row blocks
        (each worker contributes a (..., rows, k) carry, flattened)."""
        vals = np.concatenate([_np(st["carry"][key_val]).reshape(rows, k)
                               for st in states], axis=1)
        cand = np.concatenate([_np(st["carry"][key_id]).reshape(rows, k)
                               for st in states], axis=1)
        order = np.argsort(vals, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(vals, order, axis=1),
                np.take_along_axis(cand, order, axis=1))

    def _merge_archives(self, archive_lists: List[List[ParetoArchive]],
                        g: int) -> Tuple[ParetoArchive, bool]:
        """Merge group g's archive across workers (exact host reduction)."""
        if len(archive_lists) == 1:
            a = archive_lists[0][g]
            return a, a.truncated
        archive = ParetoArchive(3, capacity=self.archive_capacity)
        truncated = False
        n_seen = 0
        for al in archive_lists:
            a = al[g]
            truncated |= a.truncated
            n_seen += a.n_seen
            if len(a):
                archive.insert(a.y, ids=a.ids)
        truncated |= archive.truncated
        archive.n_seen = n_seen
        archive.truncated = truncated
        return archive, truncated

    def _reduce_states(self, states: List[Dict],
                       seconds: float) -> SweepResult:
        """Merge worker states into one SweepResult.  The top-k merges are
        stable in span order, so ties resolve exactly as the one-process
        streaming reduction would."""
        S1, k = self._n_groups, self.topk
        S = S1 - 1 if self._portfolio else 1
        resumed = sum(st.get("resumed", 0) for st in states)
        n_eval = sum(int(st["carry"]["n_eval"]) for st in states)
        n_super = np.sum([_np(st["carry"]["n_super"]) for st in states],
                         axis=0).reshape(-1)
        topk_val, topk_id = self._merge_topk_rows(
            states, "topk_val", "topk_id", S1 * 3, k)
        topk_val = topk_val.reshape(S1, 3, k)
        topk_id = topk_id.reshape(S1, 3, k)
        stall_val = stall_id = None
        if self.stall_topk:
            sk = self.stall_topk
            stall_val, stall_id = self._merge_topk_rows(
                states, "stall_topk_val", "stall_topk_id", S * _N_STALL, sk)
            stall_id = np.where(np.isfinite(stall_val), stall_id, -1)
            stall_val = stall_val.reshape(S, _N_STALL, sk)
            stall_id = stall_id.reshape(S, _N_STALL, sk)
        archive_lists = [st["archives"] for st in states]

        def group_result(g: int, ref: np.ndarray, stall: Optional[int],
                         **extra) -> SweepResult:
            archive, truncated = self._merge_archives(archive_lists, g)
            order = np.argsort(archive.ids, kind="stable")
            return SweepResult(
                n_evaluated=n_eval, n_superior=int(n_super[g]),
                pareto_y=archive.y[order], pareto_ids=archive.ids[order],
                topk_val=topk_val[g], topk_ids=topk_id[g],
                ref_point=np.asarray(ref, dtype=np.float64).copy(),
                seconds=0.0, points_per_sec=0.0,
                archive_truncated=truncated,
                stall_topk_val=(None if stall is None else stall_val[stall]),
                stall_topk_ids=(None if stall is None else stall_id[stall]),
                archive_capacity=archive.capacity, **extra)

        with_stall = self.stall_topk > 0
        if self._portfolio:
            per = {s.name: group_result(i, self.ref_points[i],
                                        i if with_stall else None)
                   for i, s in enumerate(self.scenarios)}
            res = group_result(S, self.ref_point, None,
                               scenario_names=tuple(s.name
                                                    for s in self.scenarios),
                               robust=self.robust, per_scenario=per)
        else:
            res = group_result(0, self.ref_point, 0 if with_stall else None)
        res.seconds = seconds
        # resumed runs only time the ids swept in *this* process
        res.points_per_sec = (n_eval - resumed) / max(seconds, 1e-9)
        return res

    # ------------------------------------------------------------------
    def telemetry(self) -> dict:
        """Registry view of the engine's streaming counters."""
        return {
            "runs": int(self._c_runs.value()),
            "chunks": int(self._c_chunks.value()),
            "ids": int(self._c_ids.value()),
            "chunk_s": self._h_chunk.stats(),
        }

    # ------------------------------------------------------------------
    def _save(self, path: str, state: Dict, fp_extra: str = "") -> None:
        """Atomic checkpoint write: the payload (plus a sha256 content
        digest) lands in a ``.tmp`` sibling and is published with
        ``os.replace`` — a kill mid-write leaves the previous checkpoint
        intact, never a truncated one.  Carry tensors go as numpy arrays."""
        archives = state["archives"]
        carry = {kk: _np(vv) for kk, vv in state["carry"].items()}
        extra = {}
        if self.stall_topk:
            extra["stall_topk_val"] = carry["stall_topk_val"]
            extra["stall_topk_id"] = carry["stall_topk_id"]
        for g, a in enumerate(archives[1:], start=1):
            # portfolio: scenario archives 1..S1-1 ride alongside the first
            extra[f"archive{g}_y"] = a.y
            extra[f"archive{g}_ids"] = a.ids
            extra[f"archive{g}_seen"] = a.n_seen
            extra[f"archive{g}_truncated"] = a.truncated
        if self._portfolio:
            # the robust ref [1, 1, area] alone cannot detect changed
            # latency refs (its latency entries are 1 by construction)
            extra["ref_points"] = self.ref_points
        payload = dict(
            version=_FMT_VERSION,
            fingerprint=self.fingerprint() + fp_extra,
            next=state["next"],
            n_super=carry["n_super"],
            n_eval=carry["n_eval"],
            topk_val=carry["topk_val"],
            topk_id=carry["topk_id"],
            archive_y=archives[0].y,
            archive_ids=archives[0].ids,
            archive_seen=archives[0].n_seen,
            archive_truncated=archives[0].truncated,
            ref_point=self.ref_point,
            **extra,
        )
        payload["digest"] = _state_digest(payload)
        fname = path if str(path).endswith(".npz") else f"{path}.npz"
        tmp = fname + ".tmp"
        # write through an open handle: np.savez would append another
        # ``.npz`` to a bare tmp path, breaking the replace pairing
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, fname)

    @staticmethod
    def _quarantine(fname: str, reason: str) -> None:
        q = f"{fname}.quarantined"
        try:
            os.replace(fname, q)
        except OSError:
            q = "<could not rename>"
        warnings.warn(f"sweep checkpoint {fname} is corrupt ({reason}); "
                      f"quarantined to {q} — restarting the span fresh",
                      RuntimeWarning, stacklevel=3)

    def _load(self, path: str, fp_extra: str = "") -> Optional[Dict]:
        """Restore a checkpoint, or None after quarantining a corrupt /
        truncated file (config mismatches still raise: the file is VALID,
        resuming it would just be wrong)."""
        fname = path if str(path).endswith(".npz") else f"{path}.npz"
        try:
            with np.load(fname, allow_pickle=False) as zf:
                z = {k: np.asarray(zf[k]) for k in zf.files}
        except FileNotFoundError:
            raise
        except Exception as exc:
            self._quarantine(fname, f"unreadable: {exc}")
            return None
        if "digest" in z:
            stored = str(z["digest"])
            body = {k: v for k, v in z.items() if k != "digest"}
            if _state_digest(body) != stored:
                self._quarantine(fname, "content digest mismatch")
                return None
        if int(z["version"]) > _FMT_VERSION:
            raise ValueError(
                f"checkpoint format v{int(z['version'])} is newer than this "
                f"build's v{_FMT_VERSION}; refusing to resume")
        if str(z["fingerprint"]) != self.fingerprint() + fp_extra:
            raise ValueError(
                "checkpoint was produced by a different space/workload/"
                "backend configuration (or a different worker span); "
                "refusing to resume")
        if not np.allclose(np.asarray(z["ref_point"]), self.ref_point,
                           rtol=1e-6):
            raise ValueError(
                "checkpoint was produced with a different reference point; "
                "its superiority counts cannot be continued — refusing to "
                "resume")
        if self._portfolio:
            if "ref_points" not in z or not np.allclose(
                    np.asarray(z["ref_points"]), self.ref_points, rtol=1e-6):
                raise ValueError(
                    "checkpoint was produced with different per-scenario "
                    "reference points; its robust scalarization cannot be "
                    "continued — refusing to resume")

        def load_archive(prefix: str) -> ParetoArchive:
            a = ParetoArchive(3, capacity=self.archive_capacity)
            a.y = np.asarray(z[f"{prefix}_y"], dtype=np.float64)
            a.ids = np.asarray(z[f"{prefix}_ids"], dtype=np.int64)
            a.n_seen = int(z[f"{prefix}_seen"])
            a.truncated = bool(z[f"{prefix}_truncated"])
            if a.auto:
                a._peak = len(a)
                a.capacity = max(a.auto_floor,
                                 int(a.auto_headroom * a._peak))
            return a

        def dev(name: str) -> torch.Tensor:
            return torch.as_tensor(z[name], device=self.device)

        carry = {kk: dev(kk) for kk in ("n_super", "n_eval", "topk_val",
                                        "topk_id")}
        if self._portfolio and carry["topk_val"].dim() != 3:
            raise ValueError("checkpoint is single-scenario but this engine "
                             "sweeps a portfolio; refusing to resume")
        if self.stall_topk:
            if "stall_topk_val" not in z:
                raise ValueError(
                    "checkpoint carries no per-stall-class top-k state but "
                    "this engine was built with stall_topk > 0; refusing to "
                    "resume")
            if z["stall_topk_val"].shape[-1] != self.stall_topk:
                raise ValueError(
                    "checkpoint stall_topk width differs from this engine's; "
                    "refusing to resume")
            carry["stall_topk_val"] = dev("stall_topk_val")
            carry["stall_topk_id"] = dev("stall_topk_id")
        archives = [load_archive("archive")]
        archives += [load_archive(f"archive{g}")
                     for g in range(1, self._n_groups)]
        return {"next": int(z["next"]), "carry": carry, "archives": archives}


# --------------------------------------------------------------------------
# persistent oracle store: SweepResult artifacts on disk
# --------------------------------------------------------------------------
# A full-space sweep's SweepResult (front, top-k tables, stall seeds,
# per-scenario nests) is a few MB.  The oracle store memoizes exactly that:
# save/load one SweepResult npz, digested and atomically written like the
# checkpoints above, so a repeat OracleEvaluator over the same
# (fingerprint, stop, knobs) key is a load instead of a re-sweep.  The
# port's default store is its own directory: a port artifact is never read
# as the reference's under the same key, nor the other way round.

ORACLE_STORE_VERSION = 1
DEFAULT_ORACLE_STORE = os.path.join("~", ".cache", "repro_torch-oracle")

_RESULT_REQ = ("n_evaluated", "n_superior", "pareto_y", "pareto_ids",
               "topk_val", "topk_ids", "ref_point", "seconds",
               "points_per_sec", "archive_truncated")
_RESULT_OPT = ("stall_topk_val", "stall_topk_ids", "archive_capacity",
               "robust")


def _result_payload(res: SweepResult, prefix: str = "") -> Dict:
    out = {}
    for f in _RESULT_REQ:
        out[prefix + f] = np.asarray(getattr(res, f))
    for f in _RESULT_OPT:
        v = getattr(res, f)
        if v is not None:
            out[prefix + f] = np.asarray(v)
    if res.scenario_names is not None:
        out[prefix + "scenario_names"] = np.asarray(res.scenario_names)
    if res.per_scenario:
        # flatten scenario nests with positional prefixes (s0., s1., ...)
        for i, nm in enumerate(res.scenario_names):
            out.update(_result_payload(res.per_scenario[nm],
                                       prefix=f"{prefix}s{i}."))
    return out


def _result_from_payload(z: Dict, prefix: str = "") -> SweepResult:
    def opt(name, cast):
        key = prefix + name
        return cast(z[key]) if key in z else None

    names = None
    per = None
    if prefix + "scenario_names" in z:
        names = tuple(str(s) for s in np.asarray(z[prefix
                                                   + "scenario_names"]))
        if any(k.startswith(f"{prefix}s0.") for k in z):
            per = {nm: _result_from_payload(z, prefix=f"{prefix}s{i}.")
                   for i, nm in enumerate(names)}
    return SweepResult(
        n_evaluated=int(z[prefix + "n_evaluated"]),
        n_superior=int(z[prefix + "n_superior"]),
        pareto_y=np.asarray(z[prefix + "pareto_y"], dtype=np.float64),
        pareto_ids=np.asarray(z[prefix + "pareto_ids"], dtype=np.int64),
        topk_val=np.asarray(z[prefix + "topk_val"]),
        topk_ids=np.asarray(z[prefix + "topk_ids"]),
        ref_point=np.asarray(z[prefix + "ref_point"]),
        seconds=float(z[prefix + "seconds"]),
        points_per_sec=float(z[prefix + "points_per_sec"]),
        archive_truncated=bool(z[prefix + "archive_truncated"]),
        stall_topk_val=opt("stall_topk_val", np.asarray),
        stall_topk_ids=opt("stall_topk_ids", np.asarray),
        archive_capacity=opt("archive_capacity", int),
        robust=opt("robust", str),
        scenario_names=names,
        per_scenario=per,
    )


def save_sweep_result(path: str, result: SweepResult, *,
                      key: str = "") -> str:
    """Persist one SweepResult (atomic tmp + ``os.replace``, sha256
    content digest).  ``key`` ties the artifact to its producing
    configuration — loads with a different key refuse.  Returns the
    final filename."""
    payload = _result_payload(result)
    payload["store_version"] = np.asarray(ORACLE_STORE_VERSION)
    payload["oracle_key"] = np.asarray(key)
    payload["digest"] = _state_digest(payload)
    fname = path if str(path).endswith(".npz") else f"{path}.npz"
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, fname)
    return fname


def load_sweep_result(path: str, *, key: str = "") -> SweepResult:
    """Load a stored SweepResult; raises ``ValueError`` on a corrupt,
    truncated, newer-format or key-mismatched file (callers quarantine
    and re-sweep)."""
    fname = path if str(path).endswith(".npz") else f"{path}.npz"
    try:
        with np.load(fname, allow_pickle=False) as zf:
            z = {k: np.asarray(zf[k]) for k in zf.files}
    except FileNotFoundError:
        raise
    except Exception as exc:
        raise ValueError(f"unreadable oracle artifact: {exc}") from exc
    stored = str(z.pop("digest", ""))
    if _state_digest(z) != stored:
        raise ValueError("oracle artifact content digest mismatch")
    if int(z["store_version"]) > ORACLE_STORE_VERSION:
        raise ValueError(
            f"oracle artifact format v{int(z['store_version'])} is newer "
            f"than this build's v{ORACLE_STORE_VERSION}")
    if key and str(z["oracle_key"]) != key:
        raise ValueError("oracle artifact belongs to a different "
                         "configuration key")
    return _result_from_payload(z)
