"""Sharded multi-worker evaluation behind the Evaluator protocol.

:class:`ShardedEvaluator` splits one :class:`~repro_torch.perfmodel.
evaluator.EvalRequest`'s design batch into N contiguous shards, dispatches
them to a worker pool, and reassembles a single :class:`~repro_torch.
perfmodel.evaluator.PPAReport` **bit-identical** to the local
:class:`~repro_torch.perfmodel.evaluator.ModelEvaluator` on the same
request (every per-design value is row-wise — the torch ops, ``_seq_sum``
and the ``ppa_eval`` kernel compute each design row on its own — so shard
boundaries never change a float).

Worker pools
------------
``inline``   — the ``workers=1`` in-process fallback: evaluate on the
               caller's thread (zero overhead, always available).
``thread``   — a thread pool over ONE process-local evaluator; shards
               overlap their host pre/post work and queue their device
               work on the evaluator's device.  The default for
               ``workers > 1``.
``process``  — spawned worker processes, each constructing its own
               evaluator from a pickled (model class, workload, space,
               device type) spec — the multi-host template: nothing is
               shared but the request/report wire format.  A worker on a
               CUDA base opens its own CUDA context and loads the kernel
               library the parent built.
``device``   — thread pool that pins shard k to ``cuda:(k % D)`` (D CUDA
               devices, round-robin) under ``torch.cuda.device``; on one
               card every shard runs on ``cuda:0``, and on a CPU base on
               the base's device.
``socket``   — remote ``repro_torch.serve`` workers over TCP
               (``addresses=`` or ``membership=``); the cross-machine
               realization of the ``process`` template: the same pickled
               spec rides a :class:`~repro_torch.serve.wire.Hello`
               handshake and the same ``ShardPayload`` -> ``PPAReport``
               exchange rides length-prefixed frames.  Each worker
               rebuilds the evaluator on the spec's device type, so a
               ``backend="cuda"`` base gets workers that launch
               ``ppa_eval`` on their card.

Fault handling
--------------
A shard that raises — or whose report fails the receiver-side integrity
check (shape mismatch, non-finite or non-positive values: the
corrupt-payload guard) — is retried on a fresh worker under a
:class:`~repro_torch.runtime.fault.RetryPolicy` (budget + jittered
exponential backoff); a shard still pending past ``shard_timeout_s`` is
declared lost, its worker slot is evicted from the :class:`~repro_torch.
distributed.faults.WorkerRegistry` and a replacement re-registers
(``elastic=True`` additionally resizes the pool via
:func:`~repro_torch.runtime.elastic.plan_elastic_pool`).  A straggler — a
shard still pending after ``straggler_factor`` x the median
completed-shard time — is speculatively re-dispatched and whichever twin
finishes first wins (results are identical by construction, so the race
is benign).  A shard whose result has landed is never declared lost or
speculated, however late the clock reads.  ``worker_dispatches`` /
``retried`` / ``timeouts`` / ``corrupt_rejected`` /
``straggler_redispatches`` / ``resizes`` count the traffic.  A seeded
:class:`~repro_torch.distributed.faults.FaultPlan` (``fault_plan=``)
wraps the pool in a :class:`~repro_torch.distributed.faults.ChaosPool`
for deterministic failure injection without real process kills.
"""
from __future__ import annotations

import itertools
import math
import pickle
import time
from concurrent.futures import (FIRST_COMPLETED, Future, ProcessPoolExecutor,
                                ThreadPoolExecutor, wait)
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.distributed.faults import (ChaosPool, FaultPlan,
                                            QuotaExceeded, WorkerFault,
                                            WorkerRegistry)
from repro_torch.obs.metrics import Clock, MetricsRegistry
from repro_torch.obs.trace import NOOP
from repro_torch.perfmodel.evaluator import (EvalRequest, ModelEvaluator,
                                             PPAReport, as_evaluator)
from repro_torch.runtime.elastic import plan_elastic_pool
from repro_torch.runtime.fault import RetryPolicy

MODES = ("auto", "inline", "thread", "process", "device", "socket")


@dataclass(frozen=True)
class ShardPayload:
    """One shard of an EvalRequest on the worker wire format."""
    idx: np.ndarray
    detail: str
    workloads: Optional[Tuple[str, ...]]


def _eval_payload(evaluator, payload: ShardPayload) -> PPAReport:
    return evaluator.evaluate(EvalRequest(payload.idx, payload.detail,
                                          payload.workloads))


def concat_reports(parts: List[PPAReport]) -> PPAReport:
    """Reassemble shard reports into one batch report (shard order)."""
    first = parts[0]
    if len(parts) == 1:
        return first
    names = first.workloads

    def cat(field):
        return {nm: np.concatenate([getattr(p, field)[nm] for p in parts])
                for nm in names}

    rep = PPAReport(workloads=names, detail=first.detail,
                    area=np.concatenate([p.area for p in parts]),
                    latency=cat("latency"))
    if first.op_time is not None:
        rep.op_time = cat("op_time")
        rep.op_names = first.op_names
    if first.stall is not None:
        rep.stall = cat("stall")
        rep.op_class = cat("op_class")
    return rep


# ---------------------------------------------------------------------------
# worker pools
# ---------------------------------------------------------------------------

class _InlinePool:
    """workers=1 fallback: evaluate on the caller's thread."""
    mode = "inline"

    def __init__(self, base, workers: int = 1):
        self._base = base
        self.workers = 1

    def submit(self, payload: ShardPayload) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(_eval_payload(self._base, payload))
        except BaseException as exc:            # surfaced via fut.result()
            fut.set_exception(exc)
        return fut

    def resize(self, workers: int) -> None:
        pass                                   # always exactly one worker

    def close(self) -> None:
        pass


class _ThreadPool:
    """Thread workers over one shared process-local evaluator."""
    mode = "thread"

    def __init__(self, base, workers: int):
        self._base = base
        self.workers = int(workers)
        self._ex = ThreadPoolExecutor(max_workers=self.workers,
                                      thread_name_prefix="shard-eval")

    def submit(self, payload: ShardPayload) -> Future:
        return self._ex.submit(_eval_payload, self._base, payload)

    def resize(self, workers: int) -> None:
        """Swap in a fresh executor of the new size; in-flight tasks on the
        old one run to completion (their futures stay valid)."""
        workers = max(1, int(workers))
        if workers == self.workers:
            return
        old = self._ex
        self.workers = workers
        self._ex = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix="shard-eval")
        old.shutdown(wait=False)

    def close(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)


def _device_evaluator(base, dev: torch.device):
    """The evaluator a device-pool shard runs on `dev`: the base itself
    when it already lives there (one card, or a CPU base), else a
    :class:`ModelEvaluator` over the base's models on `dev`."""
    here = getattr(base, "device", None)
    if (here is None or here.type != "cuda" or torch.cuda.device_count() <= 1
            or not isinstance(base, ModelEvaluator)):
        return base
    return ModelEvaluator(base.models, tier=base.tier, backend=base.backend,
                          scenarios=base.scenarios, stacked=base.stacked,
                          device=dev)


class _DevicePool(_ThreadPool):
    """Thread workers, shard k pinned to ``cuda:(k % D)`` (round-robin);
    a CPU base keeps every shard on its own device."""
    mode = "device"

    def __init__(self, base, workers: int):
        super().__init__(base, workers)
        self._evaluators: Dict[str, object] = {}
        self._pin()
        self._rr = itertools.count()

    def _pin(self) -> None:
        here = getattr(self._base, "device", torch.device("cpu"))
        if here.type == "cuda":
            n = torch.cuda.device_count()
            self._devices = [torch.device("cuda", i % n)
                             for i in range(self.workers)]
        else:
            self._devices = [here] * self.workers
        for dev in self._devices:
            if str(dev) not in self._evaluators:
                self._evaluators[str(dev)] = _device_evaluator(self._base, dev)

    def resize(self, workers: int) -> None:
        super().resize(workers)
        self._pin()

    def submit(self, payload: ShardPayload) -> Future:
        dev = self._devices[next(self._rr) % self.workers]
        ev = self._evaluators[str(dev)]

        def task():
            if dev.type != "cuda":
                return _eval_payload(ev, payload)
            with torch.cuda.device(dev):
                return _eval_payload(ev, payload)

        return self._ex.submit(task)


# -- process pool: workers rebuild the evaluator from a pickled spec --------

_WORKER_EVALUATOR: Optional[ModelEvaluator] = None


def _worker_spec(base: ModelEvaluator) -> bytes:
    """(model class, workload, space, tier, backend, device type) —
    everything a spawned worker needs to reconstruct an equivalent
    evaluator from scratch, on the same kind of device as the base.

    These bytes are a cross-machine wire format (``repro_torch.serve``
    workers rebuild from the very same spec), so they are pinned to
    ``pickle.HIGHEST_PROTOCOL`` and covered by a round-trip regression
    test — change the layout and :func:`evaluator_from_spec` together.
    """
    return pickle.dumps({
        "models": {nm: (type(m), m.wl) for nm, m in base.models.items()},
        "space": base.space,
        "tier": base.tier,
        "backend": base.backend,
        "scenarios": getattr(base, "scenarios", None),
        "stacked": getattr(base, "stacked", None),
        "device": base.device.type,
    }, protocol=pickle.HIGHEST_PROTOCOL)


def evaluator_from_spec(spec_bytes: bytes, loads=None) -> ModelEvaluator:
    """Rebuild the evaluator a :func:`_worker_spec` blob describes — the
    worker half of the wire contract, shared by the process pool
    initializer and the ``repro_torch.serve`` socket daemon.

    ``loads`` overrides the deserializer: hardened workers pass
    :func:`repro_torch.serve.codec.restricted_loads` so spec bytes
    resolve only allowlisted constructors; the default raw
    ``pickle.loads`` is the single-trust-domain process-pool path.  A
    spec naming ``cuda`` raises where CUDA is missing (the port never
    falls back to the CPU).
    """
    spec = pickle.loads(spec_bytes) if loads is None else loads(spec_bytes)
    models = {nm: cls(wl, spec["space"])
              for nm, (cls, wl) in spec["models"].items()}
    return ModelEvaluator(models, tier=spec["tier"],
                          backend=spec["backend"],
                          scenarios=spec.get("scenarios"),
                          stacked=spec.get("stacked"),
                          device=spec.get("device", "cpu"))


def _process_init(spec_bytes: bytes) -> None:
    global _WORKER_EVALUATOR
    _WORKER_EVALUATOR = evaluator_from_spec(spec_bytes)


def _process_eval(payload: ShardPayload) -> PPAReport:
    return _eval_payload(_WORKER_EVALUATOR, payload)


class _ProcessPool:
    """Spawned local processes — the multi-host sharding template."""
    mode = "process"

    def __init__(self, base, workers: int):
        if not isinstance(base, ModelEvaluator):
            raise TypeError("mode='process' needs a ModelEvaluator base "
                            "(workers rebuild it from its models)")
        import multiprocessing as mp
        self.workers = int(workers)
        self._spec = _worker_spec(base)
        self._mp_context = mp.get_context("spawn")
        self._ex = self._make_executor()

    def _make_executor(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(
            max_workers=self.workers,
            mp_context=self._mp_context,
            initializer=_process_init, initargs=(self._spec,))

    def submit(self, payload: ShardPayload) -> Future:
        return self._ex.submit(_process_eval, payload)

    def resize(self, workers: int) -> None:
        workers = max(1, int(workers))
        if workers == self.workers:
            return
        old = self._ex
        self.workers = workers
        self._ex = self._make_executor()
        old.shutdown(wait=False)

    def close(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)


_POOLS = {"inline": _InlinePool, "thread": _ThreadPool,
          "process": _ProcessPool, "device": _DevicePool}


# ---------------------------------------------------------------------------
# the sharded evaluator
# ---------------------------------------------------------------------------

class ShardedEvaluator:
    """Fan one EvalRequest across N workers; gather one PPAReport.

    Implements the :class:`~repro_torch.perfmodel.evaluator.Evaluator`
    protocol, so every existing consumer (``ExplorationEngine``,
    ``CampaignRunner``, the baselines, an :class:`~repro_torch.distributed.
    service.EvalService`) can be handed a sharded evaluator unchanged.

    Parameters
    ----------
    base:
        The local evaluator each worker runs (``mode='process'`` workers
        rebuild an equivalent one from its models, on the same kind of
        device).
    workers:
        Shard fan-out.  ``workers=1`` always evaluates in-process.
    mode:
        One of :data:`MODES` (``auto`` = ``inline`` for one worker,
        ``thread`` otherwise).  ``socket`` dispatches to remote
        ``repro_torch.serve`` worker daemons and requires
        ``addresses=`` or ``membership=``.
    addresses:
        ``mode='socket'`` only: ``[(host, port), ...]`` of running
        ``python -m repro_torch.serve.worker`` daemons.  ``workers``
        defaults to ``len(addresses)`` and is clamped to it; the pool
        owns the liveness registry (heartbeats ride the wire), and this
        evaluator shares it instead of creating its own.
    membership:
        ``mode='socket'`` only: a :class:`~repro_torch.serve.membership.
        MembershipView` workers announce to; the fleet follows its
        leases between requests.
    insecure / keyring / key_id / ssl_context / max_frame_bytes:
        ``mode='socket'`` transport options, passed to
        :class:`~repro_torch.serve.pool.SocketPool` (legacy pickle
        frames, HMAC signing keys, TLS, the frame bound).
    min_shard_rows:
        Never split below this many designs per shard — tiny batches stay
        on one worker instead of paying fan-out overhead.
    retries:
        Re-dispatches allowed per shard after worker failures (shorthand
        for the default ``retry_policy``'s budget).
    retry_policy:
        Full :class:`~repro_torch.runtime.fault.RetryPolicy` controlling
        the per-shard retry budget and the jittered exponential backoff
        slept before each re-dispatch.  Defaults to ``RetryPolicy(
        max_retries=retries, retryable=(Exception,))`` — any shard failure
        retryable, no backoff.
    shard_timeout_s:
        Absolute deadline per shard dispatch, read on ``clock``.  A
        dispatch still pending past it is declared LOST (not merely
        slow): the future is abandoned, the worker slot evicted, and the
        shard re-dispatched, consuming retry budget.  ``None`` (default)
        disables timeouts.
    straggler_factor / straggler_min_s:
        A pending shard is speculatively re-dispatched once it has been
        outstanding longer than ``max(straggler_min_s, factor x median
        completed-shard time)``.  ``speculate=False`` disables it.
        Speculation never consumes the failure-retry budget — the twin
        carries the same attempt number as its original.
    cold_straggler_s:
        Speculation deadline for the FIRST wave, before any shard has
        completed (no median exists yet to scale from) — generous by
        default so a cold first launch never triggers spurious twins.
    fault_plan:
        Optional :class:`~repro_torch.distributed.faults.FaultPlan`; wraps
        the pool in a :class:`~repro_torch.distributed.faults.ChaosPool`
        so the whole retry / timeout / eviction path can be exercised
        deterministically.
    elastic / max_workers:
        ``elastic=True`` resizes the pool after dead-worker eviction via
        :func:`~repro_torch.runtime.elastic.plan_elastic_pool` (bounded by
        ``max_workers``, default the initial ``workers``).
    validate:
        Receiver-side shard integrity check (row count, finite, strictly
        positive area/latency); a failing shard raises
        :class:`~repro_torch.distributed.faults.WorkerFault` into the retry
        path.  On by default.
    registry / tracer / clock:
        Observability hooks (:mod:`repro_torch.obs`): a shared
        :class:`~repro_torch.obs.metrics.MetricsRegistry` for the traffic
        instruments, a :class:`~repro_torch.obs.trace.Tracer` for
        per-shard causal spans (default: the free no-op tracer), and an
        injectable clock (deadlines, straggler thresholds, liveness) for
        deterministic timing under test.  All three are also handed to
        the socket pool so wire spans and heartbeat RTT land in the same
        registry/trace.
    """

    def __init__(self, base, *, workers: Optional[int] = None,
                 mode: str = "auto",
                 addresses: Optional[List[Tuple[str, int]]] = None,
                 membership=None,
                 insecure: bool = False,
                 keyring=None, key_id: Optional[str] = None,
                 ssl_context=None,
                 max_frame_bytes: Optional[int] = None,
                 min_shard_rows: int = 1, retries: int = 2,
                 retry_policy: Optional[RetryPolicy] = None,
                 shard_timeout_s: Optional[float] = None,
                 straggler_factor: float = 4.0, straggler_min_s: float = 0.05,
                 cold_straggler_s: float = 60.0, speculate: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 heartbeat_timeout_s: float = 30.0,
                 elastic: bool = False, max_workers: Optional[int] = None,
                 validate: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None, clock: Optional[Clock] = None):
        base = as_evaluator(base)
        if not hasattr(base, "models"):
            raise TypeError("ShardedEvaluator needs a model-backed evaluator")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if addresses is not None and mode != "socket":
            raise ValueError("addresses= is only meaningful with "
                             "mode='socket'")
        if membership is not None and mode != "socket":
            raise ValueError("membership= is only meaningful with "
                             "mode='socket'")
        self.base = base
        self.space = base.space
        self.tier = base.tier
        if workers is None:
            workers = len(addresses) if addresses else 2
        self.workers = max(1, int(workers))
        if mode == "socket":
            if not addresses and membership is None:
                raise ValueError("mode='socket' needs addresses="
                                 "[(host, port), ...] of running "
                                 "`python -m repro_torch.serve.worker` "
                                 "daemons or membership= (a MembershipView "
                                 "workers announce to)")
            if addresses:
                self.workers = min(self.workers, len(addresses))
        elif self.workers == 1:
            mode = "inline"                    # the in-process fallback
        elif mode == "auto":
            mode = "thread"
        self.mode = mode
        # observability: one registry/tracer/clock shared with the pool so
        # heartbeat RTT and wire spans land next to the shard instruments
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NOOP
        self._clock: Clock = clock if clock is not None else time.monotonic
        if mode == "socket":
            from repro_torch.serve.pool import SocketPool
            raw_pool = SocketPool(base,
                                  self.workers if addresses else None,
                                  addresses=addresses,
                                  membership=membership,
                                  insecure=insecure, keyring=keyring,
                                  key_id=key_id, ssl_context=ssl_context,
                                  max_frame_bytes=max_frame_bytes,
                                  heartbeat_timeout_s=heartbeat_timeout_s,
                                  metrics=self.metrics, tracer=self.tracer,
                                  clock=self._clock)
            if membership is not None:
                # lease-driven topology: the pool's view of the fleet is
                # authoritative, not the construction-time count
                self.workers = max(1, raw_pool.workers)
        else:
            raw_pool = _POOLS[mode](base, self.workers)
        self._raw_pool = raw_pool
        self._pool = (ChaosPool(raw_pool, fault_plan)
                      if fault_plan is not None else raw_pool)
        self.fault_plan = fault_plan
        self.membership = membership
        self.min_shard_rows = max(1, int(min_shard_rows))
        self.retries = int(retries)
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy(max_retries=self.retries,
                                              retryable=(Exception,)))
        self.shard_timeout_s = (None if shard_timeout_s is None
                                else float(shard_timeout_s))
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_s = float(straggler_min_s)
        self.cold_straggler_s = float(cold_straggler_s)
        self.speculate = bool(speculate)
        self.validate = bool(validate)
        self.elastic = bool(elastic)
        self.max_workers = max(self.workers, int(max_workers)
                               if max_workers is not None else self.workers)
        # worker liveness: slots 0..workers-1, beaten on shard completion.
        # A socket pool owns its registry (wire heartbeats + reconnects
        # drive it) and this evaluator shares it; local pools get a fresh
        # one driven by shard completions.
        pool_registry = getattr(raw_pool, "registry", None)
        self._pool_owns_registry = pool_registry is not None
        self.registry = (pool_registry if pool_registry is not None
                         else WorkerRegistry(timeout_s=heartbeat_timeout_s,
                                             now=self._clock))
        for s in range(self.workers):
            self.registry.register(s)
        self._dispatch_no = 0               # round-robin slot attribution
        # traffic instruments (int-valued properties below keep the
        # `ev.retried`-style attribute surface)
        m = self.metrics
        self._c_dispatches = m.counter(
            "sharded_dispatches", "logical fused requests served")
        self._c_worker_dispatches = m.counter(
            "sharded_worker_dispatches", "shard tasks sent to workers")
        self._c_retried = m.counter(
            "sharded_retried", "shard retries after failures")
        self._c_straggler = m.counter(
            "sharded_straggler_redispatches", "speculative twin dispatches")
        self._c_timeouts = m.counter(
            "sharded_timeouts", "shards declared lost past the deadline")
        self._c_corrupt = m.counter(
            "sharded_corrupt_rejected", "shards failing the integrity check")
        self._c_resizes = m.counter(
            "sharded_resizes", "elastic pool resizes applied")
        self._c_quota_rerouted = m.counter(
            "sharded_quota_rerouted",
            "shards rerouted after worker quota refusals")
        self._h_shard = m.histogram(
            "sharded_shard_s", "completed-shard wall time (s) by worker slot",
            labelnames=("slot",))

    # -- traffic counters (registry-backed int attributes) ---------------
    @property
    def dispatches(self) -> int:
        return int(self._c_dispatches.value())

    @property
    def worker_dispatches(self) -> int:
        return int(self._c_worker_dispatches.value())

    @property
    def retried(self) -> int:
        return int(self._c_retried.value())

    @property
    def straggler_redispatches(self) -> int:
        return int(self._c_straggler.value())

    @property
    def timeouts(self) -> int:
        return int(self._c_timeouts.value())

    @property
    def corrupt_rejected(self) -> int:
        return int(self._c_corrupt.value())

    @property
    def resizes(self) -> int:
        return int(self._c_resizes.value())

    @property
    def quota_rerouted(self) -> int:
        return int(self._c_quota_rerouted.value())

    # -- identity / protocol surface -----------------------------------
    @property
    def workloads(self) -> Tuple[str, ...]:
        return self.base.workloads

    @property
    def models(self):
        return self.base.models

    @property
    def backend(self):
        return getattr(self.base, "backend", None)

    @property
    def scenarios(self):
        return getattr(self.base, "scenarios", None)

    @property
    def device(self) -> torch.device:
        """The base's device: sweeps and views built over this evaluator
        run there."""
        return self.base.device

    # -- public API -----------------------------------------------------
    def evaluate(self, request: EvalRequest) -> PPAReport:
        if self.membership is not None:
            # lease-driven fleets grow/shrink between requests: sync the
            # pool's slot view and shard to the CURRENT worker count
            self._raw_pool._sync_membership()
            self.workers = max(1, self._raw_pool.workers)
        idx = np.atleast_2d(np.asarray(request.idx, dtype=np.int32))
        n = idx.shape[0]
        n_shards = min(self.workers, max(1, n // self.min_shard_rows))
        self._c_dispatches.inc()
        tr = self.tracer
        with tr.span("sharded.evaluate", rows=n, mode=self.mode,
                     detail=request.detail) as sp:
            if ((self.mode == "inline" or n_shards <= 1)
                    and self.fault_plan is None and self.mode != "socket"):
                self._c_worker_dispatches.inc()
                return self.base.evaluate(
                    EvalRequest(idx, request.detail, request.workloads))
            # under a fault plan even single-shard requests route through
            # the pool so injection + recovery cover the inline path too;
            # socket mode ALWAYS rides the pool — offloading is the point
            payloads = [ShardPayload(s, request.detail, request.workloads)
                        for s in np.array_split(idx, max(1, n_shards))]
            if tr.enabled:
                sp.attrs["shards"] = len(payloads)
            parts = self._gather(payloads)
            with tr.span("sharded.reassemble", shards=len(parts)):
                return concat_reports(parts)

    def objectives(self, idx: np.ndarray) -> np.ndarray:
        return self.evaluate(EvalRequest(idx, detail="objectives")).objectives

    def ppa(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="ppa"))

    def stalls(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="stalls"))

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        return self.objectives(idx)

    def close(self) -> None:
        self._pool.close()

    def resize(self, workers: int) -> None:
        """Resize the worker pool; replacement slots RE-register with the
        liveness registry, removed slots are evicted."""
        workers = max(1, min(int(workers), self.max_workers))
        if workers == self.workers:
            return
        old = self.workers
        self._pool.resize(workers)
        self.workers = workers
        self._c_resizes.inc()
        if self._pool_owns_registry:
            return                     # the pool's reconnect/close path
        for s in range(workers):       # maintains its registry itself
            self.registry.register(s)          # fresh/replacement slots
        for s in range(workers, old):
            self.registry.mark_dead(s)         # shrunk-away slots
        self.registry.evict_dead()

    # -- fault plumbing --------------------------------------------------
    def _check_shard(self, payload: ShardPayload, rep: PPAReport) -> None:
        """Receiver-side integrity check: a corrupted payload (wrong row
        count, non-finite or non-positive values) raises WorkerFault into
        the retry path instead of silently poisoning the merged report."""
        n = payload.idx.shape[0]
        area = np.asarray(rep.area)
        ok = (area.shape[0] == n and bool(np.isfinite(area).all())
              and bool((area > 0).all()))
        if ok:
            for nm in rep.workloads:
                lat = np.asarray(rep.latency[nm])
                if (lat.shape[0] != n or not np.isfinite(lat).all()
                        or bool((lat <= 0).any())):
                    ok = False
                    break
        if not ok:
            self._c_corrupt.inc()
            raise WorkerFault(f"corrupt shard payload rejected "
                              f"({n} rows, mode={self.mode!r})")

    def _on_worker_failure(self, slot: int, outstanding: int) -> None:
        """Crash/timeout attribution: evict the slot, re-register its
        replacement (pools backfill workers), optionally resize."""
        self.registry.mark_dead(slot)
        self.registry.evict_dead()
        if self.elastic:
            plan = plan_elastic_pool(len(self.registry), outstanding,
                                     min_workers=1,
                                     max_workers=self.max_workers)
            if plan.workers != self.workers:
                self.resize(plan.workers)
                return
        if self._pool_owns_registry:
            # the socket pool re-registers the slot itself when the
            # connection actually comes back — a blind re-register here
            # would claim liveness the wire has not proven
            return
        # executor pools replace dead workers transparently — the slot's
        # replacement re-registers under the same id
        self.registry.register(slot)

    # -- shard dispatch: retry + timeout + straggler speculation ---------
    def _gather(self, payloads: List[ShardPayload]) -> List[PPAReport]:
        policy = self.retry_policy
        clock = self._clock
        tr = self.tracer
        results: List[Optional[PPAReport]] = [None] * len(payloads)
        # fut -> (shard, attempt, worker slot, absolute deadline)
        pending: Dict[Future, Tuple[int, int, int, float]] = {}
        started: Dict[Future, float] = {}
        # fut -> detached shard span (finished out of order as futures
        # resolve; every exit path closes it: ok / error / lost)
        spans: Dict[Future, object] = {}
        speculated: set = set()
        durations: List[float] = []
        quota_reroutes: Dict[int, int] = {}
        parent_ctx = tr.current_ctx()          # the sharded.evaluate span

        def submit(i: int, attempt: int) -> None:
            slot = self._dispatch_no % self.workers
            self._dispatch_no += 1
            if tr.enabled:
                sp = tr.start("shard", detached=True, parent=parent_ctx,
                              shard=i, attempt=attempt, slot=slot)
                # current during the pool submit, so the wire span
                # (socket mode) parents under this shard attempt
                with tr.activate(sp):
                    fut = self._pool.submit(payloads[i])
                spans[fut] = sp
            else:
                fut = self._pool.submit(payloads[i])
            now = clock()
            started[fut] = now
            deadline = (now + self.shard_timeout_s
                        if self.shard_timeout_s else math.inf)
            pending[fut] = (i, attempt, slot, deadline)
            self._c_worker_dispatches.inc()

        def close_span(fut: Future, status: str, reason: str = "") -> None:
            sp = spans.pop(fut, None)
            if sp is None:
                return
            if status == "lost":
                tr.lose(sp, reason)
            else:
                if reason:
                    sp.attrs["error"] = reason
                tr.finish(sp, status=None if status == "ok" else status)

        def fail(i: int, attempt: int, slot: int, exc: Optional[BaseException],
                 what: str) -> None:
            if isinstance(exc, QuotaExceeded) and \
                    quota_reroutes.get(i, 0) < max(1, self.workers):
                # the worker refused by POLICY — it is healthy and the
                # shard is fine: reroute to the next slot at the same
                # attempt, no backoff, no retry budget, no eviction
                # (bounded per shard so an all-refusing fleet still
                # falls through to the normal retry/raise path)
                quota_reroutes[i] = quota_reroutes.get(i, 0) + 1
                self._c_quota_rerouted.inc()
                submit(i, attempt)
                return
            self._on_worker_failure(
                slot, sum(1 for r in results if r is None))
            if attempt >= policy.max_retries:
                raise RuntimeError(
                    f"shard {i} {what} after {attempt + 1} attempts "
                    f"on the {self.mode!r} pool") from exc
            self._c_retried.inc()
            d = policy.delay(attempt)
            if d:
                time.sleep(d)
            submit(i, attempt + 1)

        for i in range(len(payloads)):
            submit(i, 0)
        try:
            while any(r is None for r in results):
                now = clock()
                # next wake-up: earliest shard deadline or straggler threshold
                thresh = (max(self.straggler_min_s, self.straggler_factor
                              * float(np.median(durations)))
                          if durations else self.cold_straggler_s)
                wake = math.inf
                for fut, (i, _a, _s, deadline) in pending.items():
                    if results[i] is not None:
                        continue
                    wake = min(wake, deadline)
                    if self.speculate and i not in speculated:
                        wake = min(wake, started[fut] + thresh)
                timeout = None if wake is math.inf else max(0.0, wake - now)
                done, _ = wait(list(pending), timeout=timeout,
                               return_when=FIRST_COMPLETED)
                now = clock()
                for fut in done:
                    i, attempt, slot, _deadline = pending.pop(fut)
                    t0 = started.pop(fut, now)
                    if results[i] is not None:
                        # a faster twin already landed; this one's work is moot
                        close_span(fut, "lost", "lost the twin race")
                        continue
                    try:
                        rep = fut.result()
                        if self.validate:
                            self._check_shard(payloads[i], rep)
                    except policy.retryable as exc:
                        close_span(fut, "error", str(exc))
                        fail(i, attempt, slot, exc, "failed")
                        continue
                    close_span(fut, "ok")
                    results[i] = rep
                    durations.append(now - t0)
                    self._h_shard.observe(now - t0, slot=slot)
                    self.registry.beat(slot)
                # shard timeouts: the dispatch is LOST, not merely slow —
                # abandon the future, evict the slot, consume retry budget.
                # A future that resolved after wait() returned is not lost: the
                # next wait() collects it, whatever the clock reads by then
                for fut, (i, attempt, slot, deadline) in list(pending.items()):
                    if results[i] is not None or now < deadline or fut.done():
                        continue
                    pending.pop(fut)
                    started.pop(fut, None)
                    fut.cancel()
                    close_span(fut, "lost", "shard timeout")
                    self._c_timeouts.inc()
                    fail(i, attempt, slot, None, "timed out")
                # straggler speculation: one twin per slow shard, at the SAME
                # attempt (speculation never consumes the retry budget)
                if self.speculate:
                    for fut, (i, attempt, _s, _d) in list(pending.items()):
                        if (results[i] is None and i not in speculated
                                and not fut.done()
                                and now - started.get(fut, now) >= thresh):
                            speculated.add(i)
                            self._c_straggler.inc()
                            submit(i, attempt)
        finally:
            # twins that lost the race, or every shard still in flight
            # when a shard's retry budget ran out: abandoned, their
            # spans closed as lost so the trace stays complete
            reason = ("abandoned twin" if all(r is not None for r in results)
                      else "abandoned: the request failed")
            for fut in pending:
                fut.cancel()
                close_span(fut, "lost", reason)
        return results
