"""Async evaluation service: request queue + coalescing batcher + futures.

:class:`EvalService` generalizes :meth:`~repro_torch.core.explore.
ExplorationEngine.prefetch` from "one runner batches its own candidates"
to "ANY concurrent clients coalesce": K campaigns, interleaved baseline
sweeps and benchmark probes all :meth:`~EvalService.submit` their
:class:`~repro_torch.perfmodel.evaluator.EvalRequest`\\ s, and each
:meth:`~EvalService.tick` drains the queue into ONE fused dispatch on the
underlying evaluator — deduplicating design rows across clients and
resolving every request's future from the shared result.

* **Coalescing**: a tick evaluates the union of queued rows once, at the
  maximum detail level any queued request asked for (``objectives`` <
  ``ppa`` < ``stalls`` — latencies are bit-identical across levels, so
  higher detail only adds fields).
* **Shared cross-client cache**: every evaluated design row lands in ONE
  :class:`~repro_torch.perfmodel.evaluator.RowCache`
  (``service.row_cache``) — the same object :class:`~repro_torch.core.explore.ExplorationEngine` reads
  when its evaluator is a service, so there is one report cache in the
  process, not two.  A request whose rows are all cached at sufficient
  detail resolves at :meth:`~EvalService.submit` time with NO dispatch,
  whoever evaluated it first.
* **QoS tiers + per-client fairness**: requests queue per
  ``(tier, client)`` (``submit(..., tier="interactive" | "batch" |
  "scavenger", client=...)``) and the tick drains tiers by WEIGHTED
  DEFICIT round-robin (default weights 8 : 3 : 1): each drain pass
  credits every backlogged tier its weight and serves the tier with the
  largest accumulated credit, debiting the rows served — so interactive
  campaign steps preempt bulk sweep traffic *proportionally*, not
  absolutely.  An anti-starvation floor grants every backlogged tier one
  request per tick before weights apply, so scavenger throughput stays
  > 0 under saturating interactive load.  Within a tier, clients are
  served round-robin, one request per client per pass, rotating the
  starting client — a chatty client cannot starve its tier peers.
  ``telemetry()["tiers"]`` reports per-tier served/queued counts and
  p50/p99 queue-to-resolve latency.
* **Evaluator protocol**: the service itself implements ``evaluate`` /
  ``objectives`` / ``workloads`` — hand it to ``CampaignRunner``,
  ``LuminaDSE``, a baseline runner or a bench wherever an ``Evaluator``
  is expected.  A synchronous ``evaluate`` call self-ticks when its rows
  are not already resolved.
* **Ticking**: call :meth:`tick` explicitly (deterministic — what the
  round-driven ``CampaignRunner`` does), or construct with
  ``autostart=True`` for a background batcher thread that ticks after a
  short coalescing window.

The underlying evaluator may itself be a :class:`~repro_torch.distributed.
sharded.ShardedEvaluator`, composing "coalesce across clients" with
"shard across workers".  Every rung of the degradation ladder runs on the
evaluator's own device and backend: the proxy rung of a ``cuda``
evaluator is its ``objectives`` dispatch, which launches ``ppa_eval``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import Clock, CounterView, MetricsRegistry
from repro_torch.obs.trace import NOOP
from repro_torch.perfmodel.evaluator import (DETAILS, EvalRequest, PPAReport,
                                             RowCache, as_evaluator)

_DETAIL_LEVEL = {name: i for i, name in enumerate(DETAILS)}


DEGRADE_RUNGS = ("narrow", "proxy", "cached")

# QoS tiers, highest priority first; the drain order of the
# anti-starvation floor and the tie-break order of the deficit scheduler
QOS_TIERS = ("interactive", "batch", "scavenger")

# default weighted-deficit drain shares (rows per credit pass)
DEFAULT_TIER_WEIGHTS = {"interactive": 8.0, "batch": 3.0, "scavenger": 1.0}

# cap banked credit at this many times the tier weight: an idle tier can
# bank a short burst of priority, not an unbounded IOU
_DEFICIT_BURST = 64.0


@dataclass
class _Pending:
    idx: np.ndarray                      # (n, n_params) int32
    detail: str
    names: Tuple[str, ...]
    future: Future
    client: str
    tier: str = "batch"
    deadline: Optional[float] = None     # absolute monotonic deadline
    t_submit: float = 0.0                # monotonic submit time (latency)
    span: object = None                  # detached service.request span


def _assemble(rows: List[PPAReport], names: Tuple[str, ...],
              detail: str) -> PPAReport:
    """Stack cached single-row reports into one response, restricted to the
    request's workloads and demoted to its detail level."""
    rep = PPAReport(
        workloads=names, detail=detail,
        area=np.concatenate([r.area for r in rows]),
        latency={nm: np.concatenate([r.latency[nm] for r in rows])
                 for nm in names})
    if detail in ("ppa", "stalls"):
        rep.op_time = {nm: np.concatenate([r.op_time[nm] for r in rows])
                       for nm in names}
        rep.op_names = {nm: rows[0].op_names[nm] for nm in names}
    if detail == "stalls":
        rep.stall = {nm: np.concatenate([r.stall[nm] for r in rows])
                     for nm in names}
        rep.op_class = {nm: np.concatenate([r.op_class[nm] for r in rows])
                        for nm in names}
    return rep


class EvalService:
    """Coalescing evaluation front-end over one (possibly sharded) evaluator.

    Parameters
    ----------
    evaluator:
        Anything :func:`~repro_torch.perfmodel.evaluator.as_evaluator`
        accepts — typically a :class:`~repro_torch.perfmodel.evaluator.
        ModelEvaluator` or a :class:`~repro_torch.distributed.sharded.
        ShardedEvaluator`.
    cache_rows:
        Bound on the shared per-design report cache (LRU beyond it).
        Ignored when an external ``cache`` is injected.
    cache:
        An existing :class:`~repro_torch.perfmodel.evaluator.RowCache` to share
        (e.g. with another service over the same evaluator).
    max_rows_per_tick:
        Cap on FRESH design rows dispatched per tick.  None (default) =
        unbounded — every queued request resolves in one tick.  With a cap,
        the round-robin drain guarantees each client gets a request served
        before any client gets a second one.
    autostart:
        Start a background batcher thread that ticks whenever requests sit
        in the queue longer than ``window_s`` (the coalescing window).
        Without it, call :meth:`tick` yourself — synchronous ``evaluate``
        calls also self-tick.
    degrade:
        The graceful-degradation ladder walked when a fused dispatch
        fails (or a request's ``deadline_s`` expires), in order:

        * ``narrow`` — halve the sharded evaluator's worker pool
          (``resize``) and retry the dispatch, repeating down to one
          worker (worker-loss recovery);
        * ``proxy``  — retry the dispatch at ``objectives`` detail (the
          cheap proxy: responses are demoted but correct);
        * ``cached`` — serve each request from whatever detail the shared
          row cache holds (possibly shallower than asked).

        Only a request that exhausts every rung sees the evaluator's
        exception; ``service.degraded`` counts rung traffic and requests
        NEVER crash the tick.
    registry / tracer / clock:
        Observability hooks (:mod:`repro_torch.obs`): the
        :class:`~repro_torch.obs.metrics.MetricsRegistry` holding the traffic
        instruments (fresh per service by default), a
        :class:`~repro_torch.obs.trace.Tracer` for tick/dispatch/request spans
        (default: the free no-op tracer), and an injectable clock for
        deterministic latency accounting under test.
    """

    def __init__(self, evaluator, *, cache_rows: int = 65_536,
                 cache: Optional[RowCache] = None,
                 max_rows_per_tick: Optional[int] = None,
                 autostart: bool = False, window_s: float = 0.002,
                 degrade: Tuple[str, ...] = DEGRADE_RUNGS,
                 tier_weights: Optional[Dict[str, float]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None, clock: Optional[Clock] = None):
        self.evaluator = as_evaluator(evaluator)
        self.space = self.evaluator.space
        self.tier = self.evaluator.tier
        self.window_s = float(window_s)
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NOOP
        self._clock: Clock = clock if clock is not None else time.monotonic
        self.max_rows_per_tick = (None if max_rows_per_tick is None
                                  else int(max_rows_per_tick))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # per-(tier, client) FIFO queues: tiers drain by weighted deficit,
        # clients within a tier round-robin
        self._queues: Dict[str, "OrderedDict[str, Deque[_Pending]]"] = {
            t: OrderedDict() for t in QOS_TIERS}
        self._rr = {t: 0 for t in QOS_TIERS}   # per-tier client rotation
        self._deficit = {t: 0.0 for t in QOS_TIERS}
        weights = dict(DEFAULT_TIER_WEIGHTS)
        if tier_weights:
            unknown = set(tier_weights) - set(QOS_TIERS)
            if unknown:
                raise ValueError(f"unknown QoS tiers {sorted(unknown)}; "
                                 f"choose from {QOS_TIERS}")
            for t, w in tier_weights.items():
                if float(w) <= 0:
                    raise ValueError(f"tier weight for {t!r} must be > 0")
                weights[t] = float(w)
        self.tier_weights = weights
        # THE shared cross-client design-row cache (ExplorationEngine reads
        # this same object when its evaluator is a service)
        self.row_cache: RowCache = (cache if cache is not None
                                    else RowCache(cache_rows))
        self._closed = False
        unknown_rungs = set(degrade) - set(DEGRADE_RUNGS)
        if unknown_rungs:
            raise ValueError(f"unknown degrade rungs {sorted(unknown_rungs)}; "
                             f"choose from {DEGRADE_RUNGS}")
        self.degrade = tuple(degrade)
        # traffic instruments — each takes its OWN lock on write, so no
        # increment needs the service lock.  Int-valued properties and
        # CounterView facades below keep the attribute surface
        # (`svc.submits`, `svc.degraded["narrow"]`, `dict(svc.tier_served)`).
        m = self.metrics
        self._c_submits = m.counter(
            "service_submits", "requests received")
        self._c_cache_hits = m.counter(
            "service_cache_hits", "requests resolved straight from cache")
        self._c_fused = m.counter(
            "service_fused_dispatches", "ticks that reached the evaluator")
        self._c_coalesced = m.counter(
            "service_coalesced_requests", "requests resolved by a fused tick")
        self._c_degraded = m.counter(
            "service_degraded",
            "deadline demotions + degradation-ladder rung traffic",
            labelnames=("rung",))
        for rung in ("deadline",) + DEGRADE_RUNGS:
            self._c_degraded.touch(rung=rung)
        self._c_tier_served = m.counter(
            "service_tier_served", "requests resolved, by QoS tier",
            labelnames=("tier",))
        self._h_queue_lat = m.histogram(
            "service_queue_latency_s", "queue-to-resolve latency (s) by tier",
            labelnames=("tier",))
        for t in QOS_TIERS:
            self._c_tier_served.touch(tier=t)
            self._h_queue_lat.touch(tier=t)
        self._h_tick = m.histogram(
            "service_tick_s", "non-empty tick wall time (s)")
        self.degraded = CounterView(self._c_degraded)
        self.tier_served = CounterView(self._c_tier_served)
        self._batcher: Optional[threading.Thread] = None
        if autostart:
            self._batcher = threading.Thread(target=self._batch_loop,
                                             name="eval-service-batcher",
                                             daemon=True)
            self._batcher.start()

    # -- protocol surface ----------------------------------------------
    @property
    def workloads(self) -> Tuple[str, ...]:
        return self.evaluator.workloads

    @property
    def models(self):
        return self.evaluator.models

    @property
    def scenarios(self):
        return getattr(self.evaluator, "scenarios", None)

    @property
    def dispatches(self) -> int:
        """Fused device dispatches spent by the underlying evaluator."""
        return getattr(self.evaluator, "dispatches", 0)

    # -- traffic counters (registry-backed int attributes) ---------------
    @property
    def submits(self) -> int:
        return int(self._c_submits.value())

    @property
    def cache_hits(self) -> int:
        return int(self._c_cache_hits.value())

    @property
    def fused_dispatches(self) -> int:
        return int(self._c_fused.value())

    @property
    def coalesced_requests(self) -> int:
        return int(self._c_coalesced.value())

    @property
    def cache_rows(self) -> int:
        return self.row_cache.capacity

    def _queued(self) -> int:
        return sum(len(q) for tier in self._queues.values()
                   for q in tier.values())

    def queued_rows(self) -> int:
        """Total design rows currently queued (admission-control signal:
        an admission front door's backpressure check reads this)."""
        with self._lock:
            return sum(p.idx.shape[0] for tier in self._queues.values()
                       for q in tier.values() for p in q)

    # -- async API ------------------------------------------------------
    def submit(self, request: EvalRequest, *, client: str = "",
               tier: str = "batch",
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request; the returned future resolves to a PPAReport.

        ``client`` names the submitting party for round-robin fairness
        (campaign label, bench name, ...); anonymous submitters share one
        lane.  ``tier`` picks the QoS lane (``interactive`` | ``batch`` |
        ``scavenger``) drained by weighted deficit.  Requests whose rows
        are ALL cached at sufficient detail resolve immediately (no
        queue, no dispatch) — the shared cross-client cache path.
        ``deadline_s`` bounds queue latency: a request still queued past
        it is DEGRADED (cached rows, then ``objectives`` proxy detail)
        rather than failed.
        """
        if tier not in QOS_TIERS:
            raise ValueError(f"tier must be one of {QOS_TIERS}, "
                             f"got {tier!r}")
        idx = np.atleast_2d(np.asarray(request.idx, dtype=np.int32))
        names = (self.workloads if request.workloads is None
                 else tuple(request.workloads))
        unknown = set(names) - set(self.workloads)
        if unknown:
            raise KeyError(f"unknown workloads {sorted(unknown)}; "
                           f"have {self.workloads}")
        now = self._clock()
        deadline = None if deadline_s is None else now + float(deadline_s)
        tr = self.tracer
        rsp = None
        if tr.enabled:
            # detached: resolved (finished) by whichever tick serves it
            rsp = tr.start("service.request", detached=True, tier=tier,
                           client=client, rows=int(idx.shape[0]),
                           detail=request.detail)
        pend = _Pending(idx, request.detail, names, Future(), client,
                        tier, deadline, now, rsp)
        with self._lock:
            if self._closed:
                if rsp is not None:
                    tr.lose(rsp, "service closed")
                raise RuntimeError("EvalService is closed")
            self._c_submits.inc()
            if self._try_resolve(pend):
                self._c_cache_hits.inc()
            else:
                self._queues[tier].setdefault(client, deque()).append(pend)
                self._cond.notify()
        return pend.future

    def _pop_tier(self, tier: str) -> Optional[_Pending]:
        """Pop ONE request from `tier`, round-robin across its clients
        (caller holds the lock)."""
        queues = self._queues[tier]
        clients = list(queues)
        if not clients:
            return None
        start = self._rr[tier] % len(clients)
        for off in range(len(clients)):
            client = clients[(start + off) % len(clients)]
            q = queues[client]
            if q:
                pend = q.popleft()
                if not q:
                    del queues[client]
                # next pop starts after the client just served (taken
                # modulo the then-current client count at read time)
                self._rr[tier] = start + off + 1
                return pend
        return None

    def _drain_fair(self) -> List[_Pending]:
        """Drain requests by QoS tier (caller holds the lock).

        Two phases per tick: (1) the ANTI-STARVATION FLOOR — every tier
        with queued work gets one request, highest priority first, even
        past ``max_rows_per_tick`` — a saturating interactive flood can
        slow the scavenger tier but never zero it; (2) WEIGHTED-DEFICIT
        round-robin — each pass credits every backlogged tier its weight,
        the largest-credit tier serves one request and is debited the
        rows it consumed, until the queues are empty or the planned row
        count reaches ``max_rows_per_tick``.  Credit is capped (a tier
        idle for an hour gets a burst, not an unbounded IOU) and resets
        when a tier's backlog clears.
        """
        picked: List[_Pending] = []
        rows = 0
        live = [t for t in QOS_TIERS if self._queues[t]]
        if not live:
            return picked
        for t in live:                         # the floor
            pend = self._pop_tier(t)
            if pend is not None:
                picked.append(pend)
                rows += pend.idx.shape[0]
        cap = self.max_rows_per_tick
        while cap is None or rows < cap:       # the weighted drain
            live = [t for t in QOS_TIERS if self._queues[t]]
            if not live:
                break
            for t in live:
                w = self.tier_weights[t]
                self._deficit[t] = min(self._deficit[t] + w,
                                       _DEFICIT_BURST * w)
            # max() scans QOS_TIERS order, so priority breaks credit ties
            t = max(live, key=lambda tt: self._deficit[tt])
            pend = self._pop_tier(t)
            if pend is None:
                break
            self._deficit[t] -= pend.idx.shape[0]
            picked.append(pend)
            rows += pend.idx.shape[0]
        for t in QOS_TIERS:
            if not self._queues[t]:
                self._deficit[t] = 0.0
        return picked

    def tick(self) -> int:
        """Drain the queue into ONE fused dispatch; resolve every future.

        Returns the number of design rows actually dispatched (0 when the
        queue was empty, fully cache-resident, or the dispatch failed).
        The fused dispatch runs OUTSIDE the service lock, so concurrent
        clients keep submitting (their requests form the next tick's
        batch).  A dispatch failure walks the ``degrade`` ladder (narrow
        the sharded pool -> objectives proxy -> cached rows) before ANY
        future sees an exception, so blocked ``result()`` callers — and
        the autostart batcher — always make progress.
        """
        tr = self.tracer
        if not tr.enabled:
            return self._tick_inner(None)
        with self._lock:
            if not any(self._queues[t] for t in QOS_TIERS):
                return 0                       # don't trace empty ticks
        t0 = self._clock()
        with tr.span("service.tick") as sp:
            rows = self._tick_inner(sp)
        self._h_tick.observe(self._clock() - t0)
        return rows

    def _tick_inner(self, sp) -> int:
        with self._lock:
            pending = self._drain_fair()
            if not pending:
                return 0
            now = self._clock()
            still: List[_Pending] = []
            for p in pending:
                if p.deadline is not None and now >= p.deadline:
                    # deadline pressure: cached rows first, else demote
                    # the request to the cheap proxy detail for this tick
                    if ("cached" in self.degrade
                            and self._try_resolve_degraded(p)):
                        self._c_degraded.inc(rung="deadline")
                        self._c_coalesced.inc()
                        continue
                    if p.detail != "objectives":
                        p.detail = "objectives"
                        self._c_degraded.inc(rung="deadline")
                still.append(p)
            pending = still
            if not pending:
                return 0
            level = max(_DETAIL_LEVEL[p.detail] for p in pending)
            detail = DETAILS[level]
            fresh_rows: List[np.ndarray] = []
            fresh_keys: List[bytes] = []
            seen: set = set()
            for p in pending:
                for row in p.idx:
                    key = RowCache.key(row)
                    if key in seen:
                        continue
                    if self.row_cache.get(key, detail, p.names) is None:
                        seen.add(key)
                        fresh_keys.append(key)
                        fresh_rows.append(row)
        if sp is not None:
            sp.attrs["requests"] = len(pending)
            sp.attrs["fresh_rows"] = len(fresh_rows)
        rep, used_detail, exc = None, detail, None
        if fresh_rows:                         # dispatch without the lock
            rep, used_detail, exc = self._dispatch_degrading(
                np.stack(fresh_rows), detail)
        with self._lock:
            if rep is not None:
                self._c_fused.inc()
                for i, key in enumerate(fresh_keys):
                    self.row_cache.put(key, used_detail, rep.row(i))
            for p in pending:
                if self._try_resolve(p):
                    self._c_coalesced.inc()
                    continue
                # last rung: serve whatever detail the cache holds
                if ("cached" in self.degrade
                        and self._try_resolve_degraded(p)):
                    self._c_degraded.inc(rung="cached")
                    self._c_coalesced.inc()
                    continue
                if p.span is not None:
                    p.span.attrs["error"] = str(exc) if exc else "cache miss"
                    self.tracer.finish(p.span, status="error")
                p.future.set_exception(
                    exc if exc is not None else
                    RuntimeError("coalesced rows missing from cache"))
        return len(fresh_rows) if rep is not None else 0

    def _dispatch_degrading(self, rows: np.ndarray, detail: str):
        """One fused dispatch, degraded along the ladder on failure.

        Returns ``(report | None, detail actually evaluated, last error)``.
        """
        tr = self.tracer
        with tr.span("service.dispatch", rows=int(rows.shape[0]),
                     detail=detail) as sp:
            try:
                return (self.evaluator.evaluate(
                    EvalRequest(rows, detail=detail)), detail, None)
            except BaseException as exc:
                last: BaseException = exc
            if tr.enabled:
                sp.attrs["first_error"] = str(last)
            if "narrow" in self.degrade:
                # worker-loss recovery: halve the sharded pool and retry,
                # down to a single worker (the counter takes its own lock,
                # so concurrent self-ticking clients don't race here)
                while (getattr(self.evaluator, "workers", 1) > 1
                       and hasattr(self.evaluator, "resize")):
                    self.evaluator.resize(max(1, self.evaluator.workers // 2))
                    self._c_degraded.inc(rung="narrow")
                    try:
                        return (self.evaluator.evaluate(
                            EvalRequest(rows, detail=detail)), detail, None)
                    except BaseException as exc:
                        last = exc
            if "proxy" in self.degrade and detail != "objectives":
                try:
                    rep = self.evaluator.evaluate(
                        EvalRequest(rows, detail="objectives"))
                    self._c_degraded.inc(rung="proxy")
                    return rep, "objectives", None
                except BaseException as exc:
                    last = exc
            tr.finish(sp, status="error")
            return None, detail, last

    def _record_served(self, pend: _Pending) -> None:
        """Per-tier QoS accounting at resolve time (caller holds the
        lock): served count + queue-to-resolve latency sample."""
        self._c_tier_served.inc(tier=pend.tier)
        self._h_queue_lat.observe(self._clock() - pend.t_submit,
                                  tier=pend.tier)
        if pend.span is not None:
            self.tracer.finish(pend.span)

    def _try_resolve(self, pend: _Pending) -> bool:
        """Resolve a request from cache alone (caller holds the lock)."""
        rows: List[PPAReport] = []
        for row in pend.idx:
            ent = self.row_cache.get(RowCache.key(row), pend.detail,
                                     pend.names)
            if ent is None:
                return False
            rows.append(ent)
        pend.future.set_result(_assemble(rows, pend.names, pend.detail))
        self._record_served(pend)
        return True

    def _try_resolve_degraded(self, pend: _Pending) -> bool:
        """Resolve from cache at WHATEVER detail it holds (caller holds the
        lock): the response is demoted to the shallowest cached level of
        its rows — degraded service beats no service."""
        rows: List[PPAReport] = []
        floor = pend.detail
        for row in pend.idx:
            ent = self.row_cache.get_any(RowCache.key(row), pend.names)
            if ent is None:
                return False
            d, rep = ent
            if _DETAIL_LEVEL[d] < _DETAIL_LEVEL[floor]:
                floor = d
            rows.append(rep)
        pend.future.set_result(_assemble(rows, pend.names, floor))
        self._record_served(pend)
        return True

    def telemetry(self) -> dict:
        """Service + QoS + degradation counters (plus the evaluator's).

        A pure VIEW over the metrics registry — exact same keys as the
        pre-registry ad-hoc dicts (frozen by test)."""
        with self._lock:
            queued = {t: sum(len(q) for q in self._queues[t].values())
                      for t in QOS_TIERS}
        tiers = {}
        for t in QOS_TIERS:
            p50 = self._h_queue_lat.percentile(50, tier=t)
            p99 = self._h_queue_lat.percentile(99, tier=t)
            tiers[t] = {
                "weight": self.tier_weights[t],
                "served": int(self._c_tier_served.value(tier=t)),
                "queued": queued[t],
                "p50_ms": (round(p50 * 1e3, 3) if p50 is not None else None),
                "p99_ms": (round(p99 * 1e3, 3) if p99 is not None else None),
            }
        out = {
            "submits": self.submits,
            "cache_hits": self.cache_hits,
            "fused_dispatches": self.fused_dispatches,
            "coalesced_requests": self.coalesced_requests,
            "degraded": dict(self.degraded),
            "tiers": tiers,
        }
        for name in ("dispatches", "worker_dispatches", "retried",
                     "straggler_redispatches", "timeouts",
                     "corrupt_rejected", "resizes"):
            val = getattr(self.evaluator, name, None)
            if isinstance(val, int):
                out[f"evaluator_{name}"] = val
        return out

    # -- synchronous Evaluator facade ----------------------------------
    def evaluate(self, request: EvalRequest) -> PPAReport:
        """Submit + (self-)tick + result: the drop-in Evaluator call."""
        fut = self.submit(request)
        while not fut.done() and self._batcher is None:
            self.tick()                        # bounded ticks drain in turns
        return fut.result()

    def objectives(self, idx: np.ndarray) -> np.ndarray:
        return self.evaluate(EvalRequest(idx, detail="objectives")).objectives

    def ppa(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="ppa"))

    def stalls(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="stalls"))

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        return self.objectives(idx)

    # -- lifecycle ------------------------------------------------------
    def _batch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queued() and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
            time.sleep(self.window_s)          # the coalescing window
            self.tick()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._batcher is not None:
            self._batcher.join(timeout=1.0)
        while self._queued():                  # drain any stragglers
            self.tick()

    def cache_clear(self) -> None:
        self.row_cache.clear()
