"""Deterministic chaos injection + worker liveness for the eval service.

The always-on DSE service must survive worker crashes, hangs, slowdowns
and corrupted payloads.  This module supplies both halves of proving
that:

* **Injection** — :class:`FaultPlan` is a seeded, fully deterministic
  schedule of fault events keyed by ``(worker, dispatch)``;
  :class:`ChaosPool` wraps ANY worker pool
  (``inline | thread | process | device``) and applies the plan's events
  to the pool's dispatch stream WITHOUT real process kills, so
  :class:`~repro_torch.distributed.sharded.ShardedEvaluator`,
  :class:`~repro_torch.distributed.service.EvalService` and
  :class:`~repro_torch.perfmodel.sweep.SweepEngine` can be exercised under
  failure in unit tests and CI.  Events are consumed exactly once
  (:meth:`FaultPlan.fire`), so a retried dispatch lands on a clean slot
  and recovery converges.
* **Liveness** — :class:`WorkerRegistry` tracks per-worker heartbeats
  with the same expiry semantics as the file-based
  :class:`~repro_torch.runtime.fault.Heartbeat` (beat / timeout / evict /
  re-register), in process.  :class:`~repro_torch.distributed.sharded.
  ShardedEvaluator` beats it on shard completion, evicts workers whose
  dispatches crash or time out, and re-registers replacements when the
  pool resizes (:func:`~repro_torch.runtime.elastic.plan_elastic_pool` decides
  the size).

Fault kinds
-----------
``crash``    the dispatch fails immediately (``WorkerFault``);
``hang``     the dispatch never completes (exercises shard timeouts and
             straggler speculation);
``slow``     the result is delayed by ``delay_s`` (exercises straggler
             detection without data loss);
``corrupt``  the result's payload is corrupted (non-finite / negated
             values — exercises the receiver-side integrity check).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

FAULT_KINDS = ("crash", "hang", "slow", "corrupt")


class WorkerFault(RuntimeError):
    """An injected (or detected) worker failure — retryable by policy."""


class QuotaExceeded(WorkerFault):
    """A worker REFUSED a dispatch by policy (``quota.rows`` /
    ``quota.rate`` / ``quota.concurrency`` / ``quota.deadline``): the
    worker is healthy and the shard is fine — it just will not run HERE
    right now.  :class:`~repro_torch.distributed.sharded.ShardedEvaluator`
    treats it as non-retryable-at-this-worker: reroute to another slot
    without consuming retry budget, without backoff, and without
    evicting the refusing worker."""

    def __init__(self, message: str, code: str = "quota"):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: hits dispatch number `dispatch` attributed to
    worker slot `worker` (slots are assigned round-robin by dispatch
    order, the same attribution the pools use)."""
    worker: int
    dispatch: int
    kind: str
    delay_s: float = 0.05          # slow-fault delay

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")


class FaultPlan:
    """A deterministic, seeded schedule of fault events.

    Events are keyed by ``(worker, dispatch)`` and CONSUMED on fire: a
    retry of a crashed dispatch gets a fresh ordinal, so the same event
    can never re-kill its own recovery.  Thread-safe (pools fire from
    worker threads).
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self._lock = threading.Lock()
        self._events: Dict[Tuple[int, int], FaultEvent] = {}
        for e in events:
            self._events[(e.worker, e.dispatch)] = e
        self.scheduled = len(self._events)
        self.fired: Dict[str, int] = {k: 0 for k in FAULT_KINDS}

    @classmethod
    def seeded(cls, seed: int, *, workers: int, dispatches: int,
               rate: float = 0.2,
               kinds: Tuple[str, ...] = FAULT_KINDS,
               delay_s: float = 0.05) -> "FaultPlan":
        """A reproducible random plan: each of the first `dispatches`
        dispatch ordinals faults with probability `rate`, cycling worker
        attribution round-robin.  Same seed -> same schedule, always."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for d in range(dispatches):
            if rng.random() < rate:
                events.append(FaultEvent(
                    worker=d % max(1, workers), dispatch=d,
                    kind=kinds[int(rng.integers(len(kinds)))],
                    delay_s=delay_s))
        return cls(events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def peek(self, worker: int, dispatch: int) -> Optional[FaultEvent]:
        with self._lock:
            return self._events.get((worker, dispatch))

    def fire(self, worker: int, dispatch: int) -> Optional[FaultEvent]:
        """The event scheduled for this (worker, dispatch), consumed."""
        with self._lock:
            ev = self._events.pop((worker, dispatch), None)
            if ev is not None:
                self.fired[ev.kind] += 1
            return ev


def corrupt_report(rep):
    """Corrupt a PPAReport payload the way a flaky wire would: negate the
    area and poison the first latency entry of every workload with NaN.
    The receiver-side integrity check must reject exactly this."""
    import copy
    bad = copy.copy(rep)
    bad.area = -np.asarray(rep.area)
    bad.latency = {nm: v.copy() for nm, v in rep.latency.items()}
    for nm in bad.latency:
        if bad.latency[nm].size:
            bad.latency[nm][0] = np.nan
    return bad


class ChaosPool:
    """Fault-injecting wrapper composing with every worker pool.

    Keeps its own dispatch counter; each submitted payload is attributed
    to worker slot ``dispatch % workers`` (deterministic round-robin — the
    same attribution :class:`~repro_torch.distributed.sharded.ShardedEvaluator`
    uses for liveness bookkeeping) and checked against the plan:

    * ``crash``   -> an already-failed future (``WorkerFault``);
    * ``hang``    -> a future that never resolves;
    * ``slow``    -> the real result, delivered after ``delay_s``;
    * ``corrupt`` -> the real result with a corrupted payload.

    ``injected`` counts applied events by kind.
    """

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.mode = inner.mode
        self.dispatch_count = 0
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._lock = threading.Lock()

    @property
    def workers(self) -> int:
        return self.inner.workers

    def submit(self, payload) -> Future:
        with self._lock:
            d = self.dispatch_count
            self.dispatch_count += 1
        ev = self.plan.fire(d % max(1, self.workers), d)
        if ev is None:
            return self.inner.submit(payload)
        self.injected[ev.kind] += 1
        if ev.kind == "crash":
            fut: Future = Future()
            fut.set_exception(WorkerFault(
                f"injected crash: worker {ev.worker} dispatch {d}"))
            return fut
        if ev.kind == "hang":
            return Future()                      # pending forever
        inner_fut = self.inner.submit(payload)
        out: Future = Future()

        def _copy(f: Future) -> None:
            if out.cancelled() or out.done():
                return                       # receiver already abandoned us
            try:
                try:
                    res = f.result()
                except BaseException as exc:
                    out.set_exception(exc)
                    return
                out.set_result(corrupt_report(res) if ev.kind == "corrupt"
                               else res)
            except Exception:                # cancelled between check and set
                pass

        if ev.kind == "slow":
            def _delayed(f: Future) -> None:
                t = threading.Timer(ev.delay_s, _copy, args=(f,))
                t.daemon = True
                t.start()
            inner_fut.add_done_callback(_delayed)
        else:
            inner_fut.add_done_callback(_copy)
        return out

    def resize(self, workers: int) -> None:
        self.inner.resize(workers)

    def close(self) -> None:
        self.inner.close()


class WorkerRegistry:
    """In-process worker liveness: heartbeats, eviction, re-registration.

    The in-memory sibling of the file-based :class:`~repro_torch.runtime.fault.
    Heartbeat` watchdog: a worker is alive while its last beat is younger
    than ``timeout_s``.  ``evict_dead()`` removes expired workers (and
    anything explicitly :meth:`mark_dead`-ed); a later :meth:`register`
    of the same id is a RE-registration (the worker came back or was
    replaced) and counts as one.  ``now`` is injectable for tests.
    """

    def __init__(self, timeout_s: float = 30.0, now=time.monotonic):
        self.timeout_s = float(timeout_s)
        self._now = now
        self._lock = threading.Lock()
        self._beats: Dict[int, float] = {}
        self._dead: set = set()
        self._known: set = set()
        self.evictions = 0
        self.reregistrations = 0

    def register(self, worker: int) -> None:
        with self._lock:
            if worker in self._known and worker not in self._beats:
                self.reregistrations += 1
            self._known.add(worker)
            self._dead.discard(worker)
            self._beats[worker] = self._now()

    def beat(self, worker: int) -> None:
        with self._lock:
            if worker in self._beats:
                self._beats[worker] = self._now()

    def mark_dead(self, worker: int) -> None:
        """Flag a worker for eviction regardless of its heartbeat age
        (crash / timeout attribution beats the passive expiry clock)."""
        with self._lock:
            if worker in self._beats:
                self._dead.add(worker)

    def alive(self, worker: int) -> bool:
        with self._lock:
            ts = self._beats.get(worker)
            return (ts is not None and worker not in self._dead
                    and self._now() - ts < self.timeout_s)

    def live(self) -> List[int]:
        now = self._now()
        with self._lock:
            return sorted(w for w, ts in self._beats.items()
                          if w not in self._dead
                          and now - ts < self.timeout_s)

    def evict_dead(self) -> List[int]:
        """Remove expired / flagged workers; returns the evicted ids."""
        now = self._now()
        with self._lock:
            gone = sorted(w for w, ts in self._beats.items()
                          if w in self._dead or now - ts >= self.timeout_s)
            for w in gone:
                del self._beats[w]
                self._dead.discard(w)
            self.evictions += len(gone)
            return gone

    def snapshot(self) -> Dict[str, object]:
        """Fleet state for telemetry: live/known ids, beat ages, and the
        eviction / re-registration counters (gateway `telemetry()` rides
        this)."""
        now = self._now()
        with self._lock:
            live = sorted(w for w, ts in self._beats.items()
                          if w not in self._dead
                          and now - ts < self.timeout_s)
            return {
                "live": live,
                "known": sorted(self._known),
                "beat_age_s": {w: round(now - ts, 3)
                               for w, ts in sorted(self._beats.items())},
                "timeout_s": self.timeout_s,
                "evictions": self.evictions,
                "reregistrations": self.reregistrations,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._beats)
