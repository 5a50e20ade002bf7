"""The service front door: tenant accounting, admission control, telemetry.

:class:`Gateway` wraps an :class:`~repro_torch.distributed.service.EvalService`
and is the only layer that knows about *tenants*.  Every
:meth:`Gateway.submit` passes two admission checks before reaching the
service queue:

* **Per-tenant token budgets** — each tenant may admit at most
  ``rows_per_window`` design rows per fixed ``window_s`` window
  (per-tenant overrides via ``tenants={name: rows}``).  Exhausted budget
  rejects with :class:`RetryAfter` carrying the time until the window
  rolls.
* **Queue-depth backpressure** — when the service backlog exceeds
  ``max_queued_rows``, the gateway rejects with a :class:`RetryAfter`
  whose hint is the backlog drain ETA at the observed service rate
  (:func:`~repro_torch.runtime.elastic.admission_retry_after`) — reject early
  and cheap instead of queueing unboundedly and timing out expensively.

A rejected request costs the tenant nothing (no budget is consumed).
:meth:`telemetry` merges the service's QoS/degradation counters with
per-tenant accounting and the worker fleet state (the evaluator's
:class:`~repro_torch.distributed.faults.WorkerRegistry` snapshot, when it has
one — a sharded/socket evaluator does).

The gateway also implements the synchronous ``Evaluator`` protocol
(``evaluate`` / ``objectives`` / ``workloads`` / ...), self-ticking like
the service, so a ``CampaignRunner`` or bench can be pointed at the
front door and inherit admission control + QoS unchanged.
"""
from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.distributed.service import QOS_TIERS, EvalService
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP
from repro_torch.perfmodel.evaluator import EvalRequest, PPAReport
from repro_torch.runtime.elastic import admission_retry_after


class RetryAfter(RuntimeError):
    """Admission rejected; retry after ``retry_after_s`` seconds."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


@dataclass
class TenantAccount:
    """Fixed-window admission state for one tenant (the traffic counts
    live in the gateway's metrics registry, labelled by tenant)."""
    rows_per_window: int
    window_start: float
    used_rows: int = 0


class Gateway:
    """Multi-tenant admission-controlled front door over an EvalService.

    Parameters
    ----------
    service:
        The :class:`~repro_torch.distributed.service.EvalService` to guard —
        or anything ``EvalService`` accepts (a bare evaluator is wrapped
        in a fresh service).
    rows_per_window / window_s:
        Default per-tenant token budget: design rows admitted per fixed
        window.  The window is per tenant, opened at its first submit.
    tenants:
        Per-tenant ``rows_per_window`` overrides (``{tenant: rows}``).
        Unknown tenants get the default — this is quota config, not an
        allow-list.
    max_queued_rows:
        Queue-depth backpressure threshold: submits that would push the
        service backlog past this are rejected with a drain-ETA retry
        hint.  ``None`` disables backpressure.
    default_tier:
        QoS tier used when a submit names none.
    """

    def __init__(self, service, *, rows_per_window: int = 100_000,
                 window_s: float = 60.0,
                 tenants: Optional[Mapping[str, int]] = None,
                 max_queued_rows: Optional[int] = None,
                 default_tier: str = "batch",
                 now=time.monotonic,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        if not isinstance(service, EvalService):
            service = EvalService(service, tracer=tracer, clock=now)
        if default_tier not in QOS_TIERS:
            raise ValueError(f"default_tier must be one of {QOS_TIERS}, "
                             f"got {default_tier!r}")
        self.service = service
        self.rows_per_window = int(rows_per_window)
        self.window_s = float(window_s)
        self.quotas = dict(tenants or {})
        self.max_queued_rows = (None if max_queued_rows is None
                                else int(max_queued_rows))
        self.default_tier = default_tier
        self._now = now
        self._lock = threading.Lock()
        self._accounts: Dict[str, TenantAccount] = {}
        # observed service rate (rows/s EWMA) feeding the drain-ETA hint
        self._rate_rows_per_s = 0.0
        self._rate_alpha = 0.3
        # default to the service's tracer so gateway.evaluate roots the
        # same causal tree the tick/dispatch/shard spans grow under
        self.tracer = (tracer if tracer is not None
                       else getattr(service, "tracer", NOOP))
        self.metrics = registry if registry is not None else MetricsRegistry()
        m = self.metrics
        self._c_admitted = m.counter(
            "gateway_admitted", "requests past both admission checks")
        self._c_rejected = m.counter(
            "gateway_rejected", "requests refused (budget or backpressure)")
        self._c_t_admitted = m.counter(
            "gateway_tenant_admitted", "admitted requests, by tenant",
            labelnames=("tenant",))
        self._c_t_admitted_rows = m.counter(
            "gateway_tenant_admitted_rows", "admitted design rows, by tenant",
            labelnames=("tenant",))
        self._c_t_rej_budget = m.counter(
            "gateway_tenant_rejected_budget",
            "budget-exhausted rejections, by tenant", labelnames=("tenant",))
        self._c_t_rej_bp = m.counter(
            "gateway_tenant_rejected_backpressure",
            "backpressure rejections, by tenant", labelnames=("tenant",))

    @property
    def admitted(self) -> int:
        return int(self._c_admitted.value())

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value())

    # -- admission ------------------------------------------------------
    def _account(self, tenant: str) -> TenantAccount:
        acct = self._accounts.get(tenant)
        if acct is None:
            acct = TenantAccount(
                rows_per_window=int(self.quotas.get(tenant,
                                                    self.rows_per_window)),
                window_start=self._now())
            self._accounts[tenant] = acct
            for c in (self._c_t_admitted, self._c_t_admitted_rows,
                      self._c_t_rej_budget, self._c_t_rej_bp):
                c.touch(tenant=tenant)
        return acct

    def submit(self, request: EvalRequest, *, tenant: str = "default",
               tier: Optional[str] = None,
               client: Optional[str] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Admit + enqueue one request, or raise :class:`RetryAfter`.

        ``client`` defaults to the tenant name, so each tenant is a
        fairness lane inside its QoS tier unless it names finer lanes.
        """
        tier = self.default_tier if tier is None else tier
        idx = np.atleast_2d(np.asarray(request.idx, dtype=np.int32))
        n = int(idx.shape[0])
        with self._lock:
            acct = self._account(tenant)
            now = self._now()
            if now - acct.window_start >= self.window_s:
                acct.window_start = now
                acct.used_rows = 0
            if self.max_queued_rows is not None:
                backlog = self.service.queued_rows()
                if backlog + n > self.max_queued_rows:
                    self._c_t_rej_bp.inc(tenant=tenant)
                    self._c_rejected.inc()
                    hint = admission_retry_after(backlog,
                                                 self._rate_rows_per_s)
                    raise RetryAfter(
                        f"service backlog {backlog} rows "
                        f"(+{n} > {self.max_queued_rows} cap); "
                        f"retry in {hint:.2f}s", hint)
            if acct.used_rows + n > acct.rows_per_window:
                self._c_t_rej_budget.inc(tenant=tenant)
                self._c_rejected.inc()
                hint = max(0.0,
                           self.window_s - (now - acct.window_start))
                raise RetryAfter(
                    f"tenant {tenant!r} budget exhausted "
                    f"({acct.used_rows}+{n} > {acct.rows_per_window} "
                    f"rows/window); window rolls in {hint:.2f}s", hint)
            acct.used_rows += n
            self._c_t_admitted.inc(tenant=tenant)
            self._c_t_admitted_rows.inc(n, tenant=tenant)
            self._c_admitted.inc()
        return self.service.submit(request,
                                   client=tenant if client is None
                                   else client,
                                   tier=tier, deadline_s=deadline_s)

    def tick(self) -> int:
        """Drive the service batcher; feeds the drain-rate estimate the
        backpressure retry hints are computed from."""
        t0 = self._now()
        rows = self.service.tick()
        dt = self._now() - t0
        if rows and dt > 0:
            with self._lock:
                a = self._rate_alpha
                self._rate_rows_per_s = ((1 - a) * self._rate_rows_per_s
                                         + a * (rows / dt))
        return rows

    # -- telemetry ------------------------------------------------------
    def _tenant_dict(self, tenant: str, acct: TenantAccount) -> dict:
        return {
            "rows_per_window": acct.rows_per_window,
            "used_rows": acct.used_rows,
            "admitted": int(self._c_t_admitted.value(tenant=tenant)),
            "admitted_rows": int(self._c_t_admitted_rows.value(tenant=tenant)),
            "rejected_budget": int(self._c_t_rej_budget.value(tenant=tenant)),
            "rejected_backpressure": int(self._c_t_rej_bp.value(tenant=tenant)),
        }

    def telemetry(self) -> dict:
        """Service QoS counters + tenant ledgers + worker fleet state."""
        with self._lock:
            tenants = {t: self._tenant_dict(t, a)
                       for t, a in self._accounts.items()}
            out = {
                "service": self.service.telemetry(),
                "tenants": tenants,
                "admission": {
                    "admitted": self.admitted,
                    "rejected": self.rejected,
                    "max_queued_rows": self.max_queued_rows,
                    "rows_per_window": self.rows_per_window,
                    "window_s": self.window_s,
                    "observed_rows_per_s": round(self._rate_rows_per_s, 1),
                },
            }
        ev = self.service.evaluator
        registry = getattr(ev, "registry", None)
        if registry is not None:
            out["fleet"] = registry.snapshot()
            out["fleet"]["mode"] = getattr(ev, "mode", None)
            out["fleet"]["workers"] = getattr(ev, "workers", None)
            membership = getattr(ev, "membership", None)
            if membership is not None:
                # lease-level fleet view: who holds membership right now,
                # not just which sockets happen to be open
                out["fleet"]["leases"] = membership.snapshot()
            ev_metrics = getattr(ev, "metrics", None)
            if ev_metrics is not None:
                rtt = ev_metrics.get("heartbeat_rtt")
                if rtt is not None:
                    out["fleet"]["heartbeat_rtt"] = {
                        labels[0]: {
                            "count": s["count"],
                            "p50_ms": (round(s["p50"] * 1e3, 3)
                                       if s["p50"] is not None else None),
                            "p99_ms": (round(s["p99"] * 1e3, 3)
                                       if s["p99"] is not None else None),
                        }
                        for labels in rtt.series_keys()
                        for s in (rtt.stats(worker=labels[0]),)
                    }
        return out

    def snapshot(self) -> dict:
        """Everything the fleet dashboard wants in one JSON-able dict:
        the merged :meth:`telemetry` tree plus the raw metric registries
        of every layer that has one."""
        out = {"telemetry": self.telemetry(),
               "metrics": {"gateway": self.metrics.snapshot()}}
        svc_metrics = getattr(self.service, "metrics", None)
        if svc_metrics is not None:
            out["metrics"]["service"] = svc_metrics.snapshot()
        ev_metrics = getattr(self.service.evaluator, "metrics", None)
        if ev_metrics is not None:
            out["metrics"]["evaluator"] = ev_metrics.snapshot()
        return out

    def save_snapshot(self, path) -> None:
        """Write :meth:`snapshot` as JSON — the input format of
        ``python -m repro_torch.obs.report``."""
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.snapshot(), fh, indent=2, default=str)

    # -- Evaluator facade ----------------------------------------------
    @property
    def workloads(self):
        return self.service.workloads

    @property
    def models(self):
        return self.service.models

    @property
    def scenarios(self):
        return self.service.scenarios

    @property
    def space(self):
        return self.service.space

    @property
    def tier(self):
        return self.service.tier

    @property
    def row_cache(self):
        return self.service.row_cache

    def evaluate(self, request: EvalRequest, *,
                 tenant: str = "default") -> PPAReport:
        with self.tracer.span("gateway.evaluate", tenant=tenant):
            fut = self.submit(request, tenant=tenant)
            while not fut.done() and self.service._batcher is None:
                self.tick()
            return fut.result()

    def objectives(self, idx: np.ndarray) -> np.ndarray:
        return self.evaluate(EvalRequest(idx, detail="objectives")).objectives

    def ppa(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="ppa"))

    def stalls(self, idx: np.ndarray) -> PPAReport:
        return self.evaluate(EvalRequest(idx, detail="stalls"))

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        return self.objectives(idx)

    def close(self) -> None:
        self.service.close()
