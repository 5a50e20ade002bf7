"""Elastic re-planning: meshes when devices are lost, pools under load.

Two consumers drive this module:

* :func:`plan_elastic_mesh` — recompute the best device mesh when hosts
  are lost.  Policy: keep the `model` axis intact (TP degree is tied to
  weight sharding and head counts), shrink the data axes to the largest
  multiple that fits the surviving device count, then restore from the
  last checkpoint with the new shardings (restore-time resharding is
  the checkpoint layer's job).  The deterministic-by-step data pipeline
  replays the remainder of the epoch with the new DP degree.
* :func:`plan_elastic_pool` — the same policy shape adapted to evaluation
  worker pools: given the surviving worker count and the pending-shard
  backlog, pick the pool size that keeps the backlog under
  ``target_queue`` shards per worker, bounded by ``[min_workers,
  max_workers]``.  :class:`~repro_torch.distributed.sharded.ShardedEvaluator`
  calls this after dead-worker eviction (shrink to the survivors instead
  of oversubscribing dead slots) and under sustained queue pressure
  (grow toward the cap).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass
class ElasticPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices_used: int
    dp_degree: int
    tp_degree: int
    note: str


def plan_elastic_mesh(available_devices: int, model_axis: int = 16,
                      prefer_pods: bool = True) -> Optional[ElasticPlan]:
    """Largest (pod, data, model) grid that fits `available_devices` with the
    model axis fixed.  Returns None if even one model group doesn't fit."""
    if available_devices < model_axis:
        return None
    groups = available_devices // model_axis        # surviving TP groups
    # prefer two balanced pods when there are enough groups and it divides
    if prefer_pods and groups >= 4 and groups % 2 == 0:
        return ElasticPlan(
            shape=(2, groups // 2, model_axis),
            axes=("pod", "data", "model"),
            devices_used=groups * model_axis,
            dp_degree=groups,
            tp_degree=model_axis,
            note=f"2 pods x {groups // 2} DP x {model_axis} TP",
        )
    return ElasticPlan(
        shape=(groups, model_axis),
        axes=("data", "model"),
        devices_used=groups * model_axis,
        dp_degree=groups,
        tp_degree=model_axis,
        note=f"single pod {groups} DP x {model_axis} TP",
    )


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """Target size for an elastic evaluation worker pool."""
    workers: int
    grow: bool                    # True when the plan adds workers
    note: str


def plan_elastic_pool(live_workers: int, queued: int, *,
                      min_workers: int = 1, max_workers: int = 16,
                      target_queue: float = 2.0) -> PoolPlan:
    """Pool analogue of :func:`plan_elastic_mesh`.

    Keep enough workers that the pending backlog stays under
    ``target_queue`` items per worker; after worker loss with no backlog
    pressure, shrink to the surviving count instead of oversubscribing
    dead slots.  The result is always clamped to
    ``[min_workers, max_workers]``.
    """
    if min_workers < 1:
        raise ValueError(f"min_workers must be >= 1, got {min_workers}")
    if max_workers < min_workers:
        raise ValueError(f"max_workers ({max_workers}) < min_workers "
                         f"({min_workers})")
    live = max(0, int(live_workers))
    queued = max(0, int(queued))
    want = math.ceil(queued / max(target_queue, 1e-9)) if queued else live
    want = min(max(want, min_workers), max_workers)
    if want > live:
        note = f"grow {live} -> {want} ({queued} queued)"
    elif want < live:
        note = f"shrink {live} -> {want} ({queued} queued)"
    else:
        note = f"hold {want} ({queued} queued)"
    return PoolPlan(workers=want, grow=want > live, note=note)


def admission_retry_after(queued_rows: int, rows_per_s: float, *,
                          floor_s: float = 0.05,
                          cap_s: float = 60.0) -> float:
    """Backpressure hint for admission control: seconds until the current
    backlog drains at the observed service rate.

    An admission-controlled front door attaches this to its
    reject-with-retry-after responses (:class:`~repro_torch.serve.
    gateway.Gateway`), so a well-behaved client backs off exactly as long
    as the queue needs, instead of hammering a saturated service.  With no rate estimate yet (``rows_per_s <= 0``)
    the hint is one second — optimistic but bounded.  Always clamped to
    ``[floor_s, cap_s]``.
    """
    if cap_s < floor_s:
        raise ValueError(f"cap_s ({cap_s}) < floor_s ({floor_s})")
    queued_rows = max(0, int(queued_rows))
    eta = (queued_rows / rows_per_s) if rows_per_s > 0 else 1.0
    return float(min(max(eta, floor_s), cap_s))
