"""Distributed evaluation service layer.

Three composable pieces turn the single-process evaluator into an
always-on service that can absorb concurrent DSE traffic AND survive
worker failure:

* :class:`~repro_torch.distributed.sharded.ShardedEvaluator` — fans ONE
  :class:`~repro_torch.perfmodel.evaluator.EvalRequest`'s design batch
  across N workers (in-process threads, spawned processes, or per-device
  pins) and reassembles a single bit-identical :class:`~repro_torch.
  perfmodel.evaluator.PPAReport`, with per-shard retry (jittered-backoff
  :class:`~repro_torch.runtime.fault.RetryPolicy`), shard timeouts,
  receiver-side payload validation, straggler re-dispatch,
  heartbeat-tracked worker liveness and elastic pool resize.
  ``get_evaluator(..., workers=N)`` wraps the paper evaluators in one.
* :class:`~repro_torch.distributed.service.EvalService` — a request
  queue whose coalescing batcher merges concurrent requests from ANY
  number of clients (K campaigns, baselines, benches) into one fused
  dispatch per tick, resolved via futures and a shared cross-client
  report cache.  On worker loss or deadline pressure a request DEGRADES
  along a declared ladder (narrow the pool -> objectives proxy -> cached
  rows) instead of failing.
* :mod:`~repro_torch.distributed.faults` — the chaos harness proving the
  above: a seeded deterministic :class:`~repro_torch.distributed.faults.
  FaultPlan` of crash/hang/slow/corrupt events, a
  :class:`~repro_torch.distributed.faults.ChaosPool` wrapper composing
  with every pool, and the :class:`~repro_torch.distributed.faults.
  WorkerRegistry` liveness tracker.

The pieces compose: ``EvalService(ShardedEvaluator(base, workers=N,
fault_plan=plan))`` coalesces across clients, shards across workers and
injects failures deterministically.  The multi-worker full-space sweep
lives with its engine: ``SweepEngine(...).run(workers=N,
fault_plan=plan)``.  ``ShardedEvaluator(mode="socket", addresses=... |
membership=...)`` fans the same shards out to remote
:mod:`repro_torch.serve` workers over TCP.
"""

from repro_torch.distributed.faults import (FAULT_KINDS, ChaosPool,
                                            FaultEvent, FaultPlan,
                                            WorkerFault, WorkerRegistry)
from repro_torch.distributed.service import (DEGRADE_RUNGS, QOS_TIERS,
                                             EvalService)
from repro_torch.distributed.sharded import (MODES, ShardedEvaluator,
                                             ShardPayload, concat_reports,
                                             evaluator_from_spec)

__all__ = ["EvalService", "ShardedEvaluator", "ShardPayload",
           "concat_reports", "evaluator_from_spec", "MODES",
           "DEGRADE_RUNGS", "QOS_TIERS",
           "FaultPlan", "FaultEvent", "ChaosPool", "WorkerFault",
           "WorkerRegistry", "FAULT_KINDS"]
