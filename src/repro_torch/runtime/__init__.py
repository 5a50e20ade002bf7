"""Fault-tolerance runtime (pure Python): retry policies, straggler
detection, heartbeats and elastic re-planning.

The port's own copy of the reference's ``repro.runtime``: the sharded
evaluator, the evaluation service and the sweep's span replay drive it.
"""
from repro_torch.runtime.fault import (Heartbeat, RetryPolicy,
                                       StragglerMonitor, run_with_retries)
from repro_torch.runtime.elastic import (ElasticPlan, PoolPlan,
                                         admission_retry_after,
                                         plan_elastic_mesh, plan_elastic_pool)

__all__ = ["RetryPolicy", "run_with_retries", "StragglerMonitor",
           "Heartbeat", "ElasticPlan", "PoolPlan", "plan_elastic_mesh",
           "plan_elastic_pool", "admission_retry_after"]
