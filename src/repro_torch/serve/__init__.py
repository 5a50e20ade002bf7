"""DSE-as-a-service: the cross-machine, multi-tenant serving layer.

Turns the in-process evaluation stack into an always-on service in
three layers, each riding an existing contract unchanged:

* **Transport** (:mod:`~repro_torch.serve.wire`,
  :mod:`~repro_torch.serve.codec`, :mod:`~repro_torch.serve.worker`,
  :mod:`~repro_torch.serve.pool`) — the process pool's pickled spec and
  its ``ShardPayload -> PPAReport`` exchange over length-prefixed TCP
  frames, carried by a schema-restricted binary codec with optional HMAC
  frame signing, replay rejection and TLS (legacy pickle only behind
  ``insecure=True``).  Run ``python -m repro_torch.serve.worker --host H
  --port P --key id=secret`` on any machine; point a
  :class:`~repro_torch.distributed.sharded.ShardedEvaluator` at the
  fleet with ``mode='socket'`` plus either a static ``addresses=[(H, P),
  ...]`` list or a live ``membership=`` view workers announce to
  (:mod:`~repro_torch.serve.membership`), and the retry / timeout /
  straggler / elastic / chaos machinery drives remote workers exactly as
  it drives local pools.  A worker rebuilds the client's evaluator on
  the device type its spec names: a ``backend="cuda"`` client gets
  workers that launch ``ppa_eval`` on their card, and a worker without
  CUDA refuses such a spec instead of evaluating on the CPU.  Workers
  enforce their own quotas (rows/dispatch, concurrency, deadline,
  per-peer rate) and the evaluator reroutes refusals instead of
  hammering.
* **QoS** — :meth:`EvalService.submit(..., tier=...)
  <repro_torch.distributed.service.EvalService.submit>` with
  weighted-deficit tier drain and an anti-starvation floor (lives in
  :mod:`repro_torch.distributed.service`; re-exported here).
* **Admission control** (:mod:`~repro_torch.serve.gateway`) — per-tenant
  row budgets, queue-depth backpressure with drain-ETA retry hints, fleet
  telemetry down to membership leases.

The frames are byte for byte the reference's (``repro.serve``): the
same values, keys, sequence numbers and session binding give the same
frames, so either package's endpoints read the other's traffic; only
the evaluator spec differs, since it names this package's classes.
"""

from repro_torch.distributed.service import (DEFAULT_TIER_WEIGHTS,
                                             QOS_TIERS, EvalService)
from repro_torch.serve.codec import (AuthError, Channel, CodecError,
                                     FrameTooLarge, Keyring,
                                     restricted_loads, spec_digest)
from repro_torch.serve.gateway import Gateway, RetryAfter, TenantAccount
from repro_torch.serve.membership import MembershipView, Registrar
from repro_torch.serve.pool import SocketPool, connect_evaluator
from repro_torch.serve.wire import WIRE_VERSION, ConnectionClosed, WireError
from repro_torch.serve.worker import (WorkerHandle, WorkerOptions,
                                      WorkerServer, start_worker_process)

__all__ = ["EvalService", "QOS_TIERS", "DEFAULT_TIER_WEIGHTS",
           "Gateway", "RetryAfter", "TenantAccount",
           "SocketPool", "connect_evaluator",
           "WorkerServer", "WorkerHandle", "WorkerOptions",
           "start_worker_process",
           "Keyring", "Channel", "AuthError", "CodecError", "FrameTooLarge",
           "restricted_loads", "spec_digest",
           "MembershipView", "Registrar",
           "WIRE_VERSION", "WireError", "ConnectionClosed"]
