"""Fault-tolerance runtime: retry policies, straggler detection, heartbeats.

The distributed evaluation stack drives these policies directly:

* :class:`RetryPolicy` — retry budget + jittered exponential backoff.
  :func:`run_with_retries` executes a step function under one (the
  training-loop replay path), and :class:`~repro_torch.distributed.sharded.
  ShardedEvaluator` uses the same policy object for its per-shard retry /
  timeout backoff, while :class:`~repro_torch.perfmodel.sweep.SweepEngine`
  replays crashed worker spans through :func:`run_with_retries` itself.
* :class:`StragglerMonitor` — rolling per-step latency stats; flags steps
  slower than median * threshold.  At scale the flagged host is drained
  and the elastic re-plan path (:mod:`repro_torch.runtime.elastic`) kicks in.
* :class:`Heartbeat` — liveness file a watchdog can poll across process
  boundaries.  :class:`~repro_torch.distributed.faults.WorkerRegistry` is the
  in-process registry built on the same expiry semantics (beat / timeout /
  evict / re-register).
"""
from __future__ import annotations

import dataclasses
import os
import random
import time
from collections import deque
from typing import Callable, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry budget with jittered exponential backoff.

    ``delay(attempt)`` is ``backoff_s * 2^attempt`` capped at
    ``max_backoff_s``, optionally spread by ``jitter`` (a symmetric
    +/- fraction, de-synchronizing retry storms across workers).  Frozen:
    a policy is shared freely across call sites without aliasing state.
    """
    max_retries: int = 3
    backoff_s: float = 0.0          # 0 in tests; seconds in production
    max_backoff_s: float = 30.0
    jitter: float = 0.0             # +/- fraction of the delay randomized
    retryable: Tuple[Type[BaseException], ...] = (RuntimeError, ValueError)

    def delay(self, attempt: int,
              rng: Optional[random.Random] = None) -> float:
        """Backoff before retry number `attempt` (0-based), jittered."""
        base = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
        if base and self.jitter:
            u = (rng.random() if rng is not None else random.random())
            base *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, base)


def run_with_retries(step_fn: Callable, restore_fn: Callable,
                     policy: Optional[RetryPolicy] = None):
    """step_fn() -> result; restore_fn(attempt) resets state before retry.

    ``policy=None`` builds a fresh default :class:`RetryPolicy` per call,
    so no caller shares a default instance with another.
    """
    policy = RetryPolicy() if policy is None else policy
    last = None
    for attempt in range(policy.max_retries + 1):
        try:
            return step_fn()
        except policy.retryable as e:        # noqa: PERF203
            last = e
            if attempt == policy.max_retries:
                break
            d = policy.delay(attempt)
            if d:
                time.sleep(d)
            restore_fn(attempt)
    raise RuntimeError(
        f"step failed after {policy.max_retries} retries") from last


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self._times: deque = deque(maxlen=window)
        self.flagged: list = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self._times.append(seconds)
        if len(self._times) < 8:
            return False
        med = sorted(self._times)[len(self._times) // 2]
        if seconds > med * self.threshold:
            self.flagged.append((step, seconds, med))
            return True
        return False


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{step} {now}\n")
            os.replace(tmp, self.path)
            self._last = now

    @staticmethod
    def is_alive(path: str, timeout_s: float) -> bool:
        try:
            with open(path) as f:
                _, ts = f.read().split()
            return time.time() - float(ts) < timeout_s
        except (OSError, ValueError):
            return False
