"""The port's fault-tolerance runtime (``repro_torch.runtime``) against the
reference's ``repro.runtime``: the same calls give the same delays,
retries, straggler flags, liveness answers and elastic plans, exactly
(pure Python on both sides, so every comparison is equality)."""
import inspect
import random

import pytest

from repro.runtime import elastic as j_elastic
from repro.runtime import fault as j_fault
from repro_torch.runtime import (ElasticPlan, Heartbeat, PoolPlan,
                                 RetryPolicy, StragglerMonitor,
                                 admission_retry_after, plan_elastic_mesh,
                                 plan_elastic_pool, run_with_retries)
from repro_torch.runtime import elastic as t_elastic
from repro_torch.runtime import fault as t_fault

POLICIES = [dict(), dict(backoff_s=0.5, max_backoff_s=3.0),
            dict(backoff_s=1.0, max_backoff_s=8.0, jitter=0.25),
            dict(backoff_s=0.01, max_backoff_s=0.02, jitter=0.5)]


# ------------------------------------------------------------- retry policy
@pytest.mark.parametrize("kw", POLICIES)
def test_retry_delays_equal_the_reference(kw):
    """Capped exponential backoff with seeded jitter: every delay equal."""
    mine, ref = t_fault.RetryPolicy(**kw), j_fault.RetryPolicy(**kw)
    rng_a, rng_b = random.Random(5), random.Random(5)
    got = [mine.delay(a, rng=rng_a) for a in range(12) for _ in range(4)]
    want = [ref.delay(a, rng=rng_b) for a in range(12) for _ in range(4)]
    assert got == want
    assert all(d >= 0.0 for d in got)


def test_retry_policy_backoff_capped_exponential():
    p = RetryPolicy(backoff_s=0.5, max_backoff_s=3.0, jitter=0.0)
    assert [p.delay(a) for a in (0, 1, 2, 3, 10)] == [0.5, 1.0, 2.0, 3.0, 3.0]
    assert RetryPolicy(backoff_s=0.0).delay(5) == 0.0
    ds = [RetryPolicy(backoff_s=1.0, jitter=0.25).delay(1, random.Random(i))
          for i in range(200)]
    assert all(1.5 <= d <= 2.5 for d in ds) and len(set(ds)) > 50


def test_retry_policy_defaults_frozen_and_typed():
    p, j = RetryPolicy(), j_fault.RetryPolicy()
    assert (p.max_retries, p.backoff_s, p.max_backoff_s, p.jitter) == \
        (j.max_retries, j.backoff_s, j.max_backoff_s, j.jitter)
    assert p.retryable == j.retryable == (RuntimeError, ValueError)
    with pytest.raises(Exception):
        p.max_retries = 99
    assert inspect.signature(run_with_retries).parameters["policy"].default \
        is None


def _drive_retries(mod, fail_first: int, policy_kw: dict):
    """run_with_retries over a step failing `fail_first` times: the
    outcome, the step calls and the restore attempts it saw."""
    log = {"calls": 0, "restores": []}

    def step():
        log["calls"] += 1
        if log["calls"] <= fail_first:
            raise RuntimeError(f"preempted {log['calls']}")
        return "ok"

    try:
        out = mod.run_with_retries(step, log["restores"].append,
                                   mod.RetryPolicy(**policy_kw))
    except RuntimeError as exc:
        out = (str(exc), str(exc.__cause__))
    return out, log


@pytest.mark.parametrize("fail_first,kw", [(0, {}), (2, {"max_retries": 3}),
                                           (3, {"max_retries": 3}),
                                           (5, {"max_retries": 2}),
                                           (1, {"max_retries": 0})])
def test_run_with_retries_equals_the_reference(fail_first, kw):
    assert _drive_retries(t_fault, fail_first, kw) == \
        _drive_retries(j_fault, fail_first, kw)


def test_run_with_retries_passes_non_retryable_through():
    with pytest.raises(KeyError):
        run_with_retries(lambda: (_ for _ in ()).throw(KeyError("x")),
                         lambda a: None,
                         RetryPolicy(retryable=(RuntimeError,)))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise RuntimeError("flake")
        return calls["n"]

    assert run_with_retries(flaky, lambda a: None) == 2   # fresh default


# --------------------------------------------------- stragglers, heartbeats
def test_straggler_monitor_flags_equal_the_reference():
    times = [0.1] * 12 + [0.5, 0.1, 0.35, 0.9, 0.1, 0.21] + [0.1] * 20
    a = StragglerMonitor(window=16, threshold=2.0)
    b = j_fault.StragglerMonitor(window=16, threshold=2.0)
    assert [a.record(i, t) for i, t in enumerate(times)] == \
        [b.record(i, t) for i, t in enumerate(times)]
    assert a.flagged == b.flagged and len(a.flagged) >= 2


def test_heartbeat_file_liveness_and_reference_reads_it(tmp_path):
    path = str(tmp_path / "hb")
    hb = Heartbeat(path, interval_s=0.0)
    assert not Heartbeat.is_alive(path, timeout_s=10.0)    # no file yet
    hb.beat(step=3)
    assert Heartbeat.is_alive(path, timeout_s=10.0)
    assert j_fault.Heartbeat.is_alive(path, timeout_s=10.0)
    assert not Heartbeat.is_alive(path, timeout_s=0.0)     # already expired
    (tmp_path / "bad").write_text("garbage")
    assert not Heartbeat.is_alive(str(tmp_path / "bad"), 10.0)


# ---------------------------------------------------------------- elastic
@pytest.mark.parametrize("devices", [0, 8, 15, 16, 32, 48, 50, 64, 80, 96,
                                     496, 512, 1024])
@pytest.mark.parametrize("model_axis,pods", [(16, True), (16, False),
                                             (8, True), (4, True)])
def test_elastic_mesh_plans_equal_the_reference(devices, model_axis, pods):
    got = plan_elastic_mesh(devices, model_axis=model_axis, prefer_pods=pods)
    want = j_elastic.plan_elastic_mesh(devices, model_axis=model_axis,
                                       prefer_pods=pods)
    if want is None:
        assert got is None
    else:
        assert isinstance(got, ElasticPlan)
        assert got.__dict__ == want.__dict__


POOL_CASES = [(live, queued, lo, hi, tq)
              for live in (0, 1, 2, 3, 6)
              for queued in (0, 2, 12, 100)
              for lo, hi in ((1, 8), (2, 8), (1, 16))
              for tq in (1.0, 2.0, 4.5)]


def test_elastic_pool_plans_equal_the_reference():
    for live, queued, lo, hi, tq in POOL_CASES:
        got = plan_elastic_pool(live, queued, min_workers=lo, max_workers=hi,
                                target_queue=tq)
        want = j_elastic.plan_elastic_pool(live, queued, min_workers=lo,
                                           max_workers=hi, target_queue=tq)
        assert isinstance(got, PoolPlan)
        assert (got.workers, got.grow, got.note) == \
            (want.workers, want.grow, want.note)
    for bad in (dict(min_workers=0), dict(min_workers=4, max_workers=2)):
        with pytest.raises(ValueError) as mine:
            plan_elastic_pool(2, 0, **bad)
        with pytest.raises(ValueError) as ref:
            j_elastic.plan_elastic_pool(2, 0, **bad)
        assert str(mine.value) == str(ref.value)


def test_admission_retry_after_equals_the_reference():
    for rows in (-5, 0, 1, 100, 10_000, 10 ** 9):
        for rate in (-1.0, 0.0, 0.5, 1e3, 1e6):
            for lo, hi in ((0.05, 60.0), (1.0, 2.0)):
                assert admission_retry_after(rows, rate, floor_s=lo,
                                             cap_s=hi) == \
                    j_elastic.admission_retry_after(rows, rate, floor_s=lo,
                                                    cap_s=hi)
    with pytest.raises(ValueError, match="cap_s"):
        admission_retry_after(1, 1.0, floor_s=2.0, cap_s=1.0)
    assert t_elastic.admission_retry_after is admission_retry_after
