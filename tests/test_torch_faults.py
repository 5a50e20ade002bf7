"""The port's chaos harness and fault-tolerant evaluation against the
reference's (``tests/test_faults.py``): seeded fault plans, the chaos
pool, sharded recovery (retry, corrupt rejection, shard timeouts with
eviction and re-registration, straggler twins, elastic resize), the
service's degradation ladder, crash-safe sweeps and a campaign through a
chaotic service.

Contracts: fault plans, ids, classes, counts and every fault/retry
counter equal the reference's exactly; latencies, stall times and area
agree at rtol 1e-6; within the port, every fault-injected, resumed or
degraded result equals the clean in-process one bit for bit.  The timing
tests run on a :class:`_LandedClock`, so no healthy shard can ever read as
late, whatever the host's load.
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro.core.campaign import CampaignRunner as JCampaignRunner
from repro.distributed import EvalService as JEvalService
from repro.distributed import FaultEvent as JFaultEvent
from repro.distributed import FaultPlan as JFaultPlan
from repro.distributed import ShardedEvaluator as JShardedEvaluator
from repro.distributed.faults import corrupt_report as j_corrupt_report
from repro.perfmodel import EvalRequest as JEvalRequest
from repro.perfmodel import ModelEvaluator as JModelEvaluator
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro.perfmodel.sweep import SweepEngine as JSweepEngine
from repro_torch.core.campaign import CampaignRunner
from repro_torch.distributed import (ChaosPool, EvalService, FaultEvent,
                                     FaultPlan, ShardedEvaluator, WorkerFault)
from repro_torch.distributed.faults import corrupt_report
from repro_torch.distributed.sharded import ShardPayload, _InlinePool
from repro_torch.obs import ManualClock
from repro_torch.perfmodel import (EvalRequest, ModelEvaluator, get_evaluator,
                                   make_evaluator)
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.sweep import SweepEngine
from repro_torch.perfmodel.workload import zoo_suite
from repro_torch.runtime import RetryPolicy

torch.set_num_threads(1)

CH = 8_192                               # sweep chunk size used throughout
RTOL = 1e-6


def _ids(seed: int, n: int) -> np.ndarray:
    return SPACE.sample(np.random.default_rng(seed), n)


def _fresh(tier: str = "proxy") -> ModelEvaluator:
    return ModelEvaluator(get_evaluator(tier, device="cpu").models,
                          tier=tier, device="cpu")


def _j_fresh(tier: str = "proxy") -> JModelEvaluator:
    return JModelEvaluator(j_get_evaluator(tier).models, tier=tier)


def _assert_reports_identical(a, b):
    assert a.workloads == b.workloads and a.detail == b.detail
    assert np.array_equal(a.area, b.area)
    for w in a.workloads:
        assert np.array_equal(a.latency[w], b.latency[w])
        if a.detail in ("ppa", "stalls"):
            assert np.array_equal(a.op_time[w], b.op_time[w])
            assert a.op_names[w] == b.op_names[w]
        if a.detail == "stalls":
            assert np.array_equal(a.stall[w], b.stall[w])
            assert np.array_equal(a.op_class[w], b.op_class[w])


def _assert_matches_reference(rep, ref):
    """Port report vs reference report: names, detail and classes exact,
    every float at rtol 1e-6."""
    assert rep.workloads == ref.workloads and rep.detail == ref.detail
    np.testing.assert_allclose(rep.area, np.asarray(ref.area), rtol=RTOL)
    for w in rep.workloads:
        np.testing.assert_allclose(rep.latency[w], np.asarray(ref.latency[w]),
                                   rtol=RTOL)
        if rep.detail in ("ppa", "stalls"):
            np.testing.assert_allclose(rep.op_time[w],
                                       np.asarray(ref.op_time[w]), rtol=RTOL)
            assert rep.op_names[w] == ref.op_names[w]
        if rep.detail == "stalls":
            np.testing.assert_allclose(rep.stall[w], np.asarray(ref.stall[w]),
                                       rtol=RTOL)
            assert np.array_equal(rep.op_class[w], np.asarray(ref.op_class[w]))


def _events(plan) -> list:
    return sorted((e.worker, e.dispatch, e.kind, e.delay_s)
                  for e in plan._events.values())


class _LandedClock:
    """A :class:`ManualClock` that moves only once every dispatch the real
    pool has taken has landed: each read then advances it by ``step``.

    A hung dispatch never reaches the real pool (the chaos pool keeps it),
    so only a hung shard's age can grow past a deadline or a straggler
    threshold; a healthy shard in flight freezes the clock.
    """

    def __init__(self, step: float):
        self.clock = ManualClock()
        self.step = float(step)
        self.futures = []
        self._lock = threading.Lock()

    def watch(self, ev: ShardedEvaluator) -> None:
        pool = ev._raw_pool
        submit = pool.submit

        def recorded(payload):
            fut = submit(payload)
            with self._lock:
                self.futures.append(fut)
            return fut

        pool.submit = recorded

    def __call__(self) -> float:
        with self._lock:
            if self.futures and all(f.done() for f in self.futures):
                self.clock.advance(self.step)
            return self.clock()


# ------------------------------------------------------------ fault plan
SEEDED = [(7, 3, 64, 0.3, None), (8, 3, 64, 0.3, None),
          (11, 2, 64, 0.3, ("crash", "slow", "corrupt")),
          (0, 1, 200, 0.05, None), (21, 4, 37, 1.0, ("hang",)),
          (3, 2, 50, 0.0, None)]


@pytest.mark.parametrize("seed,workers,dispatches,rate,kinds", SEEDED)
def test_fault_plan_seeded_equals_the_reference(seed, workers, dispatches,
                                                rate, kinds):
    """numpy draws on both sides: the same seed schedules the same events
    (worker, dispatch, kind, delay), exactly."""
    kw = dict(workers=workers, dispatches=dispatches, rate=rate,
              delay_s=0.01)
    if kinds is not None:
        kw["kinds"] = kinds
    a, b = FaultPlan.seeded(seed, **kw), JFaultPlan.seeded(seed, **kw)
    assert _events(a) == _events(b)
    assert a.scheduled == b.scheduled == len(a)
    assert a.fired == b.fired


def test_fault_plan_consumed_exactly_once():
    a = FaultPlan.seeded(7, workers=3, dispatches=64, rate=0.3)
    assert a.scheduled > 0
    (w, d) = sorted(a._events)[0]
    kind = a.peek(w, d).kind
    assert a.fire(w, d).kind == kind
    assert a.fire(w, d) is None and a.peek(w, d) is None
    assert a.fired[kind] == 1 and len(a) == a.scheduled - 1


@pytest.mark.parametrize("call", [
    lambda m: m.FaultEvent(0, 0, "meteor"),
    lambda m: m.FaultPlan.seeded(0, workers=2, dispatches=4, rate=1.5),
    lambda m: m.FaultPlan.seeded(0, workers=2, dispatches=4,
                                 kinds=("crash", "nap"))])
def test_fault_plan_validation_equals_the_reference(call):
    import repro.distributed.faults as j_faults
    import repro_torch.distributed.faults as t_faults
    with pytest.raises(ValueError) as mine:
        call(t_faults)
    with pytest.raises(ValueError) as ref:
        call(j_faults)
    assert str(mine.value) == str(ref.value)


def test_chaos_pool_injects_each_kind():
    idx = _ids(1, 4)
    payload = ShardPayload(idx, "objectives", None)
    events = [(0, 0, "crash"), (0, 1, "hang"), (0, 2, "corrupt")]
    pool = ChaosPool(_InlinePool(_fresh()),
                     FaultPlan([FaultEvent(*e) for e in events]))
    with pytest.raises(WorkerFault, match="injected crash"):
        pool.submit(payload).result(timeout=1)
    assert not pool.submit(payload).done()       # dispatch 1: hangs forever
    bad = pool.submit(payload).result(timeout=1)  # dispatch 2: corrupt
    assert (np.asarray(bad.area) <= 0).any()
    assert any(not np.isfinite(bad.latency[w]).all() for w in bad.workloads)
    good = pool.submit(payload).result(timeout=1)  # dispatch 3: clean
    _assert_reports_identical(good, _fresh().evaluate(
        EvalRequest(idx, "objectives")))
    assert pool.injected == {"crash": 1, "hang": 1, "slow": 0, "corrupt": 1}
    assert pool.dispatch_count == 4


def test_corrupt_report_equals_the_reference_and_fails_the_check():
    idx = _ids(2, 3)
    rep = _fresh().evaluate(EvalRequest(idx, "objectives"))
    j_rep = _j_fresh().evaluate(JEvalRequest(idx, "objectives"))
    bad, j_bad = corrupt_report(rep), j_corrupt_report(j_rep)
    np.testing.assert_allclose(bad.area, np.asarray(j_bad.area), rtol=RTOL)
    for w in bad.workloads:
        assert np.array_equal(np.isnan(bad.latency[w]),
                              np.isnan(np.asarray(j_bad.latency[w])))
        assert np.isfinite(rep.latency[w]).all()    # the original is intact
    ev = ShardedEvaluator(_fresh(), workers=2)
    payload = ShardPayload(np.atleast_2d(idx), "objectives", None)
    ev._check_shard(payload, rep)                # the clean one passes
    with pytest.raises(WorkerFault, match="corrupt"):
        ev._check_shard(payload, bad)
    assert ev.corrupt_rejected == 1
    ev.close()


# ------------------------------------------- sharded evaluator recovery
def _recovery_counters(ev, plan) -> dict:
    return {"retried": ev.retried, "corrupt": ev.corrupt_rejected,
            "timeouts": ev.timeouts, "twins": ev.straggler_redispatches,
            "fired": dict(plan.fired), "left": len(plan),
            "worker_dispatches": ev.worker_dispatches}


@pytest.mark.parametrize("mode", ["thread", "inline", "device"])
def test_sharded_recovers_crash_corrupt_slow_like_the_reference(mode):
    """A plan killing worker dispatches mid-run leaves the reassembled
    report bit-identical to the clean run; the fault and retry counters
    are the reference's for the same plan."""
    idx = _ids(3, 16)
    events = [(0, 0, "crash"), (1, 1, "corrupt"), (0, 2, "slow")]
    plan = FaultPlan([FaultEvent(*e, delay_s=0.01) for e in events])
    ev = ShardedEvaluator(_fresh(), workers=2, mode=mode, fault_plan=plan,
                          speculate=False)
    rep = ev.evaluate(EvalRequest(idx, "stalls"))
    _assert_reports_identical(rep, _fresh().evaluate(EvalRequest(idx,
                                                                 "stalls")))
    j_plan = JFaultPlan([JFaultEvent(*e, delay_s=0.01) for e in events])
    j_ev = JShardedEvaluator(_j_fresh(), workers=2, mode=mode,
                             fault_plan=j_plan, speculate=False)
    _assert_matches_reference(rep, j_ev.evaluate(JEvalRequest(idx, "stalls")))
    assert _recovery_counters(ev, plan) == _recovery_counters(j_ev, j_plan)
    if mode == "inline":
        # one inline worker: every dispatch is slot 0's, so worker 1's
        # corrupt event never comes due
        assert ev.retried == 1 and len(plan) == 1
    else:
        assert ev.retried == 2 and ev.corrupt_rejected == 1
        assert len(plan) == 0
    ev.close()
    j_ev.close()


def test_sharded_hang_times_out_evicts_and_reregisters():
    """A hung dispatch is declared LOST at the shard timeout: the slot is
    evicted, a replacement re-registers, and the shard retries to a
    bit-identical report.  Deterministic: the clock passes the deadline
    only after every healthy dispatch has landed."""
    idx = _ids(4, 12)
    clock = _LandedClock(step=0.1)
    ev = ShardedEvaluator(_fresh(), workers=2,
                          fault_plan=FaultPlan([FaultEvent(0, 0, "hang")]),
                          shard_timeout_s=0.3, speculate=False, clock=clock)
    clock.watch(ev)
    rep = ev.evaluate(EvalRequest(idx, "ppa"))
    _assert_reports_identical(rep, _fresh().evaluate(EvalRequest(idx, "ppa")))
    assert ev.timeouts == 1 and ev.retried == 1
    assert ev.registry.evictions == 1
    assert ev.registry.reregistrations == 1
    assert sorted(ev.registry.live()) == [0, 1]  # back to full strength
    assert ev.straggler_redispatches == 0 and ev.corrupt_rejected == 0
    ev.close()


def test_sharded_hang_speculative_twin_wins():
    """With speculation on, a hung shard's twin lands first and the hang
    never consumes retry budget (same clock discipline)."""
    idx = _ids(5, 12)
    clock = _LandedClock(step=0.05)
    ev = ShardedEvaluator(_fresh(), workers=2,
                          fault_plan=FaultPlan([FaultEvent(0, 0, "hang")]),
                          cold_straggler_s=0.2, clock=clock)
    clock.watch(ev)
    rep = ev.evaluate(EvalRequest(idx, "objectives"))
    _assert_reports_identical(rep, _fresh().evaluate(
        EvalRequest(idx, "objectives")))
    assert ev.straggler_redispatches == 1
    assert ev.retried == 0 and ev.timeouts == 0
    ev.close()


def test_sharded_elastic_resizes_after_worker_loss():
    """elastic=True: after a crash evicts a slot, plan_elastic_pool picks
    the shrunken pool size instead of oversubscribing dead slots."""
    idx = _ids(6, 16)
    ev = ShardedEvaluator(_fresh(), workers=4, elastic=True,
                          fault_plan=FaultPlan([FaultEvent(0, 0, "crash")]))
    rep = ev.evaluate(EvalRequest(idx, "objectives"))
    _assert_reports_identical(rep, _fresh().evaluate(
        EvalRequest(idx, "objectives")))
    assert ev.resizes >= 1 and ev.workers < 4
    assert sorted(ev.registry.live()) == list(range(ev.workers))
    ev.close()


def test_sharded_single_shard_still_chaos_covered():
    idx = _ids(7, 2)
    ev = ShardedEvaluator(_fresh(), workers=2, min_shard_rows=8,
                          fault_plan=FaultPlan([FaultEvent(0, 0, "crash")]))
    rep = ev.evaluate(EvalRequest(idx, "objectives"))
    _assert_reports_identical(rep, _fresh().evaluate(
        EvalRequest(idx, "objectives")))
    assert ev.retried == 1 and ev.worker_dispatches == 2
    ev.close()


def test_socket_mode_waits_for_the_serve_port():
    """Socket mode needs a fleet (``addresses=`` or ``membership=``) and
    its arguments need socket mode, as at the reference; the fabric
    itself is tested in ``tests/test_torch_serve.py``."""
    with pytest.raises(ValueError, match="repro_torch.serve"):
        ShardedEvaluator(_fresh(), workers=2, mode="socket")
    with pytest.raises(ValueError, match="addresses="):
        ShardedEvaluator(_fresh(), workers=2, addresses=[("h", 1)])
    with pytest.raises(ValueError, match="mode"):
        ShardedEvaluator(_fresh(), workers=2, mode="procss")


# ------------------------------------------------- service degradation
class _NarrowOnly:
    """Backend that only works single-worker — the worker-loss shape."""

    def __init__(self, base, workers=4):
        self._b, self.workers = base, workers
        self.space, self.tier = base.space, base.tier
        self.models = base.models
        self.workloads = base.workloads

    def resize(self, workers):
        self.workers = workers

    def evaluate(self, request):
        if self.workers > 1:
            raise WorkerFault("pool degraded")
        return self._b.evaluate(request)


class _ObjectivesOnly:
    """Backend whose detailed path is down — the proxy-demotion shape."""

    def __init__(self, base):
        self._b = base
        self.workloads = base.workloads

    def evaluate(self, request):
        if request.detail != "objectives":
            raise RuntimeError("detail backend down")
        return self._b.evaluate(request)


class _Dead:
    def __init__(self, base):
        self.workloads = base.workloads

    def evaluate(self, request):
        raise WorkerFault("backend down")


def _ladder(side: str, rung: str):
    """One degradation scenario on one side: (report, service)."""
    port = side == "port"
    fresh = _fresh if port else _j_fresh
    service = EvalService if port else JEvalService
    req = EvalRequest if port else JEvalRequest
    idx = _ids(8, 6)
    svc = service(fresh())
    if rung == "narrow":
        svc.evaluator = _NarrowOnly(fresh(), workers=4)
        fut = svc.submit(req(idx, "ppa"))
    elif rung == "proxy":
        svc.evaluator = _ObjectivesOnly(fresh())
        fut = svc.submit(req(idx, "stalls"))
    elif rung == "cached":
        svc.evaluate(req(idx, "ppa"))            # warm the shared row cache
        svc.evaluator = _Dead(svc.evaluator)     # then the backend dies
        fut = svc.submit(req(idx, "stalls"))     # asks MORE than is cached
    else:                                        # deadline already expired
        fut = svc.submit(req(idx, "stalls"), deadline_s=0.0)
    svc.tick()
    return fut.result(timeout=1), svc


@pytest.mark.parametrize("rung,detail", [("narrow", "ppa"),
                                         ("proxy", "objectives"),
                                         ("cached", "ppa"),
                                         ("deadline", "objectives")])
def test_service_degrade_rungs_equal_the_reference(rung, detail):
    """Each rung serves a correct (possibly demoted) report, counted on
    that rung, exactly as the reference's service does."""
    rep, svc = _ladder("port", rung)
    ref, j_svc = _ladder("reference", rung)
    assert rep.detail == detail
    _assert_reports_identical(rep, _fresh().evaluate(EvalRequest(_ids(8, 6),
                                                                 detail)))
    _assert_matches_reference(rep, ref)
    assert dict(svc.degraded) == dict(j_svc.degraded)
    assert svc.degraded[rung] == (2 if rung == "narrow" else 1)
    tel, j_tel = svc.telemetry(), j_svc.telemetry()
    for k in ("submits", "cache_hits", "fused_dispatches",
              "coalesced_requests"):
        assert tel[k] == j_tel[k]


def test_service_never_raises_out_of_tick():
    svc = EvalService(_fresh())
    svc.evaluator = _Dead(svc.evaluator)
    fut = svc.submit(EvalRequest(_ids(9, 3), "ppa"))
    assert svc.tick() == 0                       # never raises
    with pytest.raises(WorkerFault, match="backend down"):
        fut.result(timeout=1)
    tel = svc.telemetry()
    assert tel["degraded"]["narrow"] == 0        # no resize surface: skipped
    assert tel["fused_dispatches"] == 0
    with pytest.raises(ValueError, match="degrade"):
        EvalService(_fresh(), degrade=("narrow", "panic"))


# --------------------------------------------------- crash-safe sweeps
@pytest.fixture(scope="module")
def sweeps():
    eng = SweepEngine(get_evaluator("proxy", device="cpu"), chunk_size=CH,
                      stall_topk=4)
    return eng, eng.run(0, 5 * CH)


def _same_sweep(a, b):
    assert a.n_evaluated == b.n_evaluated and a.n_superior == b.n_superior
    for f in ("pareto_ids", "pareto_y", "topk_ids", "topk_val",
              "stall_topk_ids", "stall_topk_val"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_sweep_chaos_workers_equal_clean_and_the_reference(sweeps, tmp_path):
    """A plan crashing worker 0 mid-sweep (and slowing worker 1) leaves
    the merged 2-worker result bit-identical to the clean one-process
    sweep; the reference's chaos sweep finds the same ids and counts, and
    both engines' telemetry counts the replayed chunks alike."""
    eng, clean = sweeps
    n = 5 * CH
    ck = str(tmp_path / "ck")
    events = [(0, 2, "crash"), (1, 1, "slow")]
    c0 = eng.telemetry()["chunks"]
    plan = FaultPlan([FaultEvent(*e, delay_s=0.01) for e in events])
    res = eng.run(0, n, workers=2, checkpoint_path=ck, checkpoint_every=1,
                  fault_plan=plan)
    assert plan.fired["crash"] == 1 and plan.fired["slow"] == 1
    _same_sweep(res, clean)
    assert os.path.exists(f"{ck}.w0of2.npz")     # per-worker atomic file
    # spans of 3 and 2 chunks; worker 0's checkpoint holds chunks 0-1 when
    # it crashes, so its replay resumes at chunk 2 and no chunk runs twice
    tel = eng.telemetry()
    assert tel["chunks"] - c0 == 5
    j_eng = JSweepEngine(j_get_evaluator("proxy"), chunk_size=CH,
                         stall_topk=4)
    j_plan = JFaultPlan([JFaultEvent(*e, delay_s=0.01) for e in events])
    j_ck = str(tmp_path / "jck")
    j_res = j_eng.run(0, n, workers=2, checkpoint_path=j_ck,
                      checkpoint_every=1, fault_plan=j_plan)
    j_tel = j_eng.telemetry()
    assert tel["chunks"] - c0 == j_tel["chunks"]
    assert (tel["runs"] >= 1 and j_tel["runs"] == 1
            and set(tel) == set(j_tel) == {"runs", "chunks", "ids",
                                           "chunk_s"})
    assert set(tel["chunk_s"]) == set(j_tel["chunk_s"])
    assert res.n_superior == j_res.n_superior
    assert np.array_equal(res.pareto_ids, j_res.pareto_ids)
    assert np.array_equal(res.topk_ids, j_res.topk_ids)
    assert np.array_equal(res.stall_topk_ids, j_res.stall_topk_ids)
    np.testing.assert_allclose(res.pareto_y, j_res.pareto_y, rtol=RTOL)
    # no checkpoint at all: the crashed span replays from scratch
    c1 = eng.telemetry()["chunks"]
    plan2 = FaultPlan([FaultEvent(0, 1, "crash")])
    _same_sweep(eng.run(0, n, workers=2, fault_plan=plan2), clean)
    assert eng.telemetry()["chunks"] - c1 == 5 + 1   # chunk 0 ran twice


def test_sweep_telemetry_counts_equal_the_reference(sweeps):
    eng, _ = sweeps
    fresh = SweepEngine(eng.evaluator, chunk_size=CH)
    j_fresh = JSweepEngine(j_get_evaluator("proxy"), chunk_size=CH)
    for e in (fresh, j_fresh):
        e.run(0, 2 * CH + 100)
        e.run(0, CH, workers=2)
    tel, j_tel = fresh.telemetry(), j_fresh.telemetry()
    assert {k: tel[k] for k in ("runs", "chunks", "ids")} == \
        {k: j_tel[k] for k in ("runs", "chunks", "ids")} == \
        {"runs": 2, "chunks": 4, "ids": 3 * CH + 100}
    assert tel["chunk_s"]["count"] == j_tel["chunk_s"]["count"] == 4


def test_sweep_span_retry_budget_exhausts(sweeps):
    eng, _ = sweeps
    plan = FaultPlan([FaultEvent(0, 0, "crash"), FaultEvent(0, 1, "crash")])
    with pytest.raises(RuntimeError, match="failed after 0 retries"):
        eng.run(0, 2 * CH, fault_plan=plan,
                span_retry=RetryPolicy(max_retries=0))
    # the default budget (2 replays) rides out two crashes in a row
    plan = FaultPlan([FaultEvent(0, 0, "crash"), FaultEvent(0, 0, "crash")])
    assert eng.run(0, CH, fault_plan=plan).n_evaluated == CH


def test_sweep_corrupt_checkpoint_quarantined_not_fatal(sweeps, tmp_path):
    eng, clean5 = sweeps
    n = 2 * CH
    clean = eng.run(0, n)
    ck = str(tmp_path / "ck")
    eng.run(0, n, checkpoint_path=ck)
    fname = f"{ck}.npz"
    blob = open(fname, "rb").read()
    with open(fname, "wb") as f:
        f.write(blob[: len(blob) // 2])          # truncate mid-file
    with pytest.warns(RuntimeWarning, match="quarantined"):
        res = eng.run(0, n, resume_from=ck)
    assert os.path.exists(f"{fname}.quarantined")
    assert not os.path.exists(f"{fname}.tmp")    # atomic writes leave no tmp
    _same_sweep(res, clean)


def test_sweep_mid_kill_checkpoint_resume_bit_identical(sweeps, tmp_path):
    """Kill the sweep mid-run (retry budget 0 -> the crash surfaces), then
    resume from the atomic checkpoint: bit-identical to the clean run."""
    eng, _ = sweeps
    n = 4 * CH
    clean = eng.run(0, n)
    ck = str(tmp_path / "kill")
    with pytest.raises(RuntimeError, match="failed after"):
        eng.run(0, n, checkpoint_path=ck, checkpoint_every=1,
                fault_plan=FaultPlan([FaultEvent(0, 2, "crash")]),
                span_retry=RetryPolicy(max_retries=0))
    assert os.path.exists(f"{ck}.npz")           # chunks 0-1 were persisted
    res = eng.run(0, n, resume_from=ck)
    assert res.n_evaluated == n
    _same_sweep(res, clean)


def test_portfolio_sweep_mid_kill_resume_bit_identical(tmp_path):
    wls, scen = zoo_suite(archs=("qwen2-moe-a2.7b", "llama3.2-1b"),
                          smoke=True)
    ev = make_evaluator(wls, tier="proxy", scenarios=scen, device="cpu")
    eng = SweepEngine(ev, chunk_size=CH, stall_topk=4)
    n = 3 * CH
    clean = eng.run(0, n)
    ck = str(tmp_path / "pck")
    with pytest.raises(RuntimeError, match="failed after"):
        eng.run(0, n, checkpoint_path=ck, checkpoint_every=1,
                fault_plan=FaultPlan([FaultEvent(0, 2, "crash")]),
                span_retry=RetryPolicy(max_retries=0))
    res = eng.run(0, n, resume_from=ck)
    _same_sweep(res, clean)
    for nm in clean.scenario_names:
        _same_sweep(res.scenario(nm), clean.scenario(nm))


# ------------------------------------------- end-to-end: chaos campaign
def _campaign(side: str, chaotic: bool):
    port = side == "port"
    seeds = {"memory_bw": _ids(1, 2), "tensor_compute": _ids(2, 2)}
    fresh = _fresh if port else _j_fresh
    svc_cls = EvalService if port else JEvalService
    proxy = (get_evaluator("proxy", device="cpu") if port
             else j_get_evaluator("proxy"))
    runner_cls = CampaignRunner if port else JCampaignRunner
    sharded = None
    if chaotic:
        kw = dict(workers=2, dispatches=64, rate=0.3,
                  kinds=("crash", "slow", "corrupt"), delay_s=0.01)
        plan = (FaultPlan if port else JFaultPlan).seeded(11, **kw)
        sharded = (ShardedEvaluator if port else JShardedEvaluator)(
            fresh(), workers=2, retries=5, shard_timeout_s=2.0,
            fault_plan=plan, speculate=False)
        svc = svc_cls(sharded)
    else:
        svc = svc_cls(fresh())
    res = runner_cls(svc, proxy=proxy, seed=0).run(budget=12, seeds=seeds)
    if sharded is not None:
        sharded.close()
    return res, svc, sharded


def test_campaign_through_degrading_service_under_chaos():
    """A CampaignRunner through EvalService over a chaos-wrapped sharded
    evaluator reproduces the clean campaign exactly (samples AND
    hypervolume); the reference's chaos campaign takes the same samples,
    and the fault traffic and service counters are the reference's."""
    clean, _, _ = _campaign("port", chaotic=False)
    res, svc, sharded = _campaign("port", chaotic=True)
    ref, j_svc, j_sharded = _campaign("reference", chaotic=True)
    plan = sharded.fault_plan
    assert plan.scheduled > len(plan)            # faults actually fired
    assert sharded.retried + sharded.corrupt_rejected > 0
    assert [s.idx.tolist() for s in res.samples] == \
        [s.idx.tolist() for s in clean.samples] == \
        [s.idx.tolist() for s in ref.samples]
    assert res.phv == clean.phv                  # bit for bit
    assert res.phv == pytest.approx(ref.phv, rel=RTOL)
    sc, j_sc = res.service_counters, ref.service_counters
    assert set(sc) == set(j_sc)
    assert sc["campaign_resubmits"] == 0
    assert sc["evaluator_retried"] == sharded.retried
    assert sc["degraded"] == dict(svc.degraded)
    exact = ("submits", "cache_hits", "fused_dispatches",
             "coalesced_requests", "degraded", "campaign_resubmits",
             "evaluator_dispatches", "evaluator_worker_dispatches",
             "evaluator_retried", "evaluator_timeouts",
             "evaluator_corrupt_rejected", "evaluator_resizes",
             "evaluator_straggler_redispatches")
    assert {k: sc[k] for k in exact} == {k: j_sc[k] for k in exact}
    assert dict(plan.fired) == dict(j_sharded.fault_plan.fired)
    assert "service" in res.telemetry_dict()
