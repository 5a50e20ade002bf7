"""The port's distributed evaluation layer against the reference's
(``tests/test_distributed.py``): ``ShardedEvaluator`` in every local pool
mode, ``get_evaluator(workers=, mode=)``, the N-worker sweep, the
coalescing ``EvalService`` and ``CampaignRunner`` through it.

Contracts: within the port, a sharded or coalesced report equals the
plain in-process evaluation bit for bit (every design row is computed on
its own, so shard boundaries cannot move a bit); against the reference,
ids, classes, counts and dispatch counters are exact and every float is
held at rtol 1e-6.
"""
import pickle
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.core.campaign import CampaignRunner as JCampaignRunner
from repro.distributed import EvalService as JEvalService
from repro.distributed import ShardedEvaluator as JShardedEvaluator
from repro.perfmodel import EvalRequest as JEvalRequest
from repro.perfmodel import ModelEvaluator as JModelEvaluator
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro_torch.core.campaign import CampaignRunner
from repro_torch.core.loop import LuminaDSE
from repro_torch.distributed import (MODES, EvalService, ShardedEvaluator,
                                     WorkerRegistry, concat_reports,
                                     evaluator_from_spec)
from repro_torch.distributed.sharded import _InlinePool, _worker_spec
from repro_torch.perfmodel import (EvalRequest, ModelEvaluator, as_evaluator,
                                   get_evaluator)
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.sweep import SweepEngine

torch.set_num_threads(1)

RTOL = 1e-6
DETAILS = ("objectives", "ppa", "stalls")


def _ids(seed: int, n: int) -> np.ndarray:
    return SPACE.sample(np.random.default_rng(seed), n)


def _fresh(tier: str = "proxy") -> ModelEvaluator:
    """A fresh evaluator (own dispatch counter) over the memoized models."""
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
    assert rep.workloads == ref.workloads and rep.detail == ref.detail
    np.testing.assert_allclose(rep.area, np.asarray(ref.area), rtol=RTOL)
    for w in rep.workloads:
        np.testing.assert_allclose(rep.latency[w], np.asarray(ref.latency[w]),
                                   rtol=RTOL)
        if rep.detail == "stalls":
            np.testing.assert_allclose(rep.stall[w], np.asarray(ref.stall[w]),
                                       rtol=RTOL)
            assert np.array_equal(rep.op_class[w], np.asarray(ref.op_class[w]))


# ------------------------------------------------------- sharded evaluator
@pytest.mark.parametrize("tier", ["proxy", "target"])
@pytest.mark.parametrize("mode,workers", [("thread", 3), ("thread", 2),
                                          ("device", 2), ("device", 4),
                                          ("inline", 2)])
def test_sharded_bit_identical_to_local(tier, mode, workers):
    """ShardedEvaluator(workers=N) reassembles a PPAReport bit-identical to
    the local fused path at every detail level, on both fidelity tiers;
    the reference's sharded report agrees at rtol 1e-6."""
    idx = _ids(3, 23)                            # odd size: uneven shards
    local = _fresh(tier)
    sharded = ShardedEvaluator(_fresh(tier), workers=workers, mode=mode,
                               speculate=False)
    j_sharded = JShardedEvaluator(_j_fresh(tier), workers=workers,
                                  mode="thread")
    assert sharded.mode == mode and sharded.device == torch.device("cpu")
    for detail in DETAILS:
        rep = sharded.evaluate(EvalRequest(idx, detail=detail))
        _assert_reports_identical(rep, local.evaluate(EvalRequest(idx,
                                                                  detail)))
        _assert_matches_reference(rep, j_sharded.evaluate(
            JEvalRequest(idx, detail=detail)))
    assert np.array_equal(sharded.objectives(idx), local.objectives(idx))
    assert sharded.dispatches == 4
    n_shards = 1 if mode == "inline" else min(workers, 23)
    assert sharded.worker_dispatches == (
        4 if mode == "inline" else 4 * n_shards)
    sharded.close()
    j_sharded.close()


def test_sharded_workers1_inline_fallback():
    idx = _ids(4, 9)
    sharded = ShardedEvaluator(_fresh(), workers=1, mode="auto")
    assert sharded.mode == "inline"
    _assert_reports_identical(sharded.evaluate(EvalRequest(idx, "stalls")),
                              _fresh().evaluate(EvalRequest(idx, "stalls")))
    assert sharded.dispatches == 1               # one logical fused request
    assert sharded.worker_dispatches == 1        # served on-thread


def test_thread_workers_lose_no_dispatch_count():
    """More thread workers than cores and a short switch interval: the
    shared base evaluator counts every shard's dispatch."""
    import sys
    base = _fresh()
    # no speculation: a twin cancelled before it starts never dispatches
    sharded = ShardedEvaluator(base, workers=16, mode="thread",
                               speculate=False)
    idx = _ids(16, 64)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(8):
            sharded.evaluate(EvalRequest(idx, "objectives"))
    finally:
        sys.setswitchinterval(old)
        sharded.close()
    assert sharded.worker_dispatches == 8 * 16
    assert base.dispatches == sharded.worker_dispatches


def test_sharded_small_batch_stays_on_one_worker():
    sharded = ShardedEvaluator(_fresh(), workers=4, min_shard_rows=8)
    sharded.evaluate(EvalRequest(_ids(5, 5), "objectives"))
    assert sharded.worker_dispatches == 1        # below min_shard_rows x 2
    sharded.close()


def test_sharded_process_mode_bit_identical():
    """Spawned workers rebuild the evaluator from its pickled spec, on the
    base's kind of device, and reproduce the local result exactly."""
    idx = _ids(6, 12)
    sharded = ShardedEvaluator(_fresh(), workers=2, mode="process",
                               speculate=False)
    try:
        rep = sharded.evaluate(EvalRequest(idx, "stalls"))
        _assert_reports_identical(rep, _fresh().evaluate(
            EvalRequest(idx, "stalls")))
        assert sharded.worker_dispatches == 2
    finally:
        sharded.close()


def test_worker_spec_round_trip():
    """The spec names the base's models, tier, backend and device type;
    the rebuilt evaluator is the same evaluator."""
    base = _fresh("target")
    spec = pickle.loads(_worker_spec(base))
    assert spec["device"] == "cpu" and spec["tier"] == "target"
    assert set(spec["models"]) == set(base.models)
    rebuilt = evaluator_from_spec(_worker_spec(base))
    assert isinstance(rebuilt, ModelEvaluator)
    assert rebuilt.device == base.device and rebuilt.backend == base.backend
    assert rebuilt.stacked == base.stacked and rebuilt.tier == "target"
    idx = _ids(7, 5)
    _assert_reports_identical(rebuilt.evaluate(EvalRequest(idx, "ppa")),
                              base.evaluate(EvalRequest(idx, "ppa")))
    assert evaluator_from_spec(_worker_spec(base), loads=pickle.loads).tier \
        == "target"
    with pytest.raises(TypeError, match="ModelEvaluator"):
        ShardedEvaluator(ShardedEvaluator(_fresh(), workers=1), workers=2,
                         mode="process")


def test_concat_reports_in_shard_order():
    ev = _fresh()
    idx = _ids(8, 10)
    parts = [ev.evaluate(EvalRequest(s, "stalls"))
             for s in np.array_split(idx, 3)]
    _assert_reports_identical(concat_reports(parts),
                              ev.evaluate(EvalRequest(idx, "stalls")))
    assert concat_reports(parts[:1]) is parts[0]


class _FlakyPool:
    """Fails the first `fail_first` shard submissions, then delegates."""
    mode = "thread"

    def __init__(self, base, fail_first: int):
        self._inner = _InlinePool(base)
        self.workers = 3
        self._fails = fail_first

    def submit(self, payload):
        if self._fails > 0:
            self._fails -= 1
            fut: Future = Future()
            fut.set_exception(RuntimeError("worker died"))
            return fut
        return self._inner.submit(payload)

    def close(self):
        pass


@pytest.mark.parametrize("fail_first", [1, 2])
def test_sharded_retries_failed_workers(fail_first):
    idx = _ids(9, 21)
    sharded = ShardedEvaluator(_fresh(), workers=3, retries=2)
    sharded._pool = _FlakyPool(sharded.base, fail_first=fail_first)
    rep = sharded.evaluate(EvalRequest(idx, "stalls"))
    _assert_reports_identical(rep, _fresh().evaluate(
        EvalRequest(idx, "stalls")))
    assert sharded.retried == fail_first
    assert sharded.registry.evictions == fail_first
    assert sharded.registry.reregistrations == fail_first


def test_sharded_raises_after_retry_budget():
    sharded = ShardedEvaluator(_fresh(), workers=3, retries=1)
    sharded._pool = _FlakyPool(sharded.base, fail_first=100)
    with pytest.raises(RuntimeError, match="failed after 2 attempts"):
        sharded.evaluate(EvalRequest(_ids(10, 9), "objectives"))


class _HangOnePool:
    """First submission of shard `hang_nth` never resolves; everything else
    (incl. its backup) evaluates inline."""
    mode = "thread"

    def __init__(self, base, hang_nth: int):
        self._inner = _InlinePool(base)
        self.workers = 3
        self._hang_nth = hang_nth
        self._n = 0

    def submit(self, payload):
        n = self._n
        self._n += 1
        if n == self._hang_nth:
            return Future()                      # pending forever
        return self._inner.submit(payload)

    def close(self):
        pass


def test_sharded_straggler_redispatch():
    """A shard whose worker hangs is re-dispatched once the inline shards'
    median time makes it a straggler; the twin's result is used."""
    idx = _ids(11, 21)
    sharded = ShardedEvaluator(_fresh(), workers=3, straggler_min_s=0.01)
    sharded._pool = _HangOnePool(sharded.base, hang_nth=1)
    rep = sharded.evaluate(EvalRequest(idx, "stalls"))
    _assert_reports_identical(rep, _fresh().evaluate(
        EvalRequest(idx, "stalls")))
    assert sharded.straggler_redispatches == 1
    assert sharded.retried == 0


def test_get_evaluator_workers_knob():
    ev = get_evaluator("proxy", workers=2, device="cpu")
    assert isinstance(ev, ShardedEvaluator) and ev.workers == 2
    assert ev.mode == "thread" and ev.device == torch.device("cpu")
    assert get_evaluator("proxy", workers=2, device="cpu") is ev   # memoized
    base = get_evaluator("proxy", device="cpu")
    assert isinstance(base, ModelEvaluator)
    # inert knobs collapse onto the memoized base instance; bad modes raise
    assert get_evaluator("proxy", workers=1, mode="thread",
                         device="cpu") is base
    with pytest.raises(ValueError, match="mode"):
        get_evaluator("proxy", workers=2, mode="procss", device="cpu")
    assert as_evaluator(ev) is ev                          # protocol member
    idx = _ids(12, 6)
    assert np.array_equal(ev.objectives(idx), base.objectives(idx))
    dev = get_evaluator("proxy", workers=2, mode="device", device="cpu")
    assert dev.mode == "device" and dev is not ev
    oracle = get_evaluator("oracle", workers=2, device="cpu",
                           oracle_stop=4_096)
    assert isinstance(oracle.base, ShardedEvaluator)
    assert oracle.base.workers == 2 and oracle.workloads == ev.workloads
    assert oracle.base is get_evaluator("proxy", "roofline", workers=2,
                                        device="cpu")
    assert MODES == ("auto", "inline", "thread", "process", "device",
                     "socket")


# ------------------------------------------------------- multi-worker sweep
@pytest.fixture(scope="module")
def sweep_engine():
    return SweepEngine(get_evaluator("proxy", device="cpu"), chunk_size=8_192,
                       stall_topk=4, stall_rank="ref")


def test_n_worker_sweep_identical_to_single(sweep_engine):
    """The N-worker sweep reproduces the single-process front, top-k tables
    and stall_seeds() exactly; so does a sweep over a sharded evaluator."""
    single = sweep_engine.run(0, 60_000)
    multi = sweep_engine.run(0, 60_000, workers=3)
    over_sharded = SweepEngine(get_evaluator("proxy", workers=2,
                                             device="cpu"),
                               chunk_size=8_192, stall_topk=4,
                               stall_rank="ref").run(0, 60_000)
    for res in (multi, over_sharded):
        assert res.n_evaluated == single.n_evaluated
        assert res.n_superior == single.n_superior
        for f in ("pareto_ids", "pareto_y", "topk_val", "topk_ids",
                  "stall_topk_val", "stall_topk_ids"):
            assert np.array_equal(getattr(res, f), getattr(single, f)), f
    ss, ms = single.stall_seeds(), multi.stall_seeds()
    assert set(ss) == set(ms)
    for k in ss:
        assert np.array_equal(ss[k], ms[k])


def test_worker_checkpoints_roundtrip_and_span_guard(sweep_engine, tmp_path):
    ck = str(tmp_path / "wsweep")
    full = sweep_engine.run(0, 32_768, workers=2, checkpoint_path=ck)
    resumed = sweep_engine.run(0, 32_768, workers=2, resume_from=ck)
    assert np.array_equal(resumed.pareto_ids, full.pareto_ids)
    assert np.array_equal(resumed.topk_val, full.topk_val)
    assert resumed.n_evaluated == full.n_evaluated
    with pytest.raises(ValueError, match="different"):
        sweep_engine.run(0, 65_536, workers=2, resume_from=ck)


# ------------------------------------------------------------- EvalService
def _coalesce(side: str):
    port = side == "port"
    ev = _fresh() if port else _j_fresh()
    svc = (EvalService if port else JEvalService)(ev)
    req = EvalRequest if port else JEvalRequest
    reqs = [req(_ids(20 + i, 3), detail="stalls") for i in range(3)]
    reqs.append(req(reqs[0].idx[:2], detail="objectives"))  # overlap
    d0 = ev.dispatches
    futs = [svc.submit(r, client=f"c{i}") for i, r in enumerate(reqs)]
    rows = svc.tick()
    return ev.dispatches - d0, rows, [f.result() for f in futs], svc


def test_service_coalesces_k_clients_into_one_dispatch():
    """K clients' requests fuse into ONE dispatch per tick; each future
    resolves to what a direct evaluation gives, as in the reference."""
    dispatched, rows, reps, svc = _coalesce("port")
    j_dispatched, j_rows, j_reps, j_svc = _coalesce("reference")
    assert (dispatched, rows) == (j_dispatched, j_rows) == (1, 9)
    local = _fresh()
    for i, (rep, ref) in enumerate(zip(reps, j_reps)):
        idx = _ids(20, 3)[:2] if i == 3 else _ids(20 + i, 3)
        _assert_reports_identical(rep, local.evaluate(
            EvalRequest(idx, rep.detail)))
        _assert_matches_reference(rep, ref)
    assert svc.fused_dispatches == 1 and svc.coalesced_requests == 4
    tel, j_tel = svc.telemetry(), j_svc.telemetry()
    assert set(tel) == set(j_tel)
    for k in ("submits", "cache_hits", "fused_dispatches",
              "coalesced_requests", "degraded"):
        assert tel[k] == j_tel[k]
    for t in tel["tiers"]:
        assert (tel["tiers"][t]["served"], tel["tiers"][t]["queued"]) == \
            (j_tel["tiers"][t]["served"], j_tel["tiers"][t]["queued"])


def test_service_shared_cache_across_clients():
    ev = _fresh()
    svc = EvalService(ev)
    idx = _ids(13, 5)
    svc.submit(EvalRequest(idx, detail="stalls"))
    svc.tick()
    d0 = ev.dispatches
    fut = svc.submit(EvalRequest(idx[2:4], detail="objectives"))
    assert fut.done() and svc.cache_hits == 1
    assert svc.tick() == 0                       # nothing left to dispatch
    assert ev.dispatches == d0
    _assert_reports_identical(fut.result(), _fresh().evaluate(
        EvalRequest(idx[2:4], "objectives")))


def test_service_detail_promotion_reevaluates():
    ev = _fresh()
    svc = EvalService(ev)
    idx = _ids(14, 4)
    svc.submit(EvalRequest(idx, detail="objectives"))
    assert svc.tick() == 4
    fut = svc.submit(EvalRequest(idx, detail="stalls"))
    assert not fut.done()                        # cached too shallow
    assert svc.tick() == 4                       # re-dispatched at "stalls"
    _assert_reports_identical(fut.result(), _fresh().evaluate(
        EvalRequest(idx, "stalls")))
    assert svc.submit(EvalRequest(idx, detail="objectives")).done()


def test_service_dispatch_failure_lands_on_futures():
    svc = EvalService(_fresh())
    fut = svc.submit(EvalRequest(_ids(15, 3), "objectives"))

    class _Broken:
        def evaluate(self, request):
            raise RuntimeError("backend down")

    svc.evaluator = _Broken()
    assert svc.tick() == 0
    with pytest.raises(RuntimeError, match="backend down"):
        fut.result(timeout=1)
    assert svc.fused_dispatches == 0
    with pytest.raises(ValueError, match="tier"):
        svc.submit(EvalRequest(_ids(15, 1), "objectives"), tier="vip")
    with pytest.raises(ValueError, match="QoS"):
        EvalService(_fresh(), tier_weights={"gold": 2.0})


def test_service_is_a_drop_in_evaluator():
    svc = EvalService(_fresh())
    assert as_evaluator(svc) is svc
    res = LuminaDSE(svc, proxy=get_evaluator("proxy", device="cpu"),
                    seed=0).run(budget=4)
    assert len(res.samples) == 4


def _service_campaign(side: str):
    port = side == "port"
    ev = _fresh() if port else _j_fresh()
    svc = (EvalService if port else JEvalService)(ev)
    runner = (CampaignRunner if port else JCampaignRunner)(
        svc, proxy=(get_evaluator("proxy", device="cpu") if port
                    else j_get_evaluator("proxy")), seed=0)
    seeds = {"memory_bw": _ids(30, 2), "tensor_compute": _ids(31, 2)}
    return runner, runner.run(budget=12, seeds=seeds), svc


def test_campaign_runner_through_service_one_dispatch_per_round():
    """K campaigns through the service cost ONE fused dispatch per round,
    the service owning the batching; the run is the reference's."""
    runner, res, svc = _service_campaign("port")
    _, ref, j_svc = _service_campaign("reference")
    assert runner._service is svc and runner.tracer is svc.tracer
    k = len(res.per_campaign)
    assert k >= 3 and len(res.samples) == 12
    assert res.rounds <= -(-12 // k) + 1
    assert res.dispatches <= res.rounds + k + 2 and res.dispatches < 12
    assert svc.fused_dispatches <= res.rounds + k + 2
    assert [s.idx.tolist() for s in res.samples] == \
        [s.idx.tolist() for s in ref.samples]
    assert (res.rounds, res.dispatches) == (ref.rounds, ref.dispatches)
    assert res.phv == pytest.approx(ref.phv, rel=RTOL)
    assert set(res.service_counters) == set(ref.service_counters)
    for key in ("submits", "cache_hits", "fused_dispatches",
                "coalesced_requests", "degraded", "campaign_resubmits"):
        assert res.service_counters[key] == ref.service_counters[key]
    assert res.service_counters["tiers"]["interactive"]["served"] == \
        ref.service_counters["tiers"]["interactive"]["served"] > 0
    assert res.metrics == ref.metrics


def test_service_round_robin_fairness_no_starvation():
    svc = EvalService(_fresh(), max_rows_per_tick=4)
    chatty = [svc.submit(EvalRequest(_ids(40 + i, 1), "objectives"),
                         client="chatty") for i in range(24)]
    quiet = svc.submit(EvalRequest(_ids(70, 1), "objectives"),
                       client="quiet")
    svc.tick()
    assert quiet.done()                          # served in the FIRST tick
    assert not all(f.done() for f in chatty)
    ticks = 1
    while not all(f.done() for f in chatty):
        assert svc.tick() >= 0
        ticks += 1
        assert ticks < 50
    assert ticks > 2                             # the cap really paced it
    assert all(f.result().n == 1 for f in chatty)


def test_service_tiers_drain_by_weighted_deficit():
    """Interactive traffic preempts batch and scavenger proportionally, and
    the anti-starvation floor serves every tier in the first tick."""
    svc = EvalService(_fresh(), max_rows_per_tick=6)
    futs = {t: [svc.submit(EvalRequest(_ids(80 + 10 * j + i, 1),
                                       "objectives"), tier=t)
                for i in range(8)]
            for j, t in enumerate(("interactive", "batch", "scavenger"))}
    svc.tick()
    assert all(any(f.done() for f in fs) for fs in futs.values())
    n_done = {t: sum(f.done() for f in fs) for t, fs in futs.items()}
    assert n_done["interactive"] >= n_done["batch"] >= n_done["scavenger"]
    while svc.tick():
        pass
    tel = svc.telemetry()["tiers"]
    assert all(tel[t]["served"] == 8 and tel[t]["queued"] == 0 for t in tel)


def test_service_fair_drain_rotates_between_clients():
    svc = EvalService(_fresh())
    futs = [svc.submit(EvalRequest(_ids(90 + i, 2), "objectives"),
                       client=f"c{i % 3}") for i in range(9)]
    svc.tick()
    assert all(f.done() for f in futs)
    svc2 = EvalService(_fresh(), max_rows_per_tick=1)
    a1 = svc2.submit(EvalRequest(_ids(100, 1), "objectives"), client="a")
    a2 = svc2.submit(EvalRequest(_ids(101, 1), "objectives"), client="a")
    svc2.tick()
    assert a1.done() and not a2.done()           # FIFO within the lane
    svc2.tick()
    assert a2.done()


def test_service_autostart_batcher_resolves_and_closes():
    svc = EvalService(_fresh(), autostart=True, window_s=0.001)
    try:
        idx = _ids(102, 3)
        rep = svc.submit(EvalRequest(idx, "ppa")).result(timeout=30)
        _assert_reports_identical(rep, _fresh().evaluate(
            EvalRequest(idx, "ppa")))
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(EvalRequest(_ids(103, 1), "objectives"))


@pytest.mark.parametrize("mode", ["thread", "device"])
def test_service_composes_with_sharded_evaluator(mode):
    sharded = ShardedEvaluator(_fresh(), workers=2, mode=mode)
    svc = EvalService(sharded)
    idx = _ids(104, 8)
    futs = [svc.submit(EvalRequest(idx[:5], "stalls")),
            svc.submit(EvalRequest(idx[3:], "stalls"))]
    svc.tick()
    assert sharded.dispatches == 1               # one fused, sharded dispatch
    local = _fresh()
    _assert_reports_identical(futs[0].result(),
                              local.evaluate(EvalRequest(idx[:5], "stalls")))
    _assert_reports_identical(futs[1].result(),
                              local.evaluate(EvalRequest(idx[3:], "stalls")))
    sharded.close()


# -------------------------------------------------------- worker liveness
def _drive_registry(registry_cls):
    clock = {"t": 0.0}
    reg = registry_cls(timeout_s=10.0, now=lambda: clock["t"])
    out = []
    for w in (0, 1, 2):
        reg.register(w)
    out.append((reg.live(), len(reg)))
    clock["t"] = 8.0
    reg.beat(1)
    clock["t"] = 12.0
    out.append((reg.live(), reg.alive(1), reg.alive(0), reg.evict_dead(),
                reg.evictions, len(reg)))
    reg.mark_dead(1)
    out.append((reg.alive(1), reg.evict_dead()))
    reg.register(1)
    reg.beat(7)
    out.append((reg.reregistrations, reg.alive(1), reg.live(), reg.alive(7),
                reg.snapshot()))
    return out


def test_worker_registry_equals_the_reference():
    from repro.distributed import WorkerRegistry as JWorkerRegistry
    got = _drive_registry(WorkerRegistry)
    assert got == _drive_registry(JWorkerRegistry)
    assert got[1][3] == [0, 2] and got[3][0] == 1


def test_sharded_resize_rewires_pool_and_registry():
    ev = ShardedEvaluator(_fresh(), workers=4, mode="thread", max_workers=4)
    try:
        idx = _ids(105, 12)
        before = ev.evaluate(EvalRequest(idx, "ppa"))
        assert sorted(ev.registry.live()) == [0, 1, 2, 3]
        ev.resize(2)
        assert ev.workers == 2 and ev._pool.workers == 2
        assert sorted(ev.registry.live()) == [0, 1]
        assert ev.resizes == 1
        _assert_reports_identical(before, ev.evaluate(EvalRequest(idx,
                                                                  "ppa")))
        ev.resize(99)                             # clamped to max_workers
        assert ev.workers == 4
        ev.resize(0)                              # clamped to 1
        assert ev.workers == 1 and sorted(ev.registry.live()) == [0]
    finally:
        ev.close()
