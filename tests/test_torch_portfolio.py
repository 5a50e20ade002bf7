"""The zoo-suite portfolio path on the CPU: the zoo evaluator and the
portfolio sweep against the reference (ids, classes and counts exact,
values at rtol 1e-6), and the port's own contracts bit for bit (stacked ==
looped, portfolio == brute force == the pair sweeps, workers == one
process, resumed == fresh, stored == swept)."""
import os

import numpy as np
import pytest
import torch

from repro.perfmodel import make_evaluator as j_make_evaluator
from repro.perfmodel.evaluator import EvalRequest as JRequest
from repro.perfmodel.sweep import SweepEngine as JSweepEngine
from repro.perfmodel.workload import zoo_suite as j_zoo_suite
from repro_torch.perfmodel import (CompassModel, ModelEvaluator,
                                   OracleEvaluator, RooflineModel,
                                   SweepEngine, get_evaluator,
                                   make_evaluator, pair_view, zoo_suite)
from repro_torch.perfmodel import sweep as T_sweep
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.evaluator import EvalRequest
from repro_torch.perfmodel.sweep import load_sweep_result, save_sweep_result

torch.set_num_threads(1)

# a MoE, an SSM and a dense config (tests/test_portfolio.py's TEST_ARCHS)
TEST_ARCHS = ("qwen2-moe-a2.7b", "rwkv6-7b", "llama3.2-1b")
SUB = 24_000
CHUNK = 8_192
IDX = SPACE.sample(np.random.default_rng(23), 333)
RESULT_FIELDS = ("n_evaluated", "n_superior", "pareto_y", "pareto_ids",
                 "topk_val", "topk_ids", "ref_point", "archive_truncated",
                 "stall_topk_val", "stall_topk_ids", "archive_capacity",
                 "scenario_names", "robust")


@pytest.fixture(scope="module")
def suite():
    return zoo_suite(archs=TEST_ARCHS, smoke=True)


@pytest.fixture(scope="module")
def zoo_ev(suite):
    wls, scen = suite
    return make_evaluator(wls, tier="proxy", scenarios=scen, device="cpu")


@pytest.fixture(scope="module")
def swept(zoo_ev):
    eng = SweepEngine(zoo_ev, chunk_size=CHUNK, stall_topk=4)
    return eng, eng.run(0, SUB)


@pytest.fixture(scope="module")
def ref_swept():
    """The reference's jitted portfolio sweep, once per module."""
    wls, scen = j_zoo_suite(archs=TEST_ARCHS, smoke=True)
    ev = j_make_evaluator(wls, tier="proxy", scenarios=scen)
    eng = JSweepEngine(ev, chunk_size=CHUNK, stall_topk=4)
    return eng, eng.run(0, SUB)


def assert_same_result(a, b, nested=True):
    """Every field of two SweepResults equal bit for bit (not the times)."""
    for f in RESULT_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f
        else:
            assert va == vb, f
    if nested and b.per_scenario is not None:
        assert list(a.per_scenario) == list(b.per_scenario)
        for nm in b.per_scenario:
            assert_same_result(a.per_scenario[nm], b.per_scenario[nm])


def objectives_of(rep, s):
    return np.stack([rep.latency[s.prefill], rep.latency[s.decode],
                     rep.area], axis=1)


# --------------------------------------------------- the zoo evaluator
@pytest.mark.parametrize("tier", ["proxy", "target"])
@pytest.mark.parametrize("detail", ["objectives", "ppa", "stalls"])
def test_zoo_evaluator_matches_reference(suite, tier, detail):
    wls, scen = suite
    ev = make_evaluator(wls, tier=tier, scenarios=scen, device="cpu")
    jw, js = j_zoo_suite(archs=TEST_ARCHS, smoke=True)
    jev = j_make_evaluator(jw, tier=tier, scenarios=js)
    assert ev.stacked and jev.stacked
    rep = ev.evaluate(EvalRequest(IDX, detail=detail))
    ref = jev.evaluate(JRequest(IDX, detail=detail))
    assert rep.workloads == ref.workloads
    np.testing.assert_allclose(rep.area, ref.area, rtol=1e-6)
    for w in ref.workloads:
        np.testing.assert_allclose(rep.latency[w], ref.latency[w], rtol=1e-6)
        if detail == "objectives":
            continue
        np.testing.assert_allclose(rep.op_time[w], ref.op_time[w], rtol=1e-6)
        assert rep.op_names[w] == ref.op_names[w]
        if detail == "stalls":
            np.testing.assert_allclose(rep.stall[w], ref.stall[w],
                                       rtol=1e-6, atol=1e-12)
            assert np.array_equal(rep.op_class[w], ref.op_class[w])
            assert np.array_equal(np.argmax(rep.stall[w], axis=1),
                                  np.argmax(ref.stall[w], axis=1))


@pytest.mark.parametrize("cls", [RooflineModel, CompassModel],
                         ids=["proxy", "target"])
@pytest.mark.parametrize("detail", ["objectives", "ppa", "stalls"])
def test_stacked_bit_identical_to_looped(suite, cls, detail):
    """The port's stacked union pass equals its per-workload loop bit for
    bit (the reference's own version of this does not hold)."""
    wls, _ = suite
    models = {nm: cls(wl) for nm, wl in wls.items()}
    a = ModelEvaluator(models, stacked=True, device="cpu").evaluate(
        EvalRequest(IDX, detail=detail))
    b = ModelEvaluator(models, stacked=False, device="cpu").evaluate(
        EvalRequest(IDX, detail=detail))
    assert np.array_equal(a.area, b.area)
    for w in wls:
        assert np.array_equal(a.latency[w], b.latency[w]), w
        if detail != "objectives":
            assert np.array_equal(a.op_time[w], b.op_time[w]), w
        if detail == "stalls":
            assert np.array_equal(a.stall[w], b.stall[w]), w
            assert np.array_equal(a.op_class[w], b.op_class[w]), w


def test_cuda_backend_on_the_cpu_equals_roofline(suite, zoo_ev):
    """On a CPU tensor the kernel backend runs the kernel's plain version,
    one table per workload: the same objectives bit for bit."""
    wls, scen = suite
    ev_k = make_evaluator(wls, tier="proxy", backend="cuda", scenarios=scen,
                          device="cpu")
    assert ev_k.backend == "cuda"
    d0 = ev_k.dispatches
    assert np.array_equal(ev_k.objectives(IDX), zoo_ev.objectives(IDX))
    assert ev_k.dispatches == d0 + 1
    # detail levels past objectives take the stacked torch path
    a = ev_k.stalls(IDX[:16])
    b = zoo_ev.stalls(IDX[:16])
    for w in wls:
        assert np.array_equal(a.stall[w], b.stall[w])


def test_get_evaluator_zoo_suite():
    ev = get_evaluator("proxy", suite="zoo", device="cpu")
    assert ev is get_evaluator("proxy", suite="zoo", device="cpu")
    assert ev is not get_evaluator("proxy", device="cpu")
    assert ev.stacked and len(ev.scenarios) == 10 and len(ev.workloads) == 20
    assert {"arctic-480b", "rwkv6-7b", "whisper-medium"} <= \
        {s.name for s in ev.scenarios}
    for s in ev.scenarios:
        assert s.prefill in ev.workloads and s.decode in ev.workloads
    idx = IDX[:64]
    y = ev.objectives(idx)
    assert y.shape == (64, 21) and np.isfinite(y).all()
    for backend, tier, model in (("cuda", "proxy", RooflineModel),
                                 ("auto", "proxy", RooflineModel),
                                 ("compass", "target", CompassModel),
                                 (None, "target", CompassModel)):
        e = get_evaluator(tier, backend, suite="zoo", device="cpu")
        assert len(e.scenarios) == 10 and e.tier == tier
        assert all(type(m) is model for m in e.models.values())
    assert np.array_equal(
        get_evaluator("proxy", "cuda", suite="zoo", device="cpu")
        .objectives(idx), y)
    oracle = get_evaluator("oracle", suite="zoo", device="cpu")
    assert isinstance(oracle, OracleEvaluator)
    assert oracle.base is get_evaluator("proxy", "roofline", suite="zoo",
                                        device="cpu")
    assert oracle.base.scenarios == ev.scenarios
    with pytest.raises(ValueError, match="suite"):
        get_evaluator("proxy", suite="menagerie", device="cpu")
    sharded = get_evaluator("proxy", suite="zoo", workers=2, device="cpu")
    assert sharded.scenarios == ev.scenarios and sharded.workers == 2
    assert np.array_equal(sharded.objectives(idx), y)


# --------------------------------------------------- the portfolio sweep
def test_portfolio_sweep_matches_reference(swept, ref_swept):
    eng, res = swept
    jeng, ref = ref_swept
    assert eng.fingerprint() == jeng.fingerprint()
    assert eng.chunk_size == jeng.chunk_size == CHUNK
    np.testing.assert_allclose(eng.ref_points, jeng.ref_points, rtol=1e-6)
    assert res.scenario_names == ref.scenario_names
    assert res.robust == ref.robust == "worst"
    groups = [(res, ref)] + [(res.scenario(nm), ref.scenario(nm))
                             for nm in ref.scenario_names]
    for a, b in groups:
        assert a.n_evaluated == b.n_evaluated == SUB
        assert a.n_superior == b.n_superior
        assert not a.archive_truncated and not b.archive_truncated
        assert np.array_equal(a.pareto_ids, b.pareto_ids)
        np.testing.assert_allclose(a.pareto_y, b.pareto_y, rtol=1e-6)
        assert np.array_equal(a.topk_ids, b.topk_ids)
        np.testing.assert_allclose(a.topk_val, b.topk_val, rtol=1e-6)
        np.testing.assert_allclose(a.ref_point, b.ref_point, rtol=1e-6)
    for nm in ref.scenario_names:
        a, b = res.scenario(nm), ref.scenario(nm)
        assert np.array_equal(a.stall_topk_ids, b.stall_topk_ids)
        np.testing.assert_allclose(a.stall_topk_val, b.stall_topk_val,
                                   rtol=1e-6)
    sa, sb = res.stall_seeds(), ref.stall_seeds()
    assert list(sa) == list(sb)
    for cls in sb:
        assert np.array_equal(sa[cls], sb[cls])


def test_portfolio_equals_brute_force_bit_for_bit(zoo_ev, swept):
    """Each scenario's front, top-k, superiority count and stall seeds, and
    the robust group's, equal the brute-force reduction of the port's own
    evaluator's objectives exactly."""
    eng, res = swept
    ids = np.arange(SUB)
    rep = zoo_ev.evaluate(EvalRequest(SPACE.flat_to_idx(ids),
                                      detail="stalls"))
    from repro_torch.core.pareto import pareto_mask

    def check_group(r, ys, ref32):
        front = pareto_mask(ys.astype(np.float64))
        assert np.array_equal(r.pareto_ids, ids[front])
        assert np.array_equal(r.pareto_y, ys[front].astype(np.float64))
        assert r.n_superior == int((ys < ref32[None, :]).all(axis=1).sum())
        for o in range(3):
            order = np.argsort(ys[:, o], kind="stable")[:eng.topk]
            assert np.array_equal(r.topk_ids[o], ids[order])
            assert np.array_equal(r.topk_val[o], ys[order, o])

    ys_s = []
    for i, s in enumerate(zoo_ev.scenarios):
        ys = objectives_of(rep, s)
        ys_s.append(ys)
        r = res.scenario(s.name)
        check_group(r, ys, eng.ref_points[i].astype(np.float32))
        dom = np.argmax(rep.stall[s.prefill], axis=1)
        for c in range(4):
            key = np.where(dom == c, ys[:, 0], np.inf)
            order = np.argsort(key, kind="stable")[:eng.stall_topk]
            want = np.where(np.isfinite(key[order]), ids[order], -1)
            assert np.array_equal(r.stall_topk_ids[c], want), (s.name, c)
            assert np.array_equal(r.stall_topk_val[c], key[order])
    ys_s = np.stack(ys_s, axis=1)                          # (n, S, 3)
    ratio = ys_s[:, :, :2] / eng.ref_points[None, :, :2].astype(np.float32)
    robust = np.concatenate([ratio.max(axis=1), ys_s[:, 0, 2:3]], axis=1)
    assert robust.dtype == np.float32
    check_group(res, robust, eng.ref_point.astype(np.float32))


@pytest.mark.parametrize("backend", ["roofline", "cuda"])
def test_pair_sweeps_equal_the_portfolio_scenarios(zoo_ev, suite, swept,
                                                   backend):
    """Each scenario's pair sweep (torch ops, or the kernel's plain version
    on the CPU) finds exactly its scenario's portfolio result."""
    _, res = swept
    wls, scen = suite
    ev = make_evaluator(wls, tier="proxy", backend=backend, scenarios=scen,
                        device="cpu")
    for s in scen:
        view = pair_view(ev, (s.prefill, s.decode))
        eng = SweepEngine(view, chunk_size=CHUNK, stall_topk=4)
        assert eng.backend == backend and not eng._portfolio
        r = eng.run(0, SUB)
        assert_same_result(r, res.scenario(s.name))


def test_workers_and_resume_bit_for_bit(swept, tmp_path):
    eng, res = swept
    for workers in (2, 3):
        assert_same_result(eng.run(0, SUB, workers=workers), res)
    ck = str(tmp_path / "ck")
    half = eng.run(0, SUB // 2, checkpoint_path=ck, checkpoint_every=1)
    assert half.n_evaluated == SUB // 2 and os.path.exists(ck + ".npz")
    assert_same_result(eng.run(0, SUB, resume_from=ck), res)
    # per-worker checkpoints resume too
    ck2 = str(tmp_path / "ck2")
    eng.run(0, SUB, workers=2, checkpoint_path=ck2, checkpoint_every=1)
    assert os.path.exists(ck2 + ".w0of2.npz")
    assert_same_result(eng.run(0, SUB, workers=2, resume_from=ck2), res)


def test_pair_sweep_workers_and_resume_bit_for_bit(tmp_path):
    eng = SweepEngine(get_evaluator("proxy", device="cpu"), chunk_size=4_096,
                      stall_topk=4)
    fresh = eng.run(0, 20_000)
    assert_same_result(eng.run(0, 20_000, workers=3), fresh)
    ck = str(tmp_path / "pair")
    eng.run(0, 9_000, checkpoint_path=ck)
    assert_same_result(eng.run(0, 20_000, resume_from=ck), fresh)


def test_corrupt_checkpoints_and_artifacts_are_quarantined(swept, tmp_path):
    eng, res = swept
    ck = str(tmp_path / "ck")
    eng.run(0, CHUNK, checkpoint_path=ck)
    with open(ck + ".npz", "rb") as f:
        blob = f.read()
    with open(ck + ".npz", "wb") as f:
        f.write(blob[: len(blob) // 2])                    # truncated
    with pytest.warns(RuntimeWarning, match="quarantined"):
        again = eng.run(0, SUB, resume_from=ck)
    assert os.path.exists(ck + ".npz.quarantined")
    assert_same_result(again, res)
    # a valid checkpoint of another configuration refuses
    eng.run(0, CHUNK, checkpoint_path=ck)
    other = SweepEngine(eng.evaluator, chunk_size=CHUNK, stall_topk=4,
                        robust="geomean")
    with pytest.raises(ValueError, match="different"):
        other.run(0, SUB, resume_from=ck)
    # the oracle store: a truncated artifact is re-swept, a key mismatch
    # refuses on load
    store = str(tmp_path / "store")
    o1 = OracleEvaluator(eng.evaluator, stop=SUB, oracle_store=store,
                         sweep_kwargs={"chunk_size": CHUNK, "stall_topk": 4})
    first = o1.sweep_result()
    (path,) = [os.path.join(store, f) for f in os.listdir(store)]
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:100])
    o2 = OracleEvaluator(eng.evaluator, stop=SUB, oracle_store=store,
                         sweep_kwargs={"chunk_size": CHUNK, "stall_topk": 4})
    with pytest.warns(RuntimeWarning, match="quarantined"):
        resw = o2.sweep_result()
    assert os.path.exists(path + ".quarantined")
    assert_same_result(resw, first)
    with pytest.raises(ValueError, match="configuration key"):
        load_sweep_result(path, key="another key")


def test_oracle_store_loads_without_sweeping(swept, tmp_path, monkeypatch):
    eng, res = swept
    kw = {"chunk_size": CHUNK, "stall_topk": 4}
    o1 = OracleEvaluator(eng.evaluator, stop=SUB, oracle_store=str(tmp_path),
                         sweep_kwargs=kw)
    stored = o1.sweep_result()
    assert_same_result(stored, res)
    monkeypatch.setattr(SweepEngine, "run", lambda *a, **k: pytest.fail(
        "a populated store must not sweep again"))
    o2 = OracleEvaluator(eng.evaluator, stop=SUB, oracle_store=str(tmp_path),
                         sweep_kwargs=kw)
    assert_same_result(o2.sweep_result(), stored)
    assert T_sweep.DEFAULT_ORACLE_STORE.endswith("repro_torch-oracle")
    ev = get_evaluator("oracle", oracle_store=str(tmp_path), device="cpu")
    assert ev.oracle_store == str(tmp_path)


def test_save_load_round_trip(swept, tmp_path):
    _, res = swept
    path = save_sweep_result(str(tmp_path / "res"), res, key="k")
    assert path.endswith(".npz")
    back = load_sweep_result(path, key="k")
    assert_same_result(back, res)
    assert back.seconds == res.seconds
    assert back.stall_seeds(scenario=TEST_ARCHS[1]).keys() == \
        res.stall_seeds(scenario=TEST_ARCHS[1]).keys()


def test_geomean_and_validation(zoo_ev, swept):
    eng, res = swept
    resg = SweepEngine(zoo_ev, chunk_size=CHUNK, robust="geomean").run(0,
                                                                       CHUNK)
    assert resg.robust == "geomean" and len(resg.pareto_ids) > 0
    assert np.isfinite(resg.pareto_y).all()
    with pytest.raises(ValueError, match="robust"):
        SweepEngine(zoo_ev, robust="median")
    with pytest.raises(KeyError, match="scenario"):
        res.stall_seeds(scenario="gpt5")
    with pytest.raises(ValueError, match="roofline"):
        SweepEngine(zoo_ev, backend="cuda")
    wls, scen = zoo_suite(archs=TEST_ARCHS, smoke=True)
    ev_k = make_evaluator(wls, backend="cuda", scenarios=scen, device="cpu")
    with pytest.raises(ValueError, match="roofline"):
        SweepEngine(ev_k)
    with pytest.raises(ValueError, match=r"\(3, 3\)"):
        SweepEngine(zoo_ev, ref_point=np.ones(3))
    with pytest.raises(ValueError, match="scenario="):
        SweepEngine(get_evaluator("proxy", device="cpu"),
                    chunk_size=1_000).run(0, 1_000).stall_seeds(scenario="x")
    flat = res.stall_seeds()
    assert len(flat) == 4 * len(res.scenario_names)
    one = res.stall_seeds(scenario=res.scenario_names[0])
    for cls, arr in one.items():
        assert np.array_equal(flat[f"{res.scenario_names[0]}:{cls}"], arr)
        assert arr.ndim == 2 and arr.shape[1] == SPACE.n_params
    # an explicit ref_point of the right shape is taken as given
    same = SweepEngine(zoo_ev, chunk_size=CHUNK, stall_topk=4,
                       ref_point=eng.ref_points)
    assert_same_result(same.run(0, SUB), res)


def test_pair_constructor_equals_evaluator_constructor():
    ev = get_evaluator("proxy", device="cpu")
    mt, mp = (ev.models[w] for w in ev.workloads)
    a = SweepEngine(mt, mp, chunk_size=5_000, stall_topk=4, device="cpu")
    b = SweepEngine(ev, chunk_size=5_000, stall_topk=4)
    assert a.fingerprint() == b.fingerprint()
    assert a.device == b.device == torch.device("cpu")
    assert a.evaluator.workloads == ("ttft", "tpot")
    assert_same_result(a.run(0, 15_000), b.run(0, 15_000))
    k = SweepEngine(mt, mp, chunk_size=5_000, backend="cuda", device="cpu")
    assert k.backend == "cuda" and k.chunk_size == 5_120
    with pytest.raises(TypeError):
        SweepEngine(mt)
    with pytest.raises(ValueError, match="device"):
        SweepEngine(ev, device="meta")


def test_chunk_size_auto(zoo_ev, swept):
    eng, res = swept
    cands = (4_096, CHUNK)
    auto = SweepEngine(zoo_ev, chunk_size="auto", chunk_candidates=cands,
                       stall_topk=4)
    assert auto.chunk_size in cands
    again = SweepEngine(zoo_ev, chunk_size="auto", chunk_candidates=cands,
                        stall_topk=4)
    assert again.chunk_size == auto.chunk_size           # memoized
    assert_same_result(auto.run(0, SUB), res)
    with pytest.raises(ValueError, match="chunk_candidates"):
        SweepEngine(zoo_ev, chunk_size="auto", chunk_candidates=())
    with pytest.raises(ValueError, match="auto"):
        SweepEngine(zoo_ev, chunk_size="fast")
    # on the kernel backend the chosen chunk stays whole 256-row blocks
    ev_k = get_evaluator("proxy", backend="cuda", device="cpu")
    k = SweepEngine(ev_k, chunk_size="auto", chunk_candidates=(1_000, 3_000))
    assert k.chunk_size in (1_024, 3_072)

