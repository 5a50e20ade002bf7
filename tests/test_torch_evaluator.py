"""The tiered Evaluator API: PPAReport fields against the reference at every
detail level, the dispatch contract, the backend registry rules."""
import numpy as np
import pytest
import torch

from repro.perfmodel import get_evaluator as j_get_evaluator
from repro.perfmodel import workload as J_W
from repro.perfmodel.critical_path import attribute_stalls as j_attribute
from repro.perfmodel.evaluator import EvalRequest as JRequest
from repro.perfmodel.roofline import RooflineModel as JRoofline
from repro_torch.perfmodel import workload as T_W
from repro_torch.perfmodel.critical_path import attribute_stalls
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.evaluator import (EvalRequest, OracleEvaluator,
                                             RowCache, as_evaluator,
                                             backend_names, get_evaluator,
                                             make_evaluator, pair_view)
from repro_torch.perfmodel.roofline import RooflineModel

torch.set_num_threads(1)

IDX = SPACE.sample(np.random.default_rng(31), 777)


@pytest.mark.parametrize("tier", ["proxy", "target"])
@pytest.mark.parametrize("detail", ["objectives", "ppa", "stalls"])
def test_report_matches_reference(tier, detail):
    ev = get_evaluator(tier, device="cpu")
    rep = ev.evaluate(EvalRequest(IDX, detail=detail))
    ref = j_get_evaluator(tier).evaluate(JRequest(IDX, detail=detail))
    assert rep.workloads == ref.workloads and rep.detail == ref.detail
    np.testing.assert_allclose(rep.area, ref.area, rtol=1e-6)
    np.testing.assert_allclose(rep.objectives, ref.objectives, rtol=1e-6)
    for w in ref.workloads:
        np.testing.assert_allclose(rep.latency[w], ref.latency[w], rtol=1e-6)
        if detail == "objectives":
            assert rep.op_time is None and rep.stall is None
            continue
        np.testing.assert_allclose(rep.op_time[w], ref.op_time[w], rtol=1e-6)
        assert rep.op_names[w] == ref.op_names[w]
        if detail == "stalls":
            np.testing.assert_allclose(rep.stall[w], ref.stall[w],
                                       rtol=1e-6, atol=1e-12)
            assert np.array_equal(rep.op_class[w], ref.op_class[w])
            a, b = rep.stall_report(w, i=5), ref.stall_report(w, i=5)
            assert (a.dominant, [t[:2] for t in a.top_ops]) == \
                (b.dominant, [t[:2] for t in b.top_ops])


def test_one_dispatch_per_evaluate():
    ev = make_evaluator(dict(zip(("ttft", "tpot"),
                                 T_W.paper_suite()[0].values())),
                        device="cpu")
    for i, detail in enumerate(("objectives", "ppa", "stalls", "stalls")):
        ev.evaluate(EvalRequest(IDX[: 10 * (i + 1)], detail=detail))
        assert ev.dispatches == i + 1
    ev.objectives(IDX[0])
    assert ev.dispatches == 5


def test_cuda_backend_rules():
    assert set(backend_names()) >= {"roofline", "compass", "cuda"}
    with pytest.raises(ValueError, match="compass-tier knobs"):
        get_evaluator("target", backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="compass-tier knobs"):
        make_evaluator({"a": T_W.gpt3_layer_prefill()}, tier="target",
                       backend="cuda", device="cpu")
    # on the CPU the kernel backend runs its plain version: same numbers
    ev_k = get_evaluator("proxy", backend="cuda", device="cpu")
    ev_r = get_evaluator("proxy", backend="roofline", device="cpu")
    assert ev_k.backend == "cuda"
    assert np.array_equal(ev_k.objectives(IDX), ev_r.objectives(IDX))
    # "auto" times candidates only on the card
    assert get_evaluator("proxy", backend="auto",
                         device="cpu").backend == "roofline"
    # the zoo suite takes the kernel backend too: all 20 workloads in one
    # dispatch, the same numbers as its roofline backend
    zoo_k = get_evaluator("proxy", backend="cuda", suite="zoo", device="cpu")
    zoo_r = get_evaluator("proxy", suite="zoo", device="cpu")
    assert zoo_k.backend == "cuda" and len(zoo_k.workloads) == 20
    d0 = zoo_k.dispatches
    assert np.array_equal(zoo_k.objectives(IDX[:50]),
                          zoo_r.objectives(IDX[:50]))
    assert zoo_k.dispatches == d0 + 1
    # workers > 1 shards the kernel backend's dispatch: the same numbers
    sharded = get_evaluator("proxy", backend="cuda", workers=2, device="cpu")
    assert sharded.backend == "cuda" and sharded.workers == 2
    assert np.array_equal(sharded.objectives(IDX), ev_k.objectives(IDX))


def test_views_and_single_model_evaluators():
    ev = get_evaluator("proxy", device="cpu")
    assert pair_view(ev, ("ttft", "tpot")) is ev
    view = pair_view(ev, ("tpot", "ttft"))
    assert view.device == ev.device
    assert np.array_equal(view.objectives(IDX)[:, 0], ev.objectives(IDX)[:, 1])
    with pytest.raises(KeyError):
        pair_view(ev, ("ttft", "nope"))
    assert as_evaluator(ev) is ev
    model = RooflineModel(T_W.gpt3_layer_decode())
    single = as_evaluator(model, device="cpu")
    assert single.workloads == ("lat",)
    got = attribute_stalls(model, IDX[3], device="cpu")
    want = j_attribute(JRoofline(J_W.gpt3_layer_decode()), IDX[3])
    assert got.dominant == want.dominant
    assert got.latency == pytest.approx(want.latency, rel=1e-6)
    assert [t[:2] for t in got.top_ops] == [t[:2] for t in want.top_ops]
    with pytest.raises(TypeError):
        as_evaluator(object())


def test_row_cache_semantics():
    ev = get_evaluator("proxy", device="cpu")
    rep = ev.stalls(IDX[:2])
    cache = RowCache(capacity=1)
    k0, k1 = RowCache.key(IDX[0]), RowCache.key(IDX[1])
    cache.put(k0, "stalls", rep.row(0))
    assert cache.get(k0, "objectives", ("ttft",)) is not None
    assert cache.get(k0, "stalls", ("ttft", "other")) is None
    assert cache.get_any(k0, ("tpot",))[0] == "stalls"
    cache.put(k1, "objectives", rep.row(1))
    assert len(cache) == 1 and cache.get(k0, "objectives", ("ttft",)) is None


def test_oracle_scores_against_the_swept_front():
    base = get_evaluator("proxy", device="cpu")
    oracle = OracleEvaluator(base, stop=20_000,
                             sweep_kwargs={"chunk_size": 8_192})
    front = oracle.front()
    assert front.shape[1] == 3 and len(front) == len(oracle.front_idx())
    ref = np.max(front, axis=0) * 1.1
    assert oracle.normalized_phv(oracle.oracle_phv(ref), ref) == \
        pytest.approx(1.0)
    assert np.all(oracle.regret(front) == 0.0)
    handed = OracleEvaluator(base, result=oracle.sweep_result())
    assert handed.sweep_result() is oracle.sweep_result()
    assert np.array_equal(handed.objectives(IDX), base.objectives(IDX))
