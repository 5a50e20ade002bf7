"""The LUMINA DSE loop on the port: the budget-20 run on the paper pair
follows the reference's trajectory; the numpy core equals the reference's."""
import numpy as np
import pytest
import torch

from repro.core import pareto as J_P
from repro.core.llm import RuleOracle as JRuleOracle
from repro.core.loop import LuminaDSE as JLuminaDSE
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro_torch.analysis import primary_resources
from repro_torch.core import pareto as T_P
from repro_torch.core.llm import DegradedOracle, RuleOracle
from repro_torch.core.loop import LuminaDSE
from repro_torch.perfmodel import get_evaluator

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    ev = get_evaluator("proxy", device="cpu")
    d0 = ev.dispatches
    port = LuminaDSE(ev, seed=0).run(budget=20)
    dispatches = ev.dispatches - d0
    ref = JLuminaDSE(j_get_evaluator("proxy"), seed=0).run(budget=20)
    return port, ref, dispatches


def test_budget20_trajectory_matches_reference(runs):
    port, ref, _ = runs
    assert len(port.samples) == len(ref.samples) == 20
    assert np.array_equal(np.stack([s.idx for s in port.samples]),
                          np.stack([s.idx for s in ref.samples]))
    assert ([s.dominant_stall for s in port.samples]
            == [s.dominant_stall for s in ref.samples])
    assert port.trajectory_notes == ref.trajectory_notes
    # the strategy's decisions match exactly; its predicted deltas are
    # EMA-refined differences of fp32 objectives and are not compared
    for a, b in zip(port.samples, ref.samples):
        if b.directive is None:
            assert a.directive is None
            continue
        assert a.directive["moves"] == b.directive["moves"]
        assert a.directive["rationale"] == b.directive["rationale"]


def test_budget20_scores_match_reference(runs):
    port, ref, dispatches = runs
    assert port.superior_count == ref.superior_count
    assert port.phv == pytest.approx(ref.phv, rel=1e-6)
    assert port.sample_efficiency == ref.sample_efficiency
    assert ([tuple(s.idx) for s in port.pareto]
            == [tuple(s.idx) for s in ref.pareto])
    assert dispatches > 0


def test_kernel_backend_runs_the_same_trajectory(runs):
    port, _, _ = runs
    out = LuminaDSE(get_evaluator("proxy", backend="cuda", device="cpu"),
                    seed=0).run(budget=20)
    assert np.array_equal(np.stack([s.idx for s in out.samples]),
                          np.stack([s.idx for s in port.samples]))
    assert out.phv == port.phv


def test_primary_map_is_the_reference_artifact():
    assert primary_resources() == JRuleOracle().primary_map
    assert RuleOracle().primary_map == primary_resources()
    assert DegradedOracle(0.3, seed=1).name == "degraded(p=0.30)"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_core_matches_reference(seed):
    rng = np.random.default_rng(seed)
    y = rng.random((600, 3))
    y[::7] = y[1::7][: len(y[::7])]              # exact duplicates
    assert np.array_equal(T_P.pareto_mask(y), J_P.pareto_mask(y))
    ref = np.ones(3)
    assert T_P.hypervolume(y, ref) == J_P.hypervolume(y, ref)
    assert T_P.hypervolume(y[:, :2], ref[:2]) == \
        J_P.hypervolume(y[:, :2], ref[:2])
    assert np.array_equal(T_P.dominates_ref(y, ref * 0.5),
                          J_P.dominates_ref(y, ref * 0.5))
    assert T_P.sample_efficiency(y, ref * 0.5) == \
        J_P.sample_efficiency(y, ref * 0.5)
    a, b = T_P.ParetoArchive(3, capacity=40), J_P.ParetoArchive(3, capacity=40)
    for chunk in np.array_split(y, 6):
        a.insert(chunk, ids=np.arange(len(chunk)))
        b.insert(chunk, ids=np.arange(len(chunk)))
    assert np.array_equal(a.y, b.y) and np.array_equal(a.ids, b.ids)
    assert a.truncated == b.truncated
