"""The port's multi-campaign runner against the reference's: the slot
allocator, both scheduling policies over an oracle on the first 60,000
designs (labels, ids, dispatch counts exact; regret and PHV fraction at
rtol 1e-6), and the v5 telemetry file, read back by either package."""
import json

import numpy as np
import pytest
import torch

from repro.core.campaign import CampaignRunner as JCampaignRunner
from repro.core.campaign import allocate_slots as j_allocate_slots
from repro.core.campaign import load_telemetry as j_load_telemetry
from repro.obs.metrics import ManualClock as JManualClock
from repro.obs.trace import Tracer as JTracer
from repro.perfmodel import ModelEvaluator as JModelEvaluator
from repro.perfmodel import OracleEvaluator as JOracleEvaluator
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro_torch.core import CampaignRunner, CampaignSetResult, StepRecord
from repro_torch.core.campaign import (REFERENCE_CAMPAIGN, TELEMETRY_VERSION,
                                       allocate_slots, load_telemetry)
from repro_torch.obs import ManualClock, MetricsRegistry, Tracer
from repro_torch.perfmodel import (ModelEvaluator, OracleEvaluator,
                                   get_evaluator)
from repro_torch.perfmodel.designspace import SPACE

torch.set_num_threads(1)

STOP = 60_000
SWEEP_KW = dict(stall_topk=16, stall_rank="ref")
BUDGET = 60


@pytest.fixture(scope="module")
def sides():
    ev = get_evaluator("proxy", device="cpu")
    j_ev = j_get_evaluator("proxy")
    oracle = OracleEvaluator(ev, stop=STOP, sweep_kwargs=SWEEP_KW)
    j_oracle = JOracleEvaluator(j_ev, stop=STOP, sweep_kwargs=SWEEP_KW)
    return ((ev, oracle, oracle.sweep_result()),
            (j_ev, j_oracle, j_oracle.sweep_result()))


def _port_run(sides, budget=BUDGET, **kw):
    ev, oracle, sweep = sides[0]
    runner = CampaignRunner(ev, proxy=ModelEvaluator(ev.models,
                                                     device="cpu"),
                            oracle=oracle, seed=0, **kw)
    return runner, runner.run(budget=budget, sweep=sweep)


def _ref_run(sides, budget=BUDGET, **kw):
    ev, oracle, sweep = sides[1]
    runner = JCampaignRunner(ev, proxy=JModelEvaluator(ev.models),
                             oracle=oracle, seed=0, **kw)
    return runner, runner.run(budget=budget, sweep=sweep)


# ---------------------------------------------------------------- allocator
ALLOC_CASES = [
    (["a", "b"], {"a": 1.05, "b": 0.05}, 1, 22),
    (["x", "y", "z"], {"x": 1.0, "y": 1.0, "z": 1.0}, 2, 3),
    (["a", "b", "c", "d"], {"a": 0.3, "b": 1.05, "c": 0.05, "d": 0.6}, 3, 9),
    (["p", "q", "r"], {"p": 0.05, "q": 0.05, "r": 2.0}, 5, 4),
]


@pytest.mark.parametrize("order,weights,slots,rounds", ALLOC_CASES)
def test_allocate_slots_matches_reference(order, weights, slots, rounds):
    credit, j_credit = {}, {}
    for _ in range(rounds):
        got = allocate_slots(order, credit, weights, slots)
        assert got == j_allocate_slots(order, j_credit, weights, slots)
        assert credit == j_credit
        order = order[1:] + order[:1]


def test_allocate_slots_weighted_deficit():
    """The reference's own cases: shares follow the weights, ties break
    toward the front of `order`, degenerate inputs."""
    credit = {"a": 0.0, "b": 0.0}
    counts = {"a": 0, "b": 0}
    for _ in range(22):
        for lb in allocate_slots(["a", "b"], credit,
                                 {"a": 1.05, "b": 0.05}, 1):
            counts[lb] += 1
    assert counts == {"a": 21, "b": 1}
    credit, eq = {}, {"x": 1.0, "y": 1.0, "z": 1.0}
    assert allocate_slots(["x", "y", "z"], credit, eq, 2) == ["x", "y"]
    assert allocate_slots(["x", "y", "z"], credit, eq, 2) == ["x", "z"]
    assert allocate_slots(["x", "y", "z"], credit, eq, 2) == ["y", "z"]
    assert allocate_slots([], {}, {}, 3) == []
    assert allocate_slots(["x"], {}, {"x": 1.0}, 0) == []
    with pytest.raises(ValueError, match="positive"):
        allocate_slots(["x"], {}, {"x": 0.0}, 1)


# ---------------------------------------------------------------- policies
@pytest.mark.parametrize("policy,spc", [("uniform", 1), ("adaptive", 1),
                                        ("adaptive", 2), ("uniform", 3)])
def test_policies_match_reference(sides, policy, spc):
    runner, res = _port_run(sides, policy=policy, seeds_per_campaign=spc)
    _, ref = _ref_run(sides, policy=policy, seeds_per_campaign=spc)
    assert isinstance(res, CampaignSetResult)
    assert sorted(res.per_campaign) == sorted(ref.per_campaign)
    assert REFERENCE_CAMPAIGN in res.per_campaign
    assert len(res.telemetry) == len(ref.telemetry) == BUDGET
    assert ([(r.eval_i, r.round_i, r.campaign, r.step)
             for r in res.telemetry]
            == [(r.eval_i, r.round_i, r.campaign, r.step)
                for r in ref.telemetry])
    assert np.array_equal(np.stack([s.idx for s in res.samples]),
                          np.stack([s.idx for s in ref.samples]))
    assert ([s.dominant_stall for s in res.samples]
            == [s.dominant_stall for s in ref.samples])
    assert (res.rounds, res.dispatches, res.superior_count) == \
        (ref.rounds, ref.dispatches, ref.superior_count)
    assert res.budget_weights == ref.budget_weights
    assert res.stall_histogram == ref.stall_histogram
    assert res.rule_audit == ref.rule_audit
    assert res.service_counters is None
    np.testing.assert_allclose(res.regret_curve(), ref.regret_curve(),
                               rtol=1e-6)
    np.testing.assert_allclose(res.phv_frac_curve(), ref.phv_frac_curve(),
                               rtol=1e-6)
    assert res.phv == pytest.approx(ref.phv, rel=1e-6)
    # K campaigns share one fused dispatch per round
    k = len(res.per_campaign)
    assert res.dispatches <= BUDGET / k + 4
    # the merged archive's regret never rises, its PHV fraction never falls
    assert (np.diff(res.regret_curve(), axis=0) <= 0).all()
    assert (np.diff(res.phv_frac_curve()) >= 0).all()


def test_metrics_and_spans_match_reference(sides):
    """The registry's counters and the tracer's span tree (on a manual
    clock) are the reference's for the same run."""
    tr, j_tr = Tracer(clock=ManualClock()), JTracer(clock=JManualClock())
    reg = MetricsRegistry()
    _, res = _port_run(sides, budget=12, registry=reg, tracer=tr)
    _, ref = _ref_run(sides, budget=12, tracer=j_tr)
    assert res.metrics == ref.metrics == reg.snapshot()
    obs = res.metrics["campaign_observations"]["series"]
    assert sum(s["value"] for s in obs) == 12
    assert res.metrics["campaign_rounds"]["series"][0]["value"] == res.rounds
    spans = [s.as_dict() for s in tr.spans()]
    assert spans == [s.as_dict() for s in j_tr.spans()]
    assert [s["name"] for s in spans].count("campaign.round") == res.rounds
    assert spans[-1]["name"] == "campaign.run"
    assert spans[-1]["parent_id"] is None


# ---------------------------------------------------------------- telemetry
def test_telemetry_v5_round_trip_and_reference_reads_it(sides, tmp_path):
    _, res = _port_run(sides, budget=20, policy="adaptive")
    _, ref = _ref_run(sides, budget=20, policy="adaptive")
    tel = res.telemetry_dict()
    assert tel["version"] == TELEMETRY_VERSION == 5
    assert all(isinstance(r, StepRecord) for r in res.telemetry)
    path = tmp_path / "tel.json"
    res.save_telemetry(str(path))
    normalized = json.loads(json.dumps(tel))
    assert load_telemetry(str(path)) == normalized
    assert j_load_telemetry(str(path)) == normalized
    # every key and every value but the floats is the reference's
    want = json.loads(json.dumps(ref.telemetry_dict()))
    recs, want_recs = normalized.pop("records"), want.pop("records")
    assert normalized == want
    for a, b in zip(recs, want_recs):
        assert (a["eval_i"], a["round_i"], a["campaign"], a["step"]) == \
            (b["eval_i"], b["round_i"], b["campaign"], b["step"])
        np.testing.assert_allclose(
            a["objectives"] + [a["phv"], a["phv_frac"]] + a["regret"],
            b["objectives"] + [b["phv"], b["phv_frac"]] + b["regret"],
            rtol=1e-6)


def test_telemetry_upgrades_older_files_and_refuses_newer(sides, tmp_path):
    _, res = _port_run(sides, budget=3)
    tel = res.telemetry_dict()
    v3 = {k: v for k, v in tel.items()
          if k not in ("metrics", "stall_histogram", "rule_audit")}
    v3["version"] = 3
    p3 = tmp_path / "v3.json"
    p3.write_text(json.dumps(v3))
    up = load_telemetry(str(p3))
    assert up == j_load_telemetry(str(p3))
    assert up["version"] == TELEMETRY_VERSION
    assert up["metrics"] is up["stall_histogram"] is up["rule_audit"] is None
    p9 = tmp_path / "v9.json"
    p9.write_text(json.dumps(dict(tel, version=TELEMETRY_VERSION + 1)))
    with pytest.raises(ValueError, match="newer"):
        load_telemetry(str(p9))


# ---------------------------------------------------------------- options
def test_runner_options_are_validated(sides):
    ev = sides[0][0]
    with pytest.raises(ValueError, match="policy"):
        CampaignRunner(ev, policy="greedy")
    with pytest.raises(KeyError, match="scenario"):
        CampaignRunner(ev, scenario="no-such-arch")
    runner = CampaignRunner(ev, seed=0)
    with pytest.raises(ValueError, match="no campaigns"):
        runner.run(budget=4, include_reference=False)
    # empty seed classes are skipped; explicit seeds and a step callback
    seen = []
    res = runner.run(budget=6, seeds={"memory_bw": np.zeros((0, 8)),
                                      "mine": SPACE.sample(
                                          np.random.default_rng(5), 2)},
                     step_callback=lambda rec, s: seen.append(rec.eval_i))
    assert sorted(res.per_campaign) == ["a100", "mine"]
    assert len(seen) == 6 and res.phv_frac_curve().shape == (6,)
    assert np.isnan(res.regret_curve()).all()          # no oracle given


def test_scenario_runs_one_zoo_pair():
    zoo = get_evaluator("proxy", suite="zoo", device="cpu")
    sc = zoo.scenarios[0]
    runner = CampaignRunner(zoo, scenario=sc.name, seed=0)
    assert runner.ee.workload_pair == (sc.prefill, sc.decode)
    with pytest.raises(ValueError, match="not both"):
        CampaignRunner(zoo, scenario=sc.name,
                       workloads=(sc.prefill, sc.decode))
    res = runner.run(budget=4)
    assert len(res.samples) == 4 and res.dispatches <= 4
