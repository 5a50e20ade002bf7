"""The fault-tolerant evaluation path on the card: sharded, chaotic and
coalesced evaluation through the CUDA ``ppa_eval`` kernel, bit for bit
against the unsharded ``cuda`` evaluator, with the kernel launched once a
shard.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda
tests/test_torch_distributed_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import (EvalService, FaultEvent, FaultPlan,
                                     ShardedEvaluator)
from repro_torch.kernels.ppa_eval import ppa_eval
from repro_torch.perfmodel import EvalRequest, ModelEvaluator, get_evaluator
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.sweep import SweepEngine

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _fresh(dev) -> ModelEvaluator:
    return ModelEvaluator(get_evaluator("proxy", "cuda", device=dev).models,
                          backend="cuda", device=dev)


def _same(a, b) -> bool:
    return (a.detail == b.detail and np.array_equal(a.area, b.area)
            and all(np.array_equal(a.latency[w], b.latency[w])
                    for w in a.workloads))


@pytest.mark.parametrize("mode", ["inline", "thread", "device"])
@pytest.mark.parametrize("workers", [2, 4])
def test_sharded_objectives_launch_once_a_shard(cuda, mode, workers):
    idx = SPACE.sample(np.random.default_rng(1), 20_000)
    want = _fresh(cuda).evaluate(EvalRequest(idx, "objectives"))
    ev = ShardedEvaluator(_fresh(cuda), workers=workers, mode=mode,
                          speculate=False)
    try:
        before, w0 = ppa_eval.launches, ev.worker_dispatches
        rep = ev.evaluate(EvalRequest(idx, "objectives"))
        assert ppa_eval.launches - before == ev.worker_dispatches - w0
        assert _same(rep, want)
    finally:
        ev.close()


def test_chaos_on_the_card_is_bit_identical(cuda):
    idx = SPACE.sample(np.random.default_rng(2), 8_192)
    want = _fresh(cuda).evaluate(EvalRequest(idx, "objectives"))
    plan = FaultPlan([FaultEvent(0, 0, "crash"), FaultEvent(1, 1, "corrupt"),
                      FaultEvent(2, 2, "hang")])
    ev = ShardedEvaluator(_fresh(cuda), workers=3, fault_plan=plan,
                          shard_timeout_s=2.0, speculate=False)
    try:
        before = ppa_eval.launches
        assert _same(ev.evaluate(EvalRequest(idx, "objectives")), want)
        # 3 shards + 3 retries, less the crash and the hang that never ran
        assert ppa_eval.launches - before == 4
        assert (ev.retried, ev.corrupt_rejected, ev.timeouts) == (3, 1, 1)
    finally:
        ev.close()


def test_service_proxy_rung_launches_the_kernel(cuda):
    plan = FaultPlan([FaultEvent(0, 0, "crash"), FaultEvent(0, 2, "crash")])
    ev = ShardedEvaluator(_fresh(cuda), workers=2, retries=0,
                          fault_plan=plan, speculate=False)
    svc = EvalService(ev)
    rows = SPACE.sample(np.random.default_rng(3), 512)
    before = ppa_eval.launches
    fut = svc.submit(EvalRequest(rows, "stalls"))
    svc.tick()
    rep = fut.result()
    assert rep.detail == "objectives" and svc.degraded["proxy"] == 1
    assert ppa_eval.launches - before == 1
    assert _same(rep, _fresh(cuda).evaluate(EvalRequest(rows, "objectives")))
    ev.close()


def test_chaos_sweep_on_the_card_equals_the_clean_one(cuda, tmp_path):
    eng = SweepEngine(get_evaluator("proxy", "cuda", device=cuda),
                      stall_topk=4, backend="cuda")
    stop = 6 * eng.chunk_size
    clean = eng.run(0, stop)
    before = ppa_eval.launches
    res = eng.run(0, stop, workers=2, checkpoint_path=str(tmp_path / "ck"),
                  checkpoint_every=2,
                  fault_plan=FaultPlan([FaultEvent(0, 2, "crash"),
                                        FaultEvent(1, 1, "slow")]))
    assert ppa_eval.launches - before == 6        # resumed at chunk 2
    for f in ("pareto_ids", "pareto_y", "topk_ids", "topk_val",
              "stall_topk_ids", "stall_topk_val"):
        assert np.array_equal(getattr(res, f), getattr(clean, f)), f
    assert res.n_superior == clean.n_superior
