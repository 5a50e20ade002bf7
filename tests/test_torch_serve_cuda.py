"""The DSE service on the card: socket workers whose evaluator is rebuilt
from the client's spec on ``backend="cuda"``, bit for bit against the
in-process ``cuda`` evaluator at a sweep chunk's B 131,072, with
``ppa_eval`` launched once per objectives shard.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda
tests/test_torch_serve_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import ShardedEvaluator
from repro_torch.kernels.ppa_eval import ppa_eval
from repro_torch.perfmodel import EvalRequest, ModelEvaluator, get_evaluator
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.serve import Keyring, WorkerOptions, WorkerServer
from repro_torch.serve import worker as worker_mod

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

B = 131_072
KEYS = {"k1": b"card-secret"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.fixture
def servers(cuda):
    pair = [WorkerServer(options=WorkerOptions(keys=KEYS)) for _ in range(2)]
    for s in pair:
        s.start()
    yield pair
    for s in pair:
        s.close()


def _fresh(dev) -> ModelEvaluator:
    return ModelEvaluator(get_evaluator("proxy", "cuda", device=dev).models,
                          backend="cuda", device=dev)


def _same(a, b) -> bool:
    ok = (a.workloads == b.workloads and a.detail == b.detail
          and np.array_equal(a.area, b.area))
    for w in a.workloads:
        ok = ok and np.array_equal(a.latency[w], b.latency[w])
        for f in ("op_time", "stall", "op_class"):
            fa, fb = getattr(a, f), getattr(b, f)
            ok = ok and ((fa is None and fb is None)
                         or np.array_equal(fa[w], fb[w]))
    return ok


@pytest.mark.parametrize("detail", ["objectives", "ppa", "stalls"])
def test_socket_workers_on_the_card_equal_in_process(cuda, servers, detail):
    idx = SPACE.sample(np.random.default_rng(5), B)
    want = _fresh(cuda).evaluate(EvalRequest(idx, detail))
    ev = ShardedEvaluator(_fresh(cuda), mode="socket",
                          addresses=[(s.host, s.port) for s in servers],
                          keyring=Keyring(KEYS), speculate=False)
    try:
        ppa_eval.launches = 0
        w0 = ev.worker_dispatches
        rep = ev.evaluate(EvalRequest(idx, detail))
        shards = ev.worker_dispatches - w0
        assert shards == 2 and _same(rep, want)
        assert ppa_eval.launches == (shards if detail == "objectives" else 0)
        built = [e for e in worker_mod._EVALUATORS.values()
                 if e.tier == "proxy" and e.backend == "cuda"]
        assert built and all(e.device.type == "cuda" for e in built)
    finally:
        ev.close()
