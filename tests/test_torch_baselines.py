"""The five black-box baselines on the port against the reference's: the
same ask/tell trajectories on one shared objective (bit for bit) and on
each side's own proxy evaluator, the kernel backend's trajectories equal to
the torch-op backend's, and the headline comparison at a small budget."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.core.baselines import METHODS as J_METHODS
from repro.core.baselines import run_method as j_run_method
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro_torch.core.baselines import METHODS, BaseOptimizer, run_method
from repro_torch.core.loop import LuminaDSE
from repro_torch.perfmodel import get_evaluator
from repro_torch.perfmodel.designspace import A100_REFERENCE, SPACE

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """BO's small Cholesky solves run in one BLAS thread: several test
    workers' BLAS thread pools on a few cores slow them 100-fold."""
    with threadpool_limits(limits=1):
        yield


NAMES = sorted(METHODS)
RESULT_ARRAYS = ("X", "Y", "phv_curve")


def _shared_objective(X: np.ndarray) -> np.ndarray:
    """A deterministic fp32 objective of the design indices, with the
    trade-offs of the real one (more hardware: faster and larger)."""
    x = np.asarray(X, dtype=np.float64) / (SPACE.cardinalities - 1)
    w = np.linspace(0.5, 1.5, SPACE.n_params)
    speed = 1.0 + (x * w).sum(axis=1)
    ttft = 1.0 / speed + 0.05 * np.sin(7.0 * x[:, 0] + 3.0 * x[:, 3]) ** 2
    tpot = 1.0 / (1.0 + 2.0 * x[:, 4] + x[:, 5]) + 0.1 * x[:, 2]
    area = 1.0 + (x ** 2 * w).sum(axis=1)
    return np.stack([ttft, tpot, area], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def shared_ref():
    y = _shared_objective(SPACE.sample(np.random.default_rng(3), 4096))
    return np.quantile(y.astype(np.float64), 0.6, axis=0)


@pytest.fixture(scope="module")
def evaluators():
    port = get_evaluator("proxy", device="cpu")
    ref = j_get_evaluator("proxy")
    a100 = SPACE.encode_nearest(A100_REFERENCE)[None, :]
    return port, ref, port.objectives(a100)[0], ref.objectives(a100)[0]


def _same(a, b):
    for f in RESULT_ARRAYS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.superior_count == b.superior_count
    assert a.sample_efficiency == b.sample_efficiency
    assert a.phv == b.phv


def test_methods_are_the_references():
    assert sorted(J_METHODS) == NAMES
    for name in NAMES:
        assert METHODS[name].__name__ == J_METHODS[name].__name__
        assert issubclass(METHODS[name], BaseOptimizer)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_shared_objective_trajectory_is_bit_identical(name, batch,
                                                      shared_ref):
    kw = dict(budget=64, ref_point=shared_ref, seed=batch, batch=batch,
              curve_stride=10)
    port = run_method(METHODS[name], _shared_objective, **kw)
    ref = j_run_method(J_METHODS[name], _shared_objective, **kw)
    _same(port, ref)
    assert port.superior_count > 0
    assert port.X.dtype == np.int32 and port.Y.dtype == np.float64


@pytest.mark.parametrize("name", NAMES)
def test_proxy_evaluator_trajectory_matches_reference(name, evaluators):
    ev, j_ev, ref_pt, j_ref_pt = evaluators
    np.testing.assert_allclose(ref_pt, j_ref_pt, rtol=1e-6)
    port = run_method(METHODS[name], ev, 48, ref_pt, seed=0, batch=8)
    ref = j_run_method(J_METHODS[name], j_ev, 48, j_ref_pt, seed=0, batch=8)
    assert np.array_equal(port.X, ref.X)
    assert port.superior_count == ref.superior_count
    np.testing.assert_allclose(port.Y, ref.Y, rtol=1e-6)
    np.testing.assert_allclose(port.phv_curve, ref.phv_curve, rtol=1e-6)
    assert port.phv == pytest.approx(ref.phv, rel=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_backend_runs_the_same_trajectory(name, evaluators):
    """On the CPU the cuda backend's wrapper runs ppa_eval's plain version:
    one dispatch per ask batch, and a trajectory bit for bit the torch-op
    backend's (the card holds the kernel itself to the same)."""
    ev, _, ref_pt, _ = evaluators
    ev_k = get_evaluator("proxy", backend="cuda", device="cpu")
    d0 = ev_k.dispatches
    port_k = run_method(METHODS[name], ev_k, 44, ref_pt, seed=1, batch=8)
    assert ev_k.dispatches - d0 == 6               # ceil(44 / 8)
    _same(port_k, run_method(METHODS[name], ev, 44, ref_pt, seed=1,
                             batch=8))


def test_ask_respects_cardinalities():
    for name, cls in METHODS.items():
        opt = cls(space=SPACE, seed=1)
        X = np.atleast_2d(opt.ask(8))
        assert (X >= 0).all() and (X < SPACE.cardinalities[None, :]).all(), \
            name


def test_lumina_beats_baselines_at_small_budget(evaluators):
    """Sample-efficiency headline (paper Fig. 4, scaled down): at a
    60-sample budget Lumina's sample efficiency exceeds every black-box
    baseline's."""
    ev, _, ref_pt, _ = evaluators
    effs = {}
    for name, cls in METHODS.items():
        r = run_method(cls, ev, budget=60, ref_point=ref_pt, seed=0,
                       batch=4)
        effs[name] = r.sample_efficiency
    res = LuminaDSE(ev, seed=0).run(budget=60)
    best = max(effs.values())
    assert res.sample_efficiency > best, (res.sample_efficiency, effs)
    assert res.sample_efficiency >= 3 * max(best, 1e-9)
