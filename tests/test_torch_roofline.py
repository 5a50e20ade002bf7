"""Op terms and stall attribution: the port against the reference, and the
port's own stacked == looped contract (bit-exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.perfmodel import compass as J_C
from repro.perfmodel import roofline as J_R
from repro.perfmodel import workload as J_W
from repro.perfmodel.designspace import SPACE as J_SPACE
from repro.perfmodel.hardware import derive_hardware as j_derive
from repro_torch.perfmodel import compass as T_C
from repro_torch.perfmodel import roofline as T_R
from repro_torch.perfmodel import workload as T_W
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.evaluator import EvalRequest, ModelEvaluator
from repro_torch.perfmodel.hardware import derive_hardware

torch.set_num_threads(1)

IDX = SPACE.sample(np.random.default_rng(21), 1500)
TIERS = {"proxy": (J_R.RooflineModel, T_R.RooflineModel),
         "target": (J_C.CompassModel, T_C.CompassModel)}
TERMS = ("t_op", "t_unit", "t_compute", "t_memory", "t_comm")


def _port_terms(model):
    hw = derive_hardware(SPACE.decode(torch.as_tensor(IDX)))
    return model._op_terms({k: v[:, None] for k, v in hw.items()})


def _ref_terms(model):
    hw = j_derive(J_SPACE.decode(jnp.asarray(IDX)))
    return model._op_terms({k: v[:, None] for k, v in hw.items()})


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_op_terms_and_classes_match_reference(tier, which):
    j_cls, t_cls = TIERS[tier]
    jm = j_cls(getattr(J_W, f"gpt3_layer_{which}")())
    tm = t_cls(getattr(T_W, f"gpt3_layer_{which}")())
    got, want = _port_terms(tm), _ref_terms(jm)
    for k in TERMS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
    assert np.array_equal(T_R._dominant_class(got).numpy(),
                          np.asarray(J_R._dominant_class(want)))
    # per-op times and stall sums of the full stalls path
    hw = derive_hardware(SPACE.decode(torch.as_tensor(IDX)))
    out = tm._workload_batch({k: v[:, None] for k, v in hw.items()})
    jhw = j_derive(J_SPACE.decode(jnp.asarray(IDX)))
    jout = jm._workload_batch({k: v[:, None] for k, v in jhw.items()})
    for k in ("latency", "op_time", "t_compute", "t_memory", "t_comm",
              "stall"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    assert np.array_equal(out["op_class"].numpy(),
                          np.asarray(jout["op_class"]))


def test_utilization_and_collective_terms_match_reference():
    hw = derive_hardware(SPACE.decode(torch.as_tensor(IDX)))
    hwb = {k: v[:, None] for k, v in hw.items()}
    jhw = j_derive(J_SPACE.decode(jnp.asarray(IDX)))
    jhwb = {k: v[:, None] for k, v in jhw.items()}
    m, n, k = (np.array([[1.0, 8.0, 2048.0, 16384.0]], np.float32),
               np.array([[1.0, 128.0, 3072.0, 4608.0]], np.float32),
               np.array([[1.0, 96.0, 128.0, 12288.0]], np.float32))
    tm, tn, tk = (torch.as_tensor(a) for a in (m, n, k))
    np.testing.assert_allclose(
        T_R.matmul_utilization(hwb, tm, tn, tk).numpy(),
        np.asarray(J_R.matmul_utilization(jhwb, m, n, k)), rtol=1e-6)
    np.testing.assert_allclose(
        T_R.matmul_hbm_bytes(hwb, tm * 2, tm, tn, tk).numpy(),
        np.asarray(J_R.matmul_hbm_bytes(jhwb, m * 2, m, n, k)), rtol=1e-6)
    nbytes = np.array([[1e6, 4e8]], np.float32)
    tp = np.array([[8.0, 4.0]], np.float32)
    for fn in ("ring_allreduce_time", "a2a_time"):
        np.testing.assert_allclose(
            getattr(T_R, fn)(hwb, torch.as_tensor(nbytes),
                             torch.as_tensor(tp)).numpy(),
            np.asarray(getattr(J_R, fn)(jhwb, nbytes, tp)), rtol=1e-6)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("detail", ["objectives", "ppa", "stalls"])
def test_stacked_bit_identical_to_looped(tier, detail):
    cls = TIERS[tier][1]
    wls, _ = T_W.paper_suite()
    models = {nm: cls(wl) for nm, wl in wls.items()}
    stacked = ModelEvaluator(models, stacked=True, device="cpu")
    looped = ModelEvaluator(models, stacked=False, device="cpu")
    a = stacked.evaluate(EvalRequest(IDX, detail=detail))
    b = looped.evaluate(EvalRequest(IDX, detail=detail))
    assert np.array_equal(a.area, b.area)
    for nm in a.workloads:
        assert np.array_equal(a.latency[nm], b.latency[nm])
        if detail != "objectives":
            assert np.array_equal(a.op_time[nm], b.op_time[nm])
        if detail == "stalls":
            assert np.array_equal(a.stall[nm], b.stall[nm])
            assert np.array_equal(a.op_class[nm], b.op_class[nm])


def test_bucketed_call_pads_without_changing_rows():
    assert [T_R._batch_bucket(b) for b in (1, 8, 9, 1000)] == [8, 8, 16, 1024]
    wls, _ = T_W.paper_suite()
    ev = ModelEvaluator({nm: T_R.RooflineModel(wl) for nm, wl in wls.items()},
                        device="cpu")
    whole = ev.objectives(IDX[:37])
    assert whole.shape == (37, 3)
    for i in (0, 36):
        assert np.array_equal(ev.objectives(IDX[i]), whole[i:i + 1])


def test_seq_sum_is_left_to_right():
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0]], dtype=torch.float32)
    # ((1e8 + 1) - 1e8) + 1 in fp32: the 1 is lost against 1e8, then kept
    assert T_R._seq_sum(x).item() == 1.0
