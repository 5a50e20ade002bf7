"""Design space, derived hardware, workloads: the port against the reference,
plus the Table-4 calibration checks of tests/test_perfmodel.py on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.perfmodel import designspace as J_DS
from repro.perfmodel import hardware as J_HW
from repro.perfmodel import workload as J_W
from repro_torch.perfmodel import designspace as T_DS
from repro_torch.perfmodel import hardware as T_HW
from repro_torch.perfmodel import workload as T_W
from repro_torch.perfmodel.designspace import (A100_REFERENCE, DESIGN_A,
                                               DESIGN_B, SPACE)

torch.set_num_threads(1)

IDS = np.random.default_rng(11).integers(0, SPACE.size, 2000)


def test_tables_and_constants_match_reference():
    assert T_DS.PARAM_NAMES == J_DS.PARAM_NAMES
    assert T_DS.PARAM_CHOICES == J_DS.PARAM_CHOICES
    for name in ("A100_REFERENCE", "DESIGN_A", "DESIGN_B"):
        assert getattr(T_DS, name) == getattr(J_DS, name)
    assert np.array_equal(SPACE.choice_table(), J_DS.SPACE.choice_table())
    for name in ("CLOCK_HZ", "BW_PER_CHANNEL", "BW_PER_LINK",
                 "LINK_LATENCY_S", "AREA_BASE", "AREA_PER_MAC",
                 "AREA_PER_VLANE", "AREA_PER_SRAM_KB", "AREA_CORE_BASE",
                 "AREA_PER_GBUF_MB", "AREA_PER_CHANNEL", "AREA_PER_LINK",
                 "BYTES_FP16", "AREA_MODEL_SOURCE"):
        assert getattr(T_HW, name) == getattr(J_HW, name)


def test_index_maps_match_reference():
    idx = SPACE.flat_to_idx(IDS)
    assert np.array_equal(idx, J_DS.SPACE.flat_to_idx(IDS))
    assert np.array_equal(SPACE.idx_to_flat(idx), IDS)
    for ref in (A100_REFERENCE, DESIGN_A, DESIGN_B):
        assert np.array_equal(SPACE.encode_nearest(ref),
                              J_DS.SPACE.encode_nearest(ref))
    a = SPACE.sample(np.random.default_rng(5), 64)
    assert np.array_equal(a, J_DS.SPACE.sample(np.random.default_rng(5), 64))
    assert np.array_equal(SPACE.neighbors(idx[0]),
                          J_DS.SPACE.neighbors(idx[0]))
    assert np.array_equal(SPACE.clip(idx + 3), J_DS.SPACE.clip(idx + 3))


def test_decode_is_the_reference_gather_in_fp32():
    idx = SPACE.flat_to_idx(IDS)
    got = SPACE.decode(torch.as_tensor(idx))
    want = J_DS.SPACE.decode(jnp.asarray(idx))
    for name in SPACE.names:
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    vals = SPACE.decode_values(torch.as_tensor(idx)).numpy()
    assert np.array_equal(
        vals, np.stack([np.asarray(want[n]) for n in SPACE.names], axis=1))


def test_unrank_matches_flat_to_idx():
    from repro_torch.perfmodel.sweep import _unrank
    ids = torch.as_tensor(np.concatenate([IDS, [0, SPACE.size - 1]]),
                          dtype=torch.int32)
    got = _unrank(ids, tuple(int(c) for c in SPACE.cardinalities))
    assert np.array_equal(got.numpy(), SPACE.flat_to_idx(ids.numpy()))


def test_derive_hardware_matches_reference():
    idx = SPACE.flat_to_idx(IDS)
    got = T_HW.derive_hardware(SPACE.decode(torch.as_tensor(idx)))
    want = J_HW.derive_hardware(J_DS.SPACE.decode(jnp.asarray(idx)))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def _hw(values):
    v = {k: torch.tensor([float(values[k])]) for k in SPACE.names}
    return {k: float(x[0]) for k, x in T_HW.derive_hardware(v).items()}


def test_design_space_cardinality():
    assert SPACE.size == 4_741_632        # ~4.7M, paper Table 1


def test_a100_calibration():
    hw = _hw(A100_REFERENCE)
    assert hw["tensor_flops"] == pytest.approx(312e12, rel=0.01)
    assert hw["mem_bw"] == pytest.approx(1555e9, rel=0.01)
    assert hw["ici_bw"] == pytest.approx(300e9, rel=0.01)
    assert hw["area_mm2"] == pytest.approx(826, rel=0.01)


def test_table4_area_ratios():
    a100 = _hw(A100_REFERENCE)["area_mm2"]
    assert _hw(DESIGN_A)["area_mm2"] / a100 == pytest.approx(0.772, abs=0.01)
    assert _hw(DESIGN_B)["area_mm2"] / a100 == pytest.approx(0.952, abs=0.02)


def test_table4_perf_ratios():
    from repro_torch.perfmodel import get_evaluator
    ev = get_evaluator("target", device="cpu")
    vals = {tag: ev.objectives(SPACE.encode_nearest(des))[0]
            for tag, des in (("A100", A100_REFERENCE), ("A", DESIGN_A),
                             ("B", DESIGN_B))}
    assert vals["A"][0] / vals["A100"][0] == pytest.approx(0.717, abs=0.02)
    assert vals["B"][0] / vals["A100"][0] == pytest.approx(0.592, abs=0.02)
    assert vals["A"][1] / vals["A100"][1] == pytest.approx(0.947, abs=0.06)


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_workloads_carry_over_from_reference_arrays(which):
    port = getattr(T_W, f"gpt3_layer_{which}")()
    ref = getattr(J_W, f"gpt3_layer_{which}")()
    rebuilt = T_W.workload_from_arrays(ref.name, ref.arrays(), ref.tp)
    for wl in (port, rebuilt):
        a, b = wl.arrays(), ref.arrays()
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k]), k
        assert wl.tp == ref.tp
    assert port.name == ref.name and port.op_names == ref.op_names
    with pytest.raises(ValueError, match="tp"):
        T_W.workload_from_arrays(ref.name, ref.arrays(), 4)


def test_workload_stack_matches_reference():
    twls, tsc = T_W.paper_suite()
    jwls, jsc = J_W.paper_suite()
    assert ([(s.name, s.prefill, s.decode) for s in tsc]
            == [(s.name, s.prefill, s.decode) for s in jsc])
    ts, js = T_W.WorkloadStack.build(twls), J_W.WorkloadStack.build(jwls)
    assert ts.names == js.names
    for f in js.unique:
        assert np.array_equal(ts.unique[f], js.unique[f])
    for nm in js.names:
        assert np.array_equal(ts.op_map[nm], js.op_map[nm])
        assert np.array_equal(ts.counts[nm], js.counts[nm])
    assert np.array_equal(ts.count_matrix, js.count_matrix)
