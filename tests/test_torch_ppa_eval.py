"""ppa_eval's plain PyTorch version against the reference kernel (interpret
mode) and its oracle, at the reference's own kernel tolerances."""
import re

import numpy as np
import pytest
import torch

from repro.kernels.ppa_eval.ops import ppa_eval as j_ppa_eval
from repro.kernels.ppa_eval.ref import op_table as j_op_table
from repro.kernels.ppa_eval.ref import ppa_eval_ref
from repro.perfmodel import workload as J_W
from repro_torch.kernels.ppa_eval import (kernel_tables, op_table,
                                          op_table_tensor, ppa_eval,
                                          ppa_eval_op_count, ppa_eval_plain,
                                          ppa_eval_workloads, workload_tp)
from repro_torch.kernels.ppa_eval.ops import SOURCE
from repro_torch.perfmodel import workload as T_W
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.evaluator import evaluator_for_model
from repro_torch.perfmodel.roofline import RooflineModel

torch.set_num_threads(1)

WHICH = ["prefill", "decode"]


def _plain(idx, wl):
    dv = SPACE.decode_values(torch.as_tensor(idx))
    return ppa_eval_plain(dv, op_table_tensor(wl, "cpu"),
                          workload_tp(wl)).numpy()


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("n", [64, 300])
def test_plain_matches_reference_kernel_and_oracle(which, n):
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    jwl = getattr(J_W, f"gpt3_layer_{which}")()
    idx = SPACE.sample(np.random.default_rng(7), n)
    out = _plain(idx, wl)
    assert out.shape == (n, 8) and out.dtype == np.float32
    assert np.array_equal(out[:, 6:], np.zeros((n, 2), np.float32))
    kern = j_ppa_eval(idx, jwl, interpret=True)
    ref = ppa_eval_ref(idx, jwl)
    for lat, stall, area in ((kern["latency"], kern["stall"], kern["area"]),
                             (ref[:, 0], ref[:, 1:5], ref[:, 5])):
        np.testing.assert_allclose(out[:, 0], lat, rtol=1e-4)
        np.testing.assert_allclose(out[:, 5], area, rtol=1e-5)
        np.testing.assert_allclose(out[:, 1:5], stall, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("which", WHICH)
def test_op_table_matches_reference(which):
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    jwl = getattr(J_W, f"gpt3_layer_{which}")()
    assert np.array_equal(op_table(wl), j_op_table(jwl))
    assert workload_tp(wl) == float(jwl.tp)
    tab = op_table_tensor(wl, "cpu")
    assert tab.dtype == torch.float32 and tab.is_contiguous()


@pytest.mark.parametrize("which", WHICH)
def test_plain_equals_the_torch_roofline_path_bitwise(which):
    """The kernel's arithmetic contract, checked on its plain twin: the same
    expressions in the same order as the roofline stalls path."""
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    idx = SPACE.sample(np.random.default_rng(8), 700)
    out = _plain(idx, wl)
    rep = evaluator_for_model(RooflineModel(wl), device="cpu").stalls(idx)
    w = rep.workloads[0]
    assert np.array_equal(out[:, 0], rep.latency[w])
    assert np.array_equal(out[:, 1:5], rep.stall[w])
    assert np.array_equal(out[:, 5], rep.area)


def test_cpu_tensor_runs_the_plain_version_uncounted():
    wl = T_W.gpt3_layer_prefill()
    idx = SPACE.sample(np.random.default_rng(9), 33)
    dv = SPACE.decode_values(torch.as_tensor(idx))
    tab = op_table_tensor(wl, "cpu")
    before = ppa_eval.launches
    assert torch.equal(ppa_eval(dv, tab, 8.0), ppa_eval_plain(dv, tab, 8.0))
    assert ppa_eval.launches == before


def _fp32_ops(code: str) -> int:
    """fp32 operations written in a piece of CUDA source: each arithmetic
    operator, comparison, fminf/fmaxf/sqrtf and `+=` is one; ceil_div is a
    division and a ceil."""
    code = re.sub(r"//[^\n]*", "", code)
    toks = re.findall(r"ceil_div|fminf|fmaxf|sqrtf|\+=|>=|[-+*/>]", code)
    return sum(2 if t == "ceil_div" else 1 for t in toks)


def test_op_count_follows_the_op_kinds():
    """ppa_eval_op_count (behind chip_smoke's bound) equals the operations
    counted in ppa_eval.cu's source, for each GPT-3 table."""
    src = SOURCE.read_text()

    def between(a, b):
        i = src.index(a)
        return src[i:src.index(b, i)]

    per_design = (_fp32_ops(between("// derive_hardware", "float lat ="))
                  + _fp32_ops(between("// area_mm2", "out[2 * b]")))
    # the common tail, plus the one stall sum that takes t_op
    per_op = _fp32_ops(between("// memcpy:", "if (dom_comm)")) + 1
    branches = dict(re.findall(r"kind == (\w+)\) \{([^}]*)\}", src))
    by_kind = {getattr(T_W, k): _fp32_ops(v) for k, v in branches.items()}
    assert set(by_kind) == {T_W.MATMUL, T_W.VECTOR, T_W.ALLREDUCE, T_W.P2P}
    counts = {}
    for which in WHICH:
        tab = op_table(getattr(T_W, f"gpt3_layer_{which}")())
        want = per_design + sum(per_op + by_kind.get(int(k), 0)
                                for k in tab[:, 0])
        counts[which] = ppa_eval_op_count(tab)
        assert counts[which] == want, which
    assert counts["decode"] < counts["prefill"]


def test_ppa_eval_workloads_slices_each_workloads_row():
    wls = [T_W.gpt3_layer_prefill(), T_W.gpt3_layer_decode()]
    idx = SPACE.sample(np.random.default_rng(10), 97)
    dv = SPACE.decode_values(torch.as_tensor(idx))
    tables = kernel_tables(wls, "cpu")
    lat, area, stall = ppa_eval_workloads(dv, tables)
    for j, wl in enumerate(wls):
        out = ppa_eval_plain(dv, op_table_tensor(wl, "cpu"), workload_tp(wl))
        assert torch.equal(lat[j], out[:, 0])
        assert torch.equal(stall[j], out[:, 1:5])
        assert torch.equal(area, out[:, 5])
