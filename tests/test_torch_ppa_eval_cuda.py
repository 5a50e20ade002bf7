"""The CUDA ppa_eval kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ppa_eval import (KernelTables, kernel_tables,
                                          op_table_tensor, ppa_eval,
                                          ppa_eval_plain, ppa_eval_workloads)
from repro_torch.kernels.ppa_eval import ops
from repro_torch.kernels.ppa_eval.bench import design_batches
from repro_torch.perfmodel import get_evaluator
from repro_torch.perfmodel import workload as T_W
from repro_torch.perfmodel.designspace import SPACE

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("which", ["prefill", "decode"])
@pytest.mark.parametrize("b", [1, 255, 256, 65_553, 131_072])
def test_kernel_matches_plain(cuda, which, b):
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    idx = torch.as_tensor(SPACE.sample(np.random.default_rng(7), b),
                          device=cuda)
    dv = SPACE.decode_values(idx)
    tab = op_table_tensor(wl, cuda)
    before = ppa_eval.launches
    got = ppa_eval(dv, tab, float(wl.tp))
    torch.cuda.synchronize()
    assert ppa_eval.launches == before + 1
    want = ppa_eval_plain(dv, tab, float(wl.tp))
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5)
    assert np.array_equal(got, want)      # same arithmetic, same order


def test_auto_backend_times_the_candidates_on_the_card(cuda):
    ev = get_evaluator("proxy", backend="auto", device=cuda)
    assert ev.backend in ("roofline", "cuda")
    idx = SPACE.sample(np.random.default_rng(3), 500)
    ref = get_evaluator("proxy", backend="roofline", device=cuda)
    assert np.array_equal(ev.objectives(idx), ref.objectives(idx))


def test_kernel_rejects_misaligned_rows(cuda):
    tab = op_table_tensor(T_W.gpt3_layer_prefill(), cuda)
    buf = torch.ones(8 * 5 + 1, dtype=torch.float32, device=cuda)
    dv = buf[1:].view(5, 8)               # contiguous but 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        ppa_eval(dv, tab, 8.0)


def test_launch_leaves_the_current_device_alone(cuda):
    """A launch on the last card's tensors selects that card only for the
    launch."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    before = torch.cuda.current_device()
    tab = op_table_tensor(T_W.gpt3_layer_decode(), last)
    dv = SPACE.decode_values(torch.as_tensor(
        SPACE.sample(np.random.default_rng(4), 300), device=last))
    out = ppa_eval(dv, tab, 8.0)
    assert out.device == last
    assert torch.cuda.current_device() == before
    torch.cuda.synchronize(last)
    assert torch.equal(out, ppa_eval_plain(dv, tab, 8.0))


def _pair(device):
    return kernel_tables([T_W.gpt3_layer_prefill(), T_W.gpt3_layer_decode()],
                         device)


@pytest.mark.parametrize("b", [1, 255, 256, 65_553, 131_072])
def test_one_launch_for_both_workloads_matches_single_and_plain(cuda, b):
    """The multi-workload launch's rows equal the single-table launches'
    and the plain version's, bit for bit."""
    tables = _pair(cuda)
    dv = SPACE.decode_values(torch.as_tensor(
        SPACE.sample(np.random.default_rng(b), b), device=cuda))
    before = ppa_eval.launches
    lat, area, stall = ppa_eval_workloads(dv, tables)
    torch.cuda.synchronize()
    assert ppa_eval.launches == before + 1
    for w, (tab, tp) in enumerate(tables.unpack()):
        single = ppa_eval(dv, tab, tp)
        plain = ppa_eval_plain(dv, tab, tp)
        for want in (single, plain):
            assert torch.equal(lat[w], want[:, 0])
            assert torch.equal(stall[w], want[:, 1:5])
            assert torch.equal(area, want[:, 5])
    assert ppa_eval.launches == before + 3


@pytest.mark.parametrize("b", [256, 1_000])
def test_blocks_with_more_distinct_sa_than_the_table(cuda, b):
    """Off-grid rows: sa_dim from MAX_SA + 1 values and from a continuum
    (every design its own), so designs without a slot take the in-line
    branch; also the A100's off-grid gbuf_mb 40."""
    tables = _pair(cuda)
    batches = design_batches(b, cuda, seed=b)
    assert len(batches) == 3
    for name, dv in batches.items():
        got = torch.stack(ppa_eval_workloads(dv, tables)[0])
        want = torch.stack([ppa_eval_plain(dv, t, tp)[:, 0]
                            for t, tp in tables.unpack()])
        assert torch.equal(got, want), name


def test_the_largest_launch(cuda):
    """ops.MAX_OPS op rows over ops.MAX_WORKLOADS workloads (above the
    default 48 KB of shared memory a block, so the launch opts in), with
    tps that differ, against the plain version."""
    base = op_table_tensor(T_W.gpt3_layer_prefill(), cuda)
    n_wl = ops.MAX_WORKLOADS
    rows = [ops.MAX_OPS // n_wl] * n_wl
    rows[-1] += ops.MAX_OPS - sum(rows)
    pairs = [(base.repeat(-(-r // base.shape[0]), 1)[:r].contiguous(),
              float(2 + w % 7)) for w, r in enumerate(rows)]
    tables = KernelTables.pack(pairs)
    assert tables.ends[-1] == ops.MAX_OPS
    assert ops.MAX_OPS * ops.SMEM_PER_OP > 48 * 1024
    dv = design_batches(300, cuda, seed=5)["sampled"]
    lat, area, stall = ppa_eval_workloads(dv, tables)
    for w in (0, 1, n_wl - 1):
        want = ppa_eval_plain(dv, *pairs[w])
        assert torch.equal(lat[w], want[:, 0]) and torch.equal(
            stall[w], want[:, 1:5])
    assert torch.equal(area, want[:, 5])


def test_launches_rise_by_one_per_workloads_call(cuda):
    tables = _pair(cuda)
    dv = design_batches(4_096, cuda)["sampled"]
    before = ppa_eval.launches
    for i in range(3):
        ppa_eval_workloads(dv, tables)
        assert ppa_eval.launches == before + i + 1
    ppa_eval_workloads(dv, KernelTables.pack(tables.unpack()[:1]))
    assert ppa_eval.launches == before + 4


def _zoo(device):
    wls, _ = T_W.zoo_suite()
    return kernel_tables(list(wls.values()), device)


@pytest.mark.parametrize("b", [1, 255, 256, 4_096, 131_072])
def test_zoo_tables_in_one_launch_match_single_and_plain(cuda, b):
    """The zoo's 20 full-width tables (351 rows) in one launch, on sampled
    ids and off-grid rows: bit for bit the single-table launches' and the
    plain version's rows."""
    tables = _zoo(cuda)
    assert len(tables) == 20 and tables.ends[-1] == 351
    for name, dv in design_batches(b, cuda, seed=b).items():
        before = ppa_eval.launches
        lat, area, stall = ppa_eval_workloads(dv, tables)
        torch.cuda.synchronize()
        assert ppa_eval.launches == before + 1
        for w, (tab, tp) in enumerate(tables.unpack()):
            for want in (ppa_eval(dv, tab, tp), ppa_eval_plain(dv, tab, tp)):
                assert torch.equal(lat[w], want[:, 0]), (name, w)
                assert torch.equal(stall[w], want[:, 1:5]), (name, w)
                assert torch.equal(area, want[:, 5]), (name, w)


def test_zoo_tables_repeated_past_48kb(cuda):
    """The zoo's rows repeated up to ops.MAX_OPS and split into 20
    workloads at tps that differ (the opt-in shared-memory path above 48 KB
    a block) against the plain version."""
    zoo = _zoo(cuda).ops
    rows = zoo.repeat(-(-ops.MAX_OPS // zoo.shape[0]), 1)[:ops.MAX_OPS]
    cuts = np.linspace(0, ops.MAX_OPS, 21).astype(int)
    pairs = [(rows[a:b].contiguous(), float(2 + w % 7))
             for w, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]
    tables = KernelTables.pack(pairs)
    assert tables.ends[-1] == ops.MAX_OPS
    assert ops.MAX_OPS * ops.SMEM_PER_OP > 48 * 1024
    for name, dv in design_batches(1_000, cuda, seed=11).items():
        lat, area, stall = ppa_eval_workloads(dv, tables)
        for w in range(len(pairs)):
            want = ppa_eval_plain(dv, *pairs[w])
            assert torch.equal(lat[w], want[:, 0]), (name, w)
            assert torch.equal(stall[w], want[:, 1:5]), (name, w)
        assert torch.equal(area, want[:, 5])


def test_zoo_evaluator_makes_one_launch_per_evaluate(cuda):
    ev = get_evaluator("proxy", backend="cuda", suite="zoo", device=cuda)
    ref = get_evaluator("proxy", backend="roofline", suite="zoo", device=cuda)
    idx = SPACE.sample(np.random.default_rng(6), 4_096)
    before, d0 = ppa_eval.launches, ev.dispatches
    y = ev.objectives(idx)
    assert ppa_eval.launches == before + 1 and ev.dispatches == d0 + 1
    assert np.array_equal(y, ref.objectives(idx))


def test_threaded_sweep_spans_count_every_launch(cuda):
    """run(workers=4) on the kernel: one launch a chunk whichever thread
    makes it, and the result of one process."""
    from repro_torch.perfmodel import SweepEngine
    eng = SweepEngine(get_evaluator("proxy", backend="cuda", device=cuda),
                      chunk_size=4_096, stall_topk=4)
    one = eng.run(0, 16 * 4_096)
    before = ppa_eval.launches
    four = eng.run(0, 16 * 4_096, workers=4)
    assert ppa_eval.launches == before + 16
    for f in ("n_superior", "pareto_ids", "pareto_y", "topk_ids",
              "stall_topk_ids"):
        assert np.array_equal(getattr(one, f), getattr(four, f)), f
