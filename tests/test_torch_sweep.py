"""The streaming sweep: the port against the reference SweepEngine, and the
kernel backend (its plain version on the CPU) against the torch path."""
import numpy as np
import pytest
import torch

from repro.perfmodel import get_evaluator as j_get_evaluator
from repro.perfmodel.sweep import SweepEngine as JSweepEngine
from repro_torch.core.pareto import pareto_front
from repro_torch.perfmodel import (RooflineModel, SweepEngine, get_evaluator,
                                   gpt3_layer_prefill)
from repro_torch.perfmodel.designspace import SPACE

torch.set_num_threads(1)

STOP = 300_000


@pytest.fixture(scope="module")
def port_and_ref():
    port = SweepEngine(get_evaluator("proxy", device="cpu"),
                       chunk_size=16_384, stall_topk=8).run(0, STOP)
    ref = JSweepEngine(j_get_evaluator("proxy"), chunk_size=16_384,
                       stall_topk=8).run(0, STOP)
    return port, ref


def test_counts_match_reference(port_and_ref):
    port, ref = port_and_ref
    assert port.n_evaluated == ref.n_evaluated == STOP
    assert port.n_superior == ref.n_superior
    np.testing.assert_allclose(port.ref_point, ref.ref_point, rtol=1e-6)


def test_topk_and_stall_seeds_match_reference(port_and_ref):
    port, ref = port_and_ref
    assert np.array_equal(port.topk_ids, ref.topk_ids)
    np.testing.assert_allclose(port.topk_val, ref.topk_val, rtol=1e-6)
    assert np.array_equal(port.stall_topk_ids, ref.stall_topk_ids)
    ps, rs = port.stall_seeds(), ref.stall_seeds()
    assert list(ps) == list(rs)
    for cls in rs:
        assert np.array_equal(ps[cls], rs[cls])


def test_front_matches_reference(port_and_ref):
    port, ref = port_and_ref
    assert not port.archive_truncated
    assert np.array_equal(port.pareto_ids, ref.pareto_ids)
    np.testing.assert_allclose(port.pareto_y, ref.pareto_y, rtol=1e-6)
    assert np.array_equal(port.pareto_idx(), ref.pareto_idx())


def test_kernel_backend_equals_torch_path_and_brute_force():
    """backend="cuda" (the kernel's plain version on the CPU) finds the
    torch path's result bit for bit; both equal a brute-force front."""
    stop = 40_000
    ev_k = get_evaluator("proxy", backend="cuda", device="cpu")
    eng_k = SweepEngine(ev_k, chunk_size=5_000, stall_topk=4,
                        stall_rank="ref")
    assert eng_k.backend == "cuda" and eng_k.chunk_size == 5_120
    eng_r = SweepEngine(get_evaluator("proxy", device="cpu"),
                        chunk_size=5_000, stall_topk=4, stall_rank="ref")
    a, b = eng_k.run(0, stop), eng_r.run(0, stop)
    assert a.n_superior == b.n_superior and a.n_evaluated == stop
    for f in ("pareto_ids", "pareto_y", "topk_ids", "topk_val",
              "stall_topk_ids", "stall_topk_val"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    y = get_evaluator("proxy", device="cpu").objectives(
        SPACE.flat_to_idx(np.arange(stop)))
    brute = pareto_front(y.astype(np.float64))
    assert np.array_equal(np.unique(brute, axis=0),
                          np.unique(a.pareto_y, axis=0))
    assert a.n_superior == int((y < a.ref_point[None, :]).all(axis=1).sum())


def test_engine_identity_and_guards():
    ev = get_evaluator("proxy", device="cpu")
    eng = SweepEngine(ev, chunk_size=1_000)
    ref = JSweepEngine(j_get_evaluator("proxy"), chunk_size=1_000)
    assert eng.fingerprint() == ref.fingerprint()
    np.testing.assert_allclose(eng.ref_point, ref.ref_point, rtol=1e-6)
    with pytest.raises(TypeError):
        SweepEngine(RooflineModel(gpt3_layer_prefill()))
    with pytest.raises(ValueError, match="compass-tier knobs"):
        SweepEngine(get_evaluator("target", device="cpu"), backend="cuda")
    auto = SweepEngine(ev, chunk_size="auto", chunk_candidates=(1_000, 2_000))
    assert auto.chunk_size in (1_000, 2_000)
    with pytest.raises(ValueError, match="auto"):
        SweepEngine(ev, chunk_size="fastest")
    with pytest.raises(ValueError):
        SweepEngine(ev, stall_rank="area")
    with pytest.raises(ValueError, match="stall_topk"):
        eng.run(0, 2_000).stall_seeds()


def _same_result(a, b) -> bool:
    return all(
        (np.array_equal(getattr(a, f), getattr(b, f))
         if isinstance(getattr(a, f), np.ndarray)
         else getattr(a, f) == getattr(b, f))
        for f in ("n_evaluated", "n_superior", "pareto_y", "pareto_ids",
                  "topk_val", "topk_ids", "ref_point", "archive_truncated",
                  "stall_topk_val", "stall_topk_ids", "archive_capacity"))


def test_traced_chunks_are_tiled_by_their_phases(monkeypatch):
    """Under torch.profiler each chunk span holds the four phase spans in
    order, without overlap; the survivors they count are the rows the
    archive received; the result is the untraced run's bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pareto import ParetoArchive
    from repro_torch.obs import PROCESS_TRACER
    ch = 8_192
    eng = SweepEngine(get_evaluator("proxy", device="cpu"), chunk_size=ch,
                      stall_topk=8)
    plain = eng.run(0, 3 * ch)
    received = []
    insert = ParetoArchive.insert

    def counted(self, y, *a, **kw):
        received.append(len(y))
        return insert(self, y, *a, **kw)

    monkeypatch.setattr(ParetoArchive, "insert", counted)
    PROCESS_TRACER.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = eng.run(0, 3 * ch)
    spans = PROCESS_TRACER.drain()
    assert _same_result(traced, plain)
    names = [s.name for s in spans]
    assert names.count("sweep.chunk") == 3
    assert {"sweep.run", "sweep.span", "sweep.reduce"} <= set(names)
    leaves = ["sweep.filter", "sweep.step", "sweep.sync", "sweep.insert"]
    for c in (s for s in spans if s.name == "sweep.chunk"):
        kids = sorted((s for s in spans if s.parent_id == c.span_id),
                      key=lambda s: s.t_start)
        assert [s.name for s in kids] == leaves
        assert c.t_start <= kids[0].t_start and kids[-1].t_end <= c.t_end
        assert all(a.t_end <= b.t_start for a, b in zip(kids, kids[1:]))
    survivors = [s.attrs["survivors"] for s in spans
                 if s.name == "sweep.sync"]
    assert sum(survivors) == sum(received) > 0
    assert names.count("sweep.reduce") == 1
    profiled = {e.name for e in prof.events()}
    assert set(leaves) | {"sweep.chunk", "sweep.reduce"} <= profiled
