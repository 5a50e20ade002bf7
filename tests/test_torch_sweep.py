"""The streaming sweep: the port against the reference SweepEngine, and the
kernel backend (its plain version on the CPU) against the torch path."""
import numpy as np
import pytest
import torch

from repro.perfmodel import get_evaluator as j_get_evaluator
from repro.perfmodel.sweep import SweepEngine as JSweepEngine
from repro_torch.core.pareto import pareto_front
from repro_torch.kernels.pareto_reduce.bench import absorb_by_insert
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
    filter let through, which the archive counts as seen, and the rows
    they count as entered are the rows the archive received; the result
    is the untraced run's bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pareto import ParetoArchive
    from repro_torch.obs import PROCESS_TRACER
    ch = 8_192
    eng = SweepEngine(get_evaluator("proxy", device="cpu"), chunk_size=ch,
                      stall_topk=8)
    plain = eng.run(0, 3 * ch)
    passed, received, seen = [], [], []
    step, apply = SweepEngine._step, ParetoArchive.apply

    def stepped(self, *a, **kw):
        out = step(self, *a, **kw)
        passed.append(int(out[1].sum()))
        return out

    def counted(self, y, ids, dead, n):
        received.append(len(y))
        seen.append(n)
        return apply(self, y, ids, dead, n)

    monkeypatch.setattr(SweepEngine, "_step", stepped)
    monkeypatch.setattr(ParetoArchive, "apply", counted)
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
    syncs = sorted((s for s in spans if s.name == "sweep.sync"),
                   key=lambda s: s.t_start)
    assert [s.attrs["survivors"] for s in syncs] == passed == seen
    assert sum(passed) > 0
    assert [s.attrs["entered"] for s in syncs] == received
    assert 0 < sum(received) < sum(passed)
    assert names.count("sweep.reduce") == 1
    profiled = {e.name for e in prof.events()}
    assert set(leaves) | {"sweep.chunk", "sweep.reduce"} <= profiled


@pytest.mark.parametrize("case", ["capacity", "workers", "resume"])
def test_device_reduction_equals_the_host_insert(monkeypatch, tmp_path,
                                                 case):
    """The chunk's survivors screened by pareto_reduce and applied give
    the archive that inserting every survivor gives, bit for bit: the
    result, each archive's n_seen, truncation and capacity; with crowding
    pruning engaged, over two workers, and across a resume."""
    ch, stop = 8_192, 5 * 8_192 - 1_000
    kw = {"chunk_size": ch, "stall_topk": 4}
    if case == "capacity":
        kw["archive_capacity"] = 24
    seen = {}
    reduce_states = SweepEngine._reduce_states

    def reduced(self, states, seconds):
        seen[tag] = [(a.n_seen, a.truncated, a.capacity)
                     for st in states for a in st["archives"]]
        return reduce_states(self, states, seconds)

    monkeypatch.setattr(SweepEngine, "_reduce_states", reduced)
    ev = get_evaluator("proxy", device="cpu")
    workers = 2 if case == "workers" else 1
    tag = "device"
    eng = SweepEngine(ev, **kw)
    if case == "resume":
        ck = str(tmp_path / "ck")
        eng.run(0, 2 * ch, checkpoint_path=ck)
        got = eng.run(0, stop, resume_from=ck)
    else:
        got = eng.run(0, stop, workers=workers)
    tag = "host"
    monkeypatch.setattr(SweepEngine, "_absorb", absorb_by_insert)
    want = SweepEngine(ev, **kw).run(0, stop, workers=workers)
    assert _same_result(got, want)
    assert seen["device"] == seen["host"]
    assert sum(n for n, _, _ in seen["device"]) > len(got.pareto_ids)
    assert got.archive_truncated == (case == "capacity")
