"""The readers of the program's own spans: each on a synthetic span list
(its value, and nothing where its spans are missing), on a program
without a process tracer, and on the small cells' windows run on the CPU
under the profiler."""
import time
import types

import pytest
import torch

from perfbench import bench, spans
from perfbench.tests._small import small
from repro_torch.obs import PROCESS_TRACER, Span

SWEEP = ("sweep.enqueue_ms", "sweep.wait_ms", "sweep.archive_ms",
         "sweep.survivors")
MOE = ("moe_dispatch.share.prefill", "moe.slot_fill.prefill",
       "moe.drop.prefill")
CTX = types.SimpleNamespace(busy_s=2.0)


def _span(name, t0, t1, **attrs):
    return Span(name=name, trace_id="t", span_id=f"{name}@{t0}",
                parent_id=None, proc="p", thread="m", t_start=t0, t_end=t1,
                attrs=attrs)


def _chunk(t, survivors):
    """One chunk from t (s): filter 1 ms, step 3, sync 4, insert 1.5."""
    ms = 1e-3
    return [_span("sweep.filter", t, t + 1 * ms),
            _span("sweep.step", t + 1 * ms, t + 4 * ms),
            _span("sweep.sync", t + 4 * ms, t + 8 * ms, survivors=survivors),
            _span("sweep.insert", t + 8 * ms, t + 9.5 * ms),
            _span("sweep.chunk", t, t + 10 * ms)]


DISPATCH = [_span("moe.dispatch", 0.0, 0.1, kept=90, assigned=100,
                  slots=150, device_s=0.3),
            _span("moe.dispatch", 0.2, 0.3, kept=100, assigned=100,
                  slots=150, device_s=0.2),
            _span("moe.block", 0.0, 0.4, device_s=1.0)]


@pytest.mark.parametrize("metric,listed,want", [
    ("sweep.enqueue_ms", _chunk(0.0, 5) + _chunk(1.0, 3), 3.0),
    ("sweep.wait_ms", _chunk(0.0, 5) + _chunk(1.0, 3), 4.0),
    ("sweep.archive_ms", _chunk(0.0, 5) + _chunk(1.0, 3), 2.5),
    ("sweep.survivors", _chunk(0.0, 5) + _chunk(1.0, 3), 4.0),
    ("moe_dispatch.share.prefill", DISPATCH, 25.0),
    ("moe.slot_fill.prefill", DISPATCH, 100.0 * 190 / 300),
    ("moe.drop.prefill", DISPATCH, 5.0),
])
def test_reader_on_synthetic_spans(monkeypatch, metric, listed, want):
    read = bench.metric_reader(metric).read
    monkeypatch.setattr(spans, "window", lambda: listed)
    assert read(CTX) == pytest.approx(want, rel=1e-12)
    # without its spans, or with spans of another layer only
    other = DISPATCH if metric in SWEEP else _chunk(0.0, 1)
    monkeypatch.setattr(spans, "window", lambda: other)
    assert read(CTX) is None
    monkeypatch.setattr(spans, "window", lambda: [])
    assert read(CTX) is None


def test_dispatch_share_needs_device_seconds(monkeypatch):
    host_only = [_span("moe.dispatch", 0.0, 0.1, kept=1, assigned=2,
                       slots=4)]
    monkeypatch.setattr(spans, "window", lambda: host_only)
    assert bench.metric_reader("moe_dispatch.share.prefill").read(CTX) \
        is None
    assert bench.metric_reader("moe.drop.prefill").read(CTX) == 50.0


def test_a_program_without_the_process_tracer_reads_nothing(monkeypatch):
    from repro_torch import obs
    monkeypatch.delattr(obs, "PROCESS_TRACER")
    assert spans.window() == []
    for m in SWEEP + MOE:
        assert bench.metric_reader(m).read(CTX) is None


def _window(cell, seconds=0.05):
    """The small cell's job warmed, then its closed loop under the CPU
    profiler: the process tracer's spans of the window."""
    from torch.profiler import ProfilerActivity, profile
    s = small(cell)
    _, _, conf, mix, dev = bench.load_cell(cell, "cpu", s["model"],
                                           s["traffic"])
    job = bench.kind_module(mix["kind"]).Job(conf, mix, 3, dev)
    job.setup()
    PROCESS_TRACER.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        win = bench.closed_loop(job.step, seconds)
    assert not PROCESS_TRACER.enabled
    return job, win


def test_sweep_readers_on_a_small_window():
    job, win = _window("qwen2moe.dse_sweep")
    try:
        got = {m: bench.metric_reader(m).read(CTX) for m in SWEEP}
        assert all(v is not None and v > 0 for v in got.values()), got
        chunks = spans.named("sweep.chunk")
        assert len(chunks) == win["units"] * 5     # 40,000 ids of 8,192
        assert len(spans.named("sweep.run")) == win["units"]
    finally:
        job.close_window()
        PROCESS_TRACER.drain()


def test_moe_readers_on_a_small_window():
    job, win = _window("qwen2moe.prefill")
    try:
        model = small("qwen2moe.prefill")["model"]
        blocks = spans.named("moe.dispatch")
        assert len(blocks) == win["units"] * model["n_layers"]
        fill = bench.metric_reader("moe.slot_fill.prefill").read(CTX)
        drop = bench.metric_reader("moe.drop.prefill").read(CTX)
        e_tot = model["n_experts"] + model["expert_pad"]
        assert 0 < fill <= 100.0 * model["n_experts"] / e_tot
        assert 0 <= drop < 100
        # a CPU block records no device events
        assert bench.metric_reader("moe_dispatch.share.prefill").read(
            CTX) is None
    finally:
        job.close_window()
        PROCESS_TRACER.drain()
