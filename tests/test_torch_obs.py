"""The port's metrics registry and tracer against the reference's: the same
calls on a manual clock give the same snapshot, flat map, CSV and spans."""
import json
import sys
import threading

import pytest

from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro_torch.obs import (NOOP, Counter, CounterView, ManualClock,
                             MetricsRegistry, Span, Tracer)
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace


def _drive_registry(mod):
    """One scripted sequence of registry calls; returns every export."""
    m = mod.MetricsRegistry()
    c = m.counter("reqs", "requests", labelnames=("tier",))
    c.touch(tier="batch")
    c.inc(tier="fast")
    c.inc(2.5, tier="slow")
    m.counter("plain", "no labels").inc(3)
    g = m.gauge("depth", "queue depth", labelnames=("q",))
    g.set(4, q="a")
    g.set(2, q="a")
    g.set(7, q="b")
    h = m.histogram("lat", "latency", labelnames=("op",), reservoir=50)
    for i in range(1, 121):                  # the reservoir slides past 50
        h.observe((i * 37 % 101) / 100.0, op="eval")
    h.observe(0.25, op="sweep")
    h.touch(op="idle")
    m.histogram("empty")
    return {"snapshot": m.snapshot(), "flat": m.flat(),
            "csv": m.csv_lines(), "json": m.to_json(), "names": m.names(),
            "stats": h.stats(op="eval"), "p90": h.percentile(90, op="eval"),
            "count": h.count(op="eval"), "total": c.total(),
            "view": dict(mod.CounterView(c))}


def _drive_tracer(mod_trace, mod_metrics):
    """One scripted span tree on a manual clock; returns the span dicts."""
    clk = mod_metrics.ManualClock(10.0)
    tr = mod_trace.Tracer(clock=clk, proc="client")
    with tr.span("outer", budget=3) as outer:
        clk.advance(0.5)
        with tr.span("inner", rows=3):
            clk.advance(0.25)
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                clk.advance(1.0)
                raise RuntimeError("no")
    root = tr.start("root", detached=True)
    with tr.activate(root):
        child = tr.start("child", detached=True)
    remote = mod_trace.Tracer(clock=mod_metrics.ManualClock(), proc="w:1")
    with remote.span("remote.eval", parent=root.ctx):
        pass
    n = tr.adopt(s.as_dict() for s in remote.drain())
    clk.advance(2.0)
    tr.lose(child, "worker died")
    tr.finish(root)
    tr.finish(root, status="error")          # idempotent: first wins
    return {"spans": [s.as_dict() for s in tr.spans()], "adopted": n,
            "outer_ctx": outer.ctx, "durations": [s.duration_s
                                                  for s in tr.spans()]}


def test_registry_exports_equal_the_reference():
    assert _drive_registry(t_metrics) == _drive_registry(j_metrics)


def test_tracer_spans_equal_the_reference():
    got = _drive_tracer(t_trace, t_metrics)
    assert got == _drive_tracer(j_trace, j_metrics)
    by_name = {s["name"]: s for s in got["spans"]}
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert by_name["boom"]["status"] == "error"
    assert "RuntimeError" in by_name["boom"]["attrs"]["error"]
    assert by_name["child"]["status"] == "lost"
    assert by_name["root"]["status"] == "ok"
    assert by_name["remote.eval"]["trace_id"] == by_name["root"]["trace_id"]
    assert got["adopted"] == 1
    assert Span.from_dict(by_name["inner"]).as_dict() == by_name["inner"]


def test_instrument_semantics():
    m = MetricsRegistry()
    c = m.counter("n", "first", labelnames=("k",))
    assert m.counter("n", labelnames=("k",)) is c
    with pytest.raises(ValueError):
        m.gauge("n", labelnames=("k",))        # kind conflict
    with pytest.raises(ValueError):
        m.counter("n")                         # label-schema conflict
    with pytest.raises(ValueError):
        c.inc(-1, k="x")                       # counters are monotonic
    with pytest.raises(ValueError):
        c.inc()                                # label schema enforced
    with pytest.raises(ValueError):
        CounterView(Counter("plain"))          # needs exactly one label
    view = CounterView(c)
    with pytest.raises(KeyError):
        view["never-touched"]
    assert m.histogram("h").stats()["p50"] is None
    assert json.loads(m.to_json())["n"]["type"] == "counter"


def test_noop_tracer_is_inert():
    assert NOOP.enabled is False
    with NOOP.span("x") as sp:
        sp.attrs["y"] = 1
    assert NOOP.current_ctx() is None and NOOP.current() is None
    assert NOOP.adopt([{"name": "z"}]) == 0
    assert NOOP.spans() == [] and NOOP.drain() == []


def test_counters_and_spans_lose_nothing_across_threads():
    """More threads than cores, a short switch interval: every increment
    and every span lands."""
    m = MetricsRegistry()
    c = m.counter("hits", labelnames=("t",))
    h = m.histogram("obs")
    tr = Tracer(clock=ManualClock())
    n_threads, n_each = 16, 400

    def work(i):
        for _ in range(n_each):
            c.inc(t=i % 4)
            h.observe(1.0)
            with tr.span("op"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c.total() == n_threads * n_each
    assert h.count() == n_threads * n_each
    assert len(tr.spans()) == n_threads * n_each
    assert all(s.parent_id is None for s in tr.spans())
