"""The port's metrics registry, tracer, exporters and fleet report against
the reference's: the same calls on a manual clock give the same snapshot,
flat map, CSV and spans; the same spans give the same Perfetto events,
tree checks and ASCII tree; the same snapshot gives the same dashboard;
the service's telemetry keeps the reference's frozen key sets; and the
sweep's spans form the reference's tree."""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro.obs import export as j_export
from repro.obs import metrics as j_metrics
from repro.obs import report as j_report
from repro.obs import trace as j_trace
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro.perfmodel.sweep import SweepEngine as JSweepEngine
from repro.distributed import FaultEvent as JFaultEvent
from repro.distributed import FaultPlan as JFaultPlan
from repro_torch.distributed import (DEGRADE_RUNGS, QOS_TIERS, EvalService,
                                     FaultEvent, FaultPlan, ShardedEvaluator)
from repro_torch.obs import (NOOP, PROCESS_TRACER, Counter, CounterView,
                             ManualClock, MetricsRegistry, ProcessTracer,
                             Span, Tracer, build_tree,
                             completeness_errors, metrics_csv_lines,
                             render_tree, trace_events, validate_trace_events,
                             write_metrics_json, write_trace)
from repro_torch.obs import export as t_export
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import report as t_report
from repro_torch.obs import trace as t_trace
from repro_torch.perfmodel import EvalRequest, ModelEvaluator, get_evaluator
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.sweep import SweepEngine


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


# ---------------------------------------------------------------- exporters
def _same_export(a: dict, b: dict) -> bool:
    """Equal trace objects but for the exporter's own name."""
    a, b = json.loads(json.dumps(a)), json.loads(json.dumps(b))
    assert a["otherData"].pop("exporter") == "repro_torch.obs"
    assert b["otherData"].pop("exporter") == "repro.obs"
    return a == b


def test_trace_export_equals_the_reference(tmp_path):
    """Perfetto events, the schema check, the tree checks and the ASCII
    tree of the same spans are the reference's."""
    spans = _drive_tracer(t_trace, t_metrics)["spans"]
    obj = trace_events(spans)
    assert _same_export(obj, j_export.trace_events(spans))
    assert validate_trace_events(obj) == [] == \
        j_export.validate_trace_events(obj)
    assert {e["ph"] for e in obj["traceEvents"]} == {"M", "X"}
    assert render_tree(spans) == j_export.render_tree(spans)
    assert "`-- " in render_tree(spans)
    tid = spans[0]["trace_id"]
    assert render_tree(spans, tid) == j_export.render_tree(spans, tid)
    assert completeness_errors(spans) == j_export.completeness_errors(spans)
    roots, kids = build_tree(spans)
    j_roots, j_kids = j_export.build_tree(spans)
    assert [s.as_dict() for s in roots] == [s.as_dict() for s in j_roots]
    assert {k: [s.as_dict() for s in v] for k, v in kids.items()} == \
        {k: [s.as_dict() for s in v] for k, v in j_kids.items()}
    path = write_trace(str(tmp_path / "t.json"), spans)
    assert json.load(open(path)) == json.loads(json.dumps(obj, default=str))
    broken = [{"ph": "Q"}, {"ph": "X", "name": "x", "pid": 1, "tid": 1}]
    assert validate_trace_events({"traceEvents": broken}) == \
        j_export.validate_trace_events({"traceEvents": broken})
    dangling = Span("x", "t1", "s9", "missing", "p", "th", 0.0, t_end=None)
    errs = completeness_errors([dangling])
    assert errs == j_export.completeness_errors([dangling.as_dict()])
    assert any("dangling" in e for e in errs)
    assert any("never finished" in e for e in errs)


def test_metrics_csv_and_json_equal_the_reference(tmp_path):
    got = _drive_registry(t_metrics)
    assert metrics_csv_lines(got["flat"]) == \
        j_export.metrics_csv_lines(got["flat"])
    assert metrics_csv_lines(got["flat"])[0] == "metric,value"
    a = write_metrics_json(str(tmp_path / "a.json"), got["snapshot"])
    b = j_export.write_metrics_json(str(tmp_path / "b.json"),
                                    got["snapshot"])
    assert open(a).read() == open(b).read()


# ------------------------------------------- service telemetry + dashboard
SERVICE_KEYS = frozenset({"submits", "cache_hits", "fused_dispatches",
                          "coalesced_requests", "degraded", "tiers"})
EVALUATOR_KEYS = frozenset(
    f"evaluator_{n}" for n in ("dispatches", "worker_dispatches", "retried",
                               "straggler_redispatches", "timeouts",
                               "corrupt_rejected", "resizes"))
TIER_KEYS = frozenset({"weight", "served", "queued", "p50_ms", "p99_ms"})


def _chaotic_service():
    """A service over a 2-worker sharded evaluator whose first dispatch of
    each worker crashes, on one manual clock (deterministic latencies)."""
    clock = ManualClock()
    plan = FaultPlan([FaultEvent(0, 0, "crash"), FaultEvent(1, 1, "crash")])
    base = ModelEvaluator(get_evaluator("proxy", device="cpu").models,
                          device="cpu")
    sharded = ShardedEvaluator(base, workers=2, mode="thread",
                               fault_plan=plan, speculate=False, clock=clock)
    svc = EvalService(sharded, clock=clock)
    rng = np.random.default_rng(7)
    svc.evaluate(EvalRequest(SPACE.sample(rng, 8), detail="stalls"))
    clock.advance(0.25)
    for tier in QOS_TIERS:
        svc.submit(EvalRequest(SPACE.sample(rng, 2), "objectives"),
                   client=tier, tier=tier)
    clock.advance(0.5)
    svc.tick()
    return svc, sharded


def test_service_telemetry_keys_frozen_under_chaos():
    """telemetry() keeps the reference's frozen key sets while retries are
    firing (tests/test_obs.py)."""
    from repro.distributed.service import DEGRADE_RUNGS as J_RUNGS
    from repro.distributed.service import QOS_TIERS as J_TIERS
    svc, sharded = _chaotic_service()
    tel = svc.telemetry()
    assert frozenset(tel) == SERVICE_KEYS | EVALUATOR_KEYS
    assert (DEGRADE_RUNGS, QOS_TIERS) == (J_RUNGS, J_TIERS)
    assert frozenset(tel["degraded"]) == {"deadline"} | set(DEGRADE_RUNGS)
    assert frozenset(tel["tiers"]) == frozenset(QOS_TIERS)
    for t in QOS_TIERS:
        assert frozenset(tel["tiers"][t]) == TIER_KEYS
    # on the manual clock: queued at 0.25 s, resolved at 0.75 s
    assert tel["tiers"]["interactive"]["p50_ms"] == 500.0
    assert tel["tiers"]["scavenger"]["p99_ms"] == 500.0
    assert tel["evaluator_retried"] == 2
    assert all(isinstance(tel[k], int)
               for k in ("submits", "cache_hits", "fused_dispatches",
                         "coalesced_requests"))
    sharded.close()


def test_fleet_report_equals_the_reference(tmp_path, capsys):
    """The dashboard of one gateway snapshot (the service put behind a
    ``Gateway``) is the reference's, line for line after the title; the
    CLI renders the saved snapshot the same."""
    from repro_torch.serve import Gateway
    svc, sharded = _chaotic_service()
    gw = Gateway(svc)
    snap = gw.snapshot()
    assert set(snap) == {"telemetry", "metrics"}
    assert set(snap["metrics"]) == {"gateway", "service", "evaluator"}
    assert snap["telemetry"]["service"] == svc.telemetry()
    fleet = snap["telemetry"]["fleet"]
    assert (fleet["mode"], fleet["workers"], fleet["evictions"],
            fleet["reregistrations"]) == ("thread", 2, 2, 2)
    snap = json.loads(json.dumps(snap, default=str))
    txt = t_report.fleet_report(snap)
    ref = j_report.fleet_report(snap)
    assert txt.splitlines()[0] == "== repro_torch.obs fleet report =="
    assert txt.splitlines()[1:] == ref.splitlines()[1:]
    for section in ("-- traffic --", "-- qos tiers (queue latency) --",
                    "-- degradation rungs --", "-- fleet --",
                    "-- shard timings (per worker slot) --"):
        assert section in txt
    assert t_report.fleet_report(gw) == txt            # a live gateway
    path = str(tmp_path / "snap.json")
    gw.save_snapshot(path)
    assert t_report.main([path]) == 0
    assert capsys.readouterr().out.strip() == txt
    sharded.close()


# ---------------------------------------------------------- sweep tracing
def _tree(spans) -> list:
    """Spans as (name, parent's name, status, attrs), sorted."""
    by_id = {s["span_id"]: s for s in spans}
    return sorted((s["name"], by_id[s["parent_id"]]["name"]
                   if s["parent_id"] in by_id else None, s["status"],
                   json.dumps(s["attrs"], sort_keys=True)) for s in spans)


def test_sweep_spans_form_the_reference_tree():
    """sweep.run roots one tree; each worker span is parented explicitly
    under it (threads do not inherit), a replayed span carries its
    replays; the reference's engine draws the same tree of run and worker
    spans.  The port adds each chunk under its worker span, with its four
    phases as children, and the final merge under sweep.run."""
    ch = 8_192
    tr, j_tr = Tracer(clock=ManualClock()), j_trace.Tracer(
        clock=j_metrics.ManualClock())
    eng = SweepEngine(get_evaluator("proxy", device="cpu"), chunk_size=ch,
                      tracer=tr)
    j_eng = JSweepEngine(j_get_evaluator("proxy"), chunk_size=ch,
                         tracer=j_tr)
    eng.run(0, 3 * ch, workers=2,
            fault_plan=FaultPlan([FaultEvent(0, 1, "crash")]))
    j_eng.run(0, 3 * ch, workers=2,
              fault_plan=JFaultPlan([JFaultEvent(0, 1, "crash")]))
    spans = [s.as_dict() for s in tr.spans()]
    ref = [s.as_dict() for s in j_tr.spans()]
    ref_names = {s["name"] for s in ref}
    assert ref_names == {"sweep.run", "sweep.span"}
    assert _tree([s for s in spans if s["name"] in ref_names]) == _tree(ref)
    by_id = {s["span_id"]: s for s in spans}
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s["name"])
    chunks = [s for s in spans if s["name"] == "sweep.chunk"]
    assert len(chunks) == eng.telemetry()["chunks"] == 4    # 3 + 1 replayed
    for c in chunks:
        assert by_id[c["parent_id"]]["name"] == "sweep.span"
        assert kids[c["span_id"]] == ["sweep.filter", "sweep.step",
                                      "sweep.sync", "sweep.insert"]
    (red,) = [s for s in spans if s["name"] == "sweep.reduce"]
    assert by_id[red["parent_id"]]["name"] == "sweep.run"
    assert completeness_errors(spans) == []
    assert validate_trace_events(trace_events(spans)) == []
    names = [s["name"] for s in spans]
    assert names.count("sweep.span") == 2 and names.count("sweep.run") == 1
    replayed = [s for s in spans if "replays" in s["attrs"]]
    assert len(replayed) == 1 and replayed[0]["attrs"]["worker"] == 0


# ---------------------------------------------------------- process tracer
def _profiled():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def test_process_tracer_records_nothing_with_the_profiler_off():
    tr = ProcessTracer()
    assert tr.enabled is False and PROCESS_TRACER.enabled is False
    with tr.span("a", device="cpu", n=torch.ones(())) as sp:
        assert sp.recording is False
        with tr.span("b"):
            pass
    sp = tr.start("c")
    tr.finish(sp)
    with tr.activate(sp):
        assert tr.current() is None
    assert tr.spans() == [] and tr._open == {} and not tr._pending


def test_process_tracer_nests_spans_under_the_profiler():
    """Under torch.profiler the spans nest with parents and one trace id,
    and each is a host range of its name on the profiler's timeline (not
    a user annotation, which kineto also lists on the device)."""
    from torch.autograd import DeviceType
    tr = ProcessTracer()
    with _profiled() as prof:
        assert tr.enabled
        with tr.span("outer", k=1):
            with tr.span("inner.a"):
                torch.ones(4).sum()
            with tr.span("inner.b"):
                with tr.span("leaf"):
                    torch.ones(4).mul(2)
    assert tr.enabled is False
    got = {s.name: s for s in tr.spans()}
    assert [s.name for s in tr.spans()] == ["inner.a", "leaf", "inner.b",
                                            "outer"]
    outer = got["outer"]
    assert outer.parent_id is None and outer.attrs == {"k": 1}
    assert got["inner.a"].parent_id == got["inner.b"].parent_id \
        == outer.span_id
    assert got["leaf"].parent_id == got["inner.b"].span_id
    assert {s.trace_id for s in got.values()} == {outer.span_id}
    assert completeness_errors([s.as_dict() for s in got.values()]) == []
    assert all(s.t_start <= s.t_end for s in got.values())
    events = {e.name: e for e in prof.events() if e.name in got}
    assert set(events) == set(got)
    for e in events.values():
        assert e.device_type == DeviceType.CPU
        assert not getattr(e, "is_user_annotation", False)
    assert events["leaf"].cpu_parent.name == "inner.b"


def test_process_tracer_operator_switch():
    tr = ProcessTracer()
    tr.force(True)
    try:
        assert tr.enabled
        with tr.span("forced", device="cpu") as sp:
            assert sp.recording
        assert tr._open == {}          # no profiler, so no host range
    finally:
        tr.force(False)
    with tr.span("off"):
        pass
    assert [s.name for s in tr.drain()] == ["forced"]
    assert "device_s" not in sp.attrs  # a CPU device span takes no events
    assert tr.spans() == []


class _Event:
    """A CUDA event stand-in that logs what is asked of it."""

    def __init__(self, log, device):
        self.log, self.t = log, len(log)
        log.append(("record", str(device)))

    def synchronize(self):
        self.log.append(("synchronize", self.t))

    def elapsed_time(self, end):
        self.log.append(("elapsed", self.t, end.t))
        return 250.0                   # ms


def test_process_tracer_resolves_counts_and_device_spans_when_read():
    log = []
    tr = ProcessTracer(event=lambda d: _Event(log, d))
    tr.force(True)
    try:
        with tr.span("dev", device=torch.device("cuda", 0)) as sp:
            sp.attrs["kept"] = torch.tensor(7)
            sp.attrs["per"] = torch.tensor([1, 2])
            sp.attrs["made"] = 9
        with tr.span("host") as host:
            pass
    finally:
        tr.force(False)
    assert log == [("record", "cuda:0"), ("record", "cuda:0")]
    assert isinstance(sp.attrs["kept"], torch.Tensor)
    (dev, h) = tr.spans()
    assert dev is sp and h is host
    assert log[2:] == [("synchronize", 1), ("elapsed", 0, 1)]
    assert sp.attrs == {"kept": 7, "per": [1, 2], "made": 9,
                        "device_s": 0.25}
    assert host.attrs == {}
    tr.spans()                        # each is resolved once
    assert len(log) == 4


def test_adamw_update_is_a_span_of_the_process_tracer():
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen)}
    grads = {"w": torch.randn(4, 3, generator=gen)}
    plain = {k: v.clone() for k, v in params.items()}
    PROCESS_TRACER.drain()
    with _profiled():
        adamw_update(AdamWConfig(), grads, adamw_init(params), params)
    adamw_update(AdamWConfig(), grads, adamw_init(plain), plain)
    assert [s.name for s in PROCESS_TRACER.drain()] == ["optim.adamw"]
    assert torch.equal(params["w"], plain["w"])
