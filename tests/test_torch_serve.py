"""The port's serve layer (``repro_torch.serve``) against the reference's
(``tests/test_serve.py``).

Every test of ``tests/test_serve.py`` has a counterpart here on the
port's types, under the same name.  The reference's oracle-store and
sweep-result tests (``tests/test_serve.py:408-477``) are held by
``tests/test_torch_portfolio.py``: ``test_oracle_store_loads_without_
sweeping`` (a repeat is a load, not a sweep), ``test_corrupt_checkpoints_
and_artifacts_are_quarantined`` (a corrupt artifact is quarantined and
re-swept, a key mismatch refuses) and ``test_save_load_round_trip``; the
two pieces those do not hold — another sweep configuration is a fresh
artifact, a missing file raises — are ported here.

Contracts: within the port a socket report equals the in-process
evaluation bit for bit (signed, TLS, chaotic, reconnected, after a
SIGKILL); against the reference's socket evaluator on the same ids,
workloads, op classes and op names are exact and every float is held at
rtol 1e-6; codec values, message bodies and sealed frames are byte for
byte the reference's, except a ``Hello``'s real spec, which names the
port's classes by design.

Timing: waits poll a condition under a deadline of their own, and the
tests that time a shard out read :class:`_LandedClock`, which moves only
once every dispatch the real pool took has landed, so a healthy shard
never reads as late whatever the host's load.
"""
import os
import pickle
import shutil
import socket as socket_mod
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.distributed import ShardedEvaluator as JShardedEvaluator
from repro.distributed.service import EvalService as JEvalService
from repro.distributed.sharded import ShardPayload as JShardPayload
from repro.distributed.sharded import _worker_spec as j_worker_spec
from repro.perfmodel import EvalRequest as JEvalRequest
from repro.perfmodel import ModelEvaluator as JModelEvaluator
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro.perfmodel.evaluator import PPAReport as JPPAReport
from repro.serve import Gateway as JGateway
from repro.serve import Keyring as JKeyring
from repro.serve import RetryAfter as JRetryAfter
from repro.serve import WorkerServer as JWorkerServer
from repro.serve import codec as j_codec
from repro.serve import wire as j_wire
from repro_torch.distributed import (EvalService, ShardedEvaluator,
                                     ShardPayload, WorkerFault)
from repro_torch.distributed.faults import (FaultEvent, FaultPlan,
                                            QuotaExceeded)
from repro_torch.distributed.sharded import _worker_spec, evaluator_from_spec
from repro_torch.obs import ManualClock
from repro_torch.perfmodel import (EvalRequest, ModelEvaluator,
                                   OracleEvaluator, get_evaluator)
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.evaluator import PPAReport
from repro_torch.serve import (WIRE_VERSION, Gateway, Keyring, RetryAfter,
                               SocketPool, WorkerOptions, WorkerServer,
                               start_worker_process, wire)
from repro_torch.serve import codec as codec_mod

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-6
DETAILS = ("objectives", "ppa", "stalls")
KEYS = {"k1": b"alpha-secret", "k2": b"beta-secret"}
RNG = np.random.default_rng(7)


def _ids(seed: int, n: int) -> np.ndarray:
    return SPACE.sample(np.random.default_rng(seed), n)


def _fresh(tier: str = "proxy") -> ModelEvaluator:
    """A fresh evaluator (own dispatch counter) over the memoized models."""
    return ModelEvaluator(get_evaluator(tier, device="cpu").models,
                          tier=tier, device="cpu")


def _j_fresh(tier: str = "proxy") -> JModelEvaluator:
    return JModelEvaluator(j_get_evaluator(tier).models, tier=tier)


def _keyring(active="k1"):
    return Keyring(KEYS, active=active)


def _assert_reports_identical(a, b):
    assert a.workloads == b.workloads and a.detail == b.detail
    assert np.array_equal(a.area, b.area)
    for w in a.workloads:
        assert np.array_equal(a.latency[w], b.latency[w])
        if a.detail in ("ppa", "stalls"):
            assert np.array_equal(a.op_time[w], b.op_time[w])
            assert a.op_names[w] == b.op_names[w]
        if a.detail == "stalls":
            assert np.array_equal(a.stall[w], b.stall[w])
            assert np.array_equal(a.op_class[w], b.op_class[w])


def _assert_matches_reference(rep, ref):
    """Exact workloads, op classes and names; floats at rtol 1e-6."""
    assert rep.workloads == tuple(ref.workloads)
    assert rep.detail == ref.detail
    np.testing.assert_allclose(rep.area, np.asarray(ref.area), rtol=RTOL)
    for w in rep.workloads:
        np.testing.assert_allclose(rep.latency[w],
                                   np.asarray(ref.latency[w]), rtol=RTOL)
        if rep.detail in ("ppa", "stalls"):
            np.testing.assert_allclose(rep.op_time[w],
                                       np.asarray(ref.op_time[w]), rtol=RTOL)
            assert tuple(rep.op_names[w]) == tuple(ref.op_names[w])
        if rep.detail == "stalls":
            np.testing.assert_allclose(rep.stall[w],
                                       np.asarray(ref.stall[w]), rtol=RTOL)
            assert np.array_equal(rep.op_class[w],
                                  np.asarray(ref.op_class[w]))


def _wait_for(cond, timeout_s: float = 30.0) -> bool:
    """Poll `cond` until it holds or `timeout_s` passes; its last value."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return bool(cond())
        time.sleep(0.01)
    return True


class _LandedClock:
    """A :class:`ManualClock` that moves only once every dispatch the real
    pool has taken has landed: each read then advances it by ``step``.
    A hung dispatch never reaches the real pool (the chaos pool keeps
    it), so only a hung shard's age can pass a deadline."""

    def __init__(self, step: float):
        self.clock = ManualClock()
        self.step = float(step)
        self.futures = []
        self._lock = threading.Lock()

    def watch(self, ev: ShardedEvaluator) -> None:
        pool = ev._raw_pool
        submit = pool.submit

        def recorded(payload):
            fut = submit(payload)
            with self._lock:
                self.futures.append(fut)
            return fut

        pool.submit = recorded

    def __call__(self) -> float:
        with self._lock:
            if self.futures and all(f.done() for f in self.futures):
                self.clock.advance(self.step)
            return self.clock()


@pytest.fixture(scope="module")
def servers():
    """Two in-process port worker daemons on loopback ephemeral ports."""
    s1, s2 = WorkerServer(), WorkerServer()
    s1.start()
    s2.start()
    yield s1, s2
    s1.close()
    s2.close()


@pytest.fixture(scope="module")
def j_servers():
    """Two in-process reference worker daemons."""
    s1, s2 = JWorkerServer(), JWorkerServer()
    s1.start()
    s2.start()
    yield s1, s2
    s1.close()
    s2.close()


def _addrs(pair):
    return [(s.host, s.port) for s in pair]


# ---------------------------------------------------------------- wire
def test_wire_roundtrip_every_message_type():
    a, b = socket_mod.socketpair()
    try:
        for msg in (wire.Hello(b"spec"), wire.Ready("digest", ("lat",)),
                    wire.Dispatch(3, "payload"), wire.ResultMsg(3, "rep"),
                    wire.ErrorMsg(3, "boom"), wire.Ping(1), wire.Pong(1),
                    wire.Bye("done"), wire.Announce(("h", 1), ("d",), 2),
                    wire.LeaseAck(1.5)):
            wire.send_msg(a, msg)
            assert wire.recv_msg(b) == msg
    finally:
        a.close()
        b.close()


def test_wire_rejects_oversized_frames_before_allocation():
    assert (wire.WIRE_VERSION, wire.MAX_MESSAGE_BYTES) == (
        j_wire.WIRE_VERSION, j_wire.MAX_MESSAGE_BYTES) == (1, 1 << 31)
    a, b = socket_mod.socketpair()
    try:
        wire.send_msg(a, wire.Dispatch(0, b"x" * 4096))
        with pytest.raises(wire.WireError, match="exceeds"):
            wire.recv_msg(b, max_bytes=64)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("cut", [0, 3, 8 + 5])
def test_wire_eof_raises_connection_closed(cut):
    """EOF before a frame, inside its length prefix and inside its body
    (the half frame a SIGKILLed peer leaves) all raise ConnectionClosed."""
    a, b = socket_mod.socketpair()
    frame = struct.pack(">Q", 64) + b"x" * 64
    a.sendall(frame[:cut])
    a.close()
    try:
        with pytest.raises(wire.ConnectionClosed):
            wire.recv_frame(b)
    finally:
        b.close()


def test_check_hello_gates_type_and_version():
    with pytest.raises(wire.WireError, match="expected Hello"):
        wire.check_hello(wire.Ping(0))
    with pytest.raises(wire.WireError, match="version"):
        wire.check_hello(wire.Hello(b"", wire_version=WIRE_VERSION + 1))
    hello = wire.Hello(b"spec")
    assert wire.check_hello(hello) is hello


# ---------------------------------------------------------------- spec
def test_spec_highest_protocol_and_roundtrip():
    """The worker spec rides pickle.HIGHEST_PROTOCOL and rebuilds an
    evaluator bit-identical to its source, on its device type."""
    spec = _worker_spec(_fresh())
    assert spec[0] == 0x80                      # pickle protocol opcode
    assert spec[1] == pickle.HIGHEST_PROTOCOL
    assert pickle.loads(spec)["device"] == "cpu"
    rebuilt = evaluator_from_spec(spec)
    assert rebuilt.device == torch.device("cpu")
    local = _fresh()
    idx = _ids(1, 9)
    for detail in ("objectives", "stalls"):
        req = EvalRequest(idx, detail=detail)
        _assert_reports_identical(rebuilt.evaluate(req), local.evaluate(req))


# -------------------------------------------------------- socket fabric
def test_socket_mode_argument_validation():
    with pytest.raises(ValueError, match="addresses"):
        ShardedEvaluator(_fresh(), mode="socket")
    with pytest.raises(ValueError, match="socket"):
        ShardedEvaluator(_fresh(), workers=2, addresses=[("h", 1)])
    with pytest.raises(ValueError, match="socket"):
        ShardedEvaluator(_fresh(), workers=2, membership=object())


@pytest.mark.parametrize("tier", ["proxy", "target"])
def test_socket_sharded_bit_identical_to_local(servers, tier):
    """Acceptance: a 2-worker loopback socket pool reassembles reports
    bit-identical to the in-process evaluator, on both fidelity tiers."""
    idx = _ids(2, 23)                           # odd size: uneven shards
    local = _fresh(tier)
    ev = ShardedEvaluator(_fresh(tier), mode="socket",
                          addresses=_addrs(servers))
    assert ev.mode == "socket" and ev.workers == 2
    for detail in DETAILS:
        req = EvalRequest(idx, detail=detail)
        _assert_reports_identical(ev.evaluate(req), local.evaluate(req))
    assert ev.worker_dispatches == 6            # really fanned out
    assert sorted(ev.registry.snapshot()["live"]) == [0, 1]
    assert ev.registry is ev._raw_pool.registry  # the pool owns liveness
    ev.close()


def test_connect_evaluator_fans_out_to_every_address(servers):
    from repro_torch.serve import connect_evaluator
    ev = connect_evaluator(_fresh(), _addrs(servers))
    idx = _ids(44, 8)
    try:
        assert ev.mode == "socket" and ev.workers == 2
        _assert_reports_identical(ev.ppa(idx), _fresh().ppa(idx))
        assert ev.worker_dispatches == 2
    finally:
        ev.close()


@pytest.mark.parametrize("tier", ["proxy", "target"])
def test_socket_evaluation_matches_the_reference(servers, j_servers, tier):
    """The same sampled ids (B 1 and a ragged 12/11 split) through the
    reference's socket evaluator over two reference workers and the
    port's over two port workers: exact workloads, classes and names,
    floats at rtol 1e-6; the port's equals its in-process run bit for
    bit."""
    ev = ShardedEvaluator(_fresh(tier), mode="socket",
                          addresses=_addrs(servers))
    j_ev = JShardedEvaluator(_j_fresh(tier), mode="socket",
                             addresses=_addrs(j_servers))
    local = _fresh(tier)
    try:
        for n in (1, 23):
            idx = _ids(40 + n, n)
            for detail in DETAILS:
                rep = ev.evaluate(EvalRequest(idx, detail=detail))
                _assert_reports_identical(
                    rep, local.evaluate(EvalRequest(idx, detail=detail)))
                _assert_matches_reference(
                    rep, j_ev.evaluate(JEvalRequest(idx, detail=detail)))
        # B 1 rides the pool too (one shard), B 23 fans out to both
        assert ev.worker_dispatches == j_ev.worker_dispatches == 3 + 6
    finally:
        ev.close()
        j_ev.close()


def test_socket_chaos_crash_hang_bit_identical(servers):
    """FaultPlan chaos composes with the socket pool: a crashed dispatch
    retries and a hung one times out + retries, bit-identical result."""
    idx = _ids(3, 16)
    local = _fresh().evaluate(EvalRequest(idx, "stalls"))
    plan = FaultPlan([FaultEvent(0, 0, "crash"), FaultEvent(1, 1, "hang")])
    clock = _LandedClock(step=0.1)
    ev = ShardedEvaluator(_fresh(), mode="socket", addresses=_addrs(servers),
                          fault_plan=plan, shard_timeout_s=0.3,
                          speculate=False, clock=clock)
    clock.watch(ev)
    rep = ev.evaluate(EvalRequest(idx, "stalls"))
    _assert_reports_identical(rep, local)
    assert ev.retried >= 1                      # the crash
    rep = ev.evaluate(EvalRequest(idx, "stalls"))
    _assert_reports_identical(rep, local)
    assert ev.retried >= 2                      # crash + hang both retried
    assert ev.timeouts == 1
    assert len(plan) == 0                       # every event consumed
    ev.close()


def test_socket_remote_evaluation_error_is_not_fatal(servers):
    """A worker-side evaluation failure surfaces as WorkerFault WITHOUT
    tearing the connection down — the next dispatch reuses it."""
    s1, _ = servers
    pool = SocketPool(_fresh(), addresses=[(s1.host, s1.port)])
    bad = ShardPayload(_ids(4, 2), "nonsense_detail", None)
    with pytest.raises(WorkerFault, match="remote evaluation"):
        pool.submit(bad).result(timeout=60)
    idx = _ids(5, 4)
    rep = pool.submit(ShardPayload(idx, "objectives", None)).result(timeout=60)
    _assert_reports_identical(rep, _fresh().evaluate(
        EvalRequest(idx, "objectives")))
    assert pool.live_workers() == 1 and pool.reconnects == 0
    pool.close()


def test_socket_pool_reconnect_reregisters(servers):
    """A dead connection fails in-flight work, is evicted from the
    registry, and the next submit redials + re-registers the slot."""
    s1, _ = servers
    pool = SocketPool(_fresh(), addresses=[(s1.host, s1.port)],
                      reconnect_cooldown_s=0.0)
    payload = ShardPayload(_ids(6, 4), "objectives", None)
    rep = pool.submit(payload).result(timeout=60)
    assert pool.registry.alive(0)
    pool._conns[0].die("simulated network partition")
    assert not pool.registry.alive(0)
    assert pool.registry.evictions >= 1
    rep2 = pool.submit(payload).result(timeout=60)
    _assert_reports_identical(rep, rep2)
    assert pool.reconnects == 1
    assert pool.registry.reregistrations >= 1
    assert pool.registry.alive(0)
    pool.close()


class _FakeWorker:
    """A worker that answers the handshake, then ends the connection in
    one of the ways a real one can: EOF inside a length prefix, half a
    frame (what a SIGKILL mid-send leaves), a body the codec refuses, a
    body whose string is not utf-8."""

    def __init__(self, ending: str):
        self.ending = ending
        self.sock = socket_mod.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.address = self.sock.getsockname()[:2]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        ch = codec_mod.Channel(conn)
        ch.recv()                                       # Hello
        ch.send(wire.Ready("digest", ("ttft", "tpot")))
        while not isinstance(ch.recv(), wire.Dispatch):
            pass                                        # heartbeats
        head = codec_mod.MAGIC + bytes([0])
        if self.ending == "eof_in_prefix":
            conn.sendall(b"\x00\x00\x00")
        elif self.ending == "half_frame":
            conn.sendall(struct.pack(">Q", 4096) + head + b"M" * 100)
        elif self.ending == "codec_error":
            wire.send_frame(conn, head + b"M\x00\x00\x00\x05")
        else:                                           # bad utf-8
            wire.send_frame(conn, head + b"S\x00\x00\x00\x02\xff\xfe")
        conn.close()
        self.sock.close()


@pytest.mark.parametrize("ending", ["eof_in_prefix", "half_frame",
                                    "codec_error", "bad_utf8"])
def test_every_connection_end_fails_in_flight_futures_once(ending):
    """Whatever stops a connection's reader, its in-flight futures fail
    with WorkerFault exactly once and the slot is marked dead — the
    evaluator's retry takes over instead of waiting on a timeout."""
    fake = _FakeWorker(ending)
    pool = SocketPool(_fresh(), addresses=[fake.address], spec=b"spec",
                      heartbeat_s=60.0)
    calls = []
    fut = pool.submit(ShardPayload(_ids(7, 2), "objectives", None))
    fut.add_done_callback(lambda f: calls.append(f.exception()))
    with pytest.raises(WorkerFault, match="died"):
        fut.result(timeout=30)
    assert _wait_for(lambda: len(calls) == 1)
    assert isinstance(calls[0], WorkerFault) and len(calls) == 1
    assert pool.live_workers() == 0 and not pool.registry.alive(0)
    fake.thread.join(timeout=30)
    pool.close()


def test_socket_worker_sigkill_mid_stream_bit_identical():
    """Acceptance: SIGKILL a worker process while a stream of requests is
    in flight — the dead slot is evicted (elastic resize included) and
    every reassembled report stays bit-identical."""
    w1 = start_worker_process()
    w2 = start_worker_process()
    ev = None
    try:
        idx = _ids(8, 64)
        want = _fresh().evaluate(EvalRequest(idx, "stalls"))
        ev = ShardedEvaluator(_fresh(), mode="socket",
                              addresses=[w1.address, w2.address],
                              elastic=True)
        reports, errors = [], []

        def stream():
            try:
                for _ in range(30):
                    reports.append(ev.evaluate(EvalRequest(idx, "stalls")))
            except Exception as exc:            # noqa: BLE001 — reraised
                errors.append(exc)

        t = threading.Thread(target=stream)
        t.start()
        _wait_for(lambda: len(reports) >= 3 or not t.is_alive(), 120)
        w2.kill()                               # SIGKILL, no goodbye
        t.join(timeout=300)
        assert not t.is_alive()
        assert not errors, errors
        assert len(reports) == 30
        for rep in reports:
            _assert_reports_identical(rep, want)
        snap = ev.registry.snapshot()
        assert snap["evictions"] >= 1           # the dead slot was noticed
        assert 0 in snap["live"]                # the survivor serves on
    finally:
        if ev is not None:
            ev.close()
        for w in (w1, w2):
            if w.alive():
                w.kill()


# ------------------------------------------------------------ QoS tiers
def test_service_tier_validation():
    ev = _fresh()
    with pytest.raises(ValueError, match="tier"):
        EvalService(ev).submit(EvalRequest(_ids(9, 1)), tier="bulk")
    with pytest.raises(ValueError, match="unknown QoS tiers"):
        EvalService(ev, tier_weights={"bulk": 1.0})
    with pytest.raises(ValueError, match="> 0"):
        EvalService(ev, tier_weights={"batch": 0.0})


def test_qos_scavenger_never_starved_under_interactive_flood():
    """With a saturating interactive backlog and a row-capped tick, the
    anti-starvation floor keeps scavenger throughput > 0."""
    svc = EvalService(_fresh(), max_rows_per_tick=4)
    idx = _ids(10, 66)
    inter = [svc.submit(EvalRequest(idx[i:i + 1]), client=f"i{i}",
                        tier="interactive") for i in range(60)]
    scav = [svc.submit(EvalRequest(idx[60 + j:61 + j]), client="bg",
                       tier="scavenger") for j in range(6)]
    ticks = 0
    while not all(f.done() for f in scav):
        svc.tick()
        ticks += 1
        assert ticks <= 10                      # floor: >= 1 scavenger/tick
    assert svc.tier_served["scavenger"] == 6
    assert any(not f.done() for f in inter)     # the flood is still queued
    svc.close()


def test_qos_tier_weights_shape_throughput():
    """Equal offered load per tier + a row-capped tick: throughput orders
    by weight (8:3:1) and the cap is spent exactly every tick."""
    svc = EvalService(_fresh(), max_rows_per_tick=13)
    idx = _ids(11, 240)
    k = 0
    for t in ("interactive", "batch", "scavenger"):
        for _ in range(80):
            svc.submit(EvalRequest(idx[k:k + 1]), client=t, tier=t)
            k += 1
    for _ in range(8):
        svc.tick()
    served = dict(svc.tier_served)
    assert sum(served.values()) == 8 * 13       # cap spent exactly
    assert served["scavenger"] >= 8             # the floor, every tick
    assert served["interactive"] > 1.5 * served["batch"]
    assert served["batch"] > 1.5 * served["scavenger"]
    svc.close()


def test_service_tier_telemetry_percentiles():
    svc = EvalService(_fresh())
    idx = _ids(12, 2)
    svc.submit(EvalRequest(idx[:1]), tier="interactive")
    svc.submit(EvalRequest(idx[1:]), tier="batch")
    svc.tick()
    tiers = svc.telemetry()["tiers"]
    assert set(tiers) == {"interactive", "batch", "scavenger"}
    assert tiers["interactive"]["served"] == 1
    assert tiers["interactive"]["p50_ms"] is not None
    assert tiers["interactive"]["p99_ms"] >= tiers["interactive"]["p50_ms"]
    assert tiers["batch"]["weight"] == 3.0
    assert tiers["scavenger"]["served"] == 0
    assert tiers["scavenger"]["p50_ms"] is None
    svc.close()


# ------------------------------------------------------------- gateway
def test_gateway_budget_exhaustion_and_window_roll():
    clock = [0.0]
    gw = Gateway(_fresh(), rows_per_window=10, window_s=60.0,
                 now=lambda: clock[0])
    idx = _ids(13, 13)
    fut = gw.submit(EvalRequest(idx[:10]), tenant="acme")
    gw.tick()
    assert fut.done()
    with pytest.raises(RetryAfter) as ei:
        gw.submit(EvalRequest(idx[10:11]), tenant="acme")
    assert 0 < ei.value.retry_after_s <= 60.0
    tel = gw.telemetry()
    assert tel["tenants"]["acme"]["rejected_budget"] == 1
    assert tel["tenants"]["acme"]["used_rows"] == 10   # rejects cost nothing
    assert tel["admission"]["rejected"] == 1
    clock[0] += 61.0                            # the window rolls
    fut2 = gw.submit(EvalRequest(idx[10:12]), tenant="acme")
    gw.tick()
    assert fut2.done()
    assert gw.telemetry()["tenants"]["acme"]["used_rows"] == 2
    gw.close()


def test_gateway_backpressure_rejects_with_drain_eta():
    gw = Gateway(_fresh(), max_queued_rows=4)
    idx = _ids(14, 6)
    for i in range(4):                          # fill the backlog, no ticks
        gw.submit(EvalRequest(idx[i:i + 1]), tenant=f"t{i}")
    with pytest.raises(RetryAfter) as ei:
        gw.submit(EvalRequest(idx[4:5]), tenant="late")
    assert ei.value.retry_after_s > 0
    assert gw.telemetry()["tenants"]["late"]["rejected_backpressure"] == 1
    gw.tick()                                   # the backlog drains
    fut = gw.submit(EvalRequest(idx[4:5]), tenant="late")
    gw.tick()
    assert fut.done()
    gw.close()


def test_gateway_per_tenant_quota_overrides():
    gw = Gateway(_fresh(), rows_per_window=100, tenants={"small": 2})
    idx = _ids(15, 5)
    gw.submit(EvalRequest(idx[:2]), tenant="small")
    with pytest.raises(RetryAfter):
        gw.submit(EvalRequest(idx[2:3]), tenant="small")
    # unknown tenants get the default quota — config, not an allow-list
    gw.submit(EvalRequest(idx[:3]), tenant="unheard_of")
    gw.tick()
    assert gw.telemetry()["tenants"]["unheard_of"]["admitted_rows"] == 3
    gw.close()


def test_gateway_validation_and_tier_pass_through():
    with pytest.raises(ValueError, match="default_tier"):
        Gateway(_fresh(), default_tier="bulk")
    gw = Gateway(_fresh(), default_tier="scavenger")
    gw.submit(EvalRequest(_ids(16, 1)), tenant="t")
    gw.tick()
    assert gw.service.tier_served["scavenger"] == 1
    gw.close()


def test_gateway_is_drop_in_evaluator_with_fleet_telemetry():
    """The gateway implements the Evaluator protocol, and telemetry
    merges service counters, tenant ledgers and the fleet registry."""
    sharded = ShardedEvaluator(_fresh(), workers=2)
    gw = Gateway(EvalService(sharded))
    idx = _ids(17, 7)
    assert np.array_equal(gw.objectives(idx), _fresh().objectives(idx))
    _assert_reports_identical(gw.stalls(idx), _fresh().stalls(idx))
    tel = gw.telemetry()
    assert tel["service"]["submits"] >= 1
    assert tel["fleet"]["workers"] == 2
    assert sorted(tel["fleet"]["live"]) == [0, 1]
    assert tel["tenants"]["default"]["admitted"] == 2
    assert gw.workloads == sharded.workloads and gw.space is sharded.space
    gw.close()
    sharded.close()


def _scripted_service(base):
    """An EvalService of package `base` whose queue the test drives: a
    submit queues its rows, a tick serves up to `per_tick` rows (whole
    requests, first come first served) and moves the clock by `dt`."""

    class _Svc(base):
        def __init__(self, clock, per_tick, dt):
            self.clock, self.per_tick, self.dt = clock, per_tick, dt
            self.queue = []
            self.evaluator = None

        def submit(self, request, *, client="", tier="batch",
                   deadline_s=None):
            fut = Future()
            self.queue.append((np.atleast_2d(request.idx).shape[0], fut))
            return fut

        def queued_rows(self):
            return sum(n for n, _ in self.queue)

        def tick(self):
            rows = 0
            while self.queue and rows + self.queue[0][0] <= self.per_tick:
                n, fut = self.queue.pop(0)
                fut.set_result(None)
                rows += n
            self.clock[0] += self.dt
            return rows

        def telemetry(self):
            return {"queued_rows": self.queued_rows()}

    return _Svc


def test_gateway_admission_equals_the_reference():
    """One scripted request stream (seeded tenants, sizes, ticks and
    clock jumps) against the reference's and the port's Gateway: the same
    admit/reject for every request, the same retry_after_s to the bit,
    the same tenant ledgers and admission telemetry."""
    rng = np.random.default_rng(23)
    steps = [(int(rng.integers(0, 4)), int(rng.integers(1, 7)),
              float(rng.choice([0.0, 0.0, 0.0, 0.7, 11.0])))
             for _ in range(120)]
    idx = _ids(18, 8)
    outcomes = {}
    for name, gw_cls, svc_cls, req_cls, retry_cls in (
            ("port", Gateway, EvalService, EvalRequest, RetryAfter),
            ("ref", JGateway, JEvalService, JEvalRequest, JRetryAfter)):
        clock = [0.0]
        svc = _scripted_service(svc_cls)(clock, per_tick=9, dt=0.125)
        gw = gw_cls(svc, rows_per_window=24, window_s=10.0,
                    tenants={"t1": 7}, max_queued_rows=14,
                    now=lambda: clock[0])
        seen = []
        for what, rows, jump in steps:
            clock[0] += jump
            if what == 3:
                seen.append(("tick", gw.tick()))
                continue
            try:
                gw.submit(req_cls(idx[:rows]), tenant=f"t{what}")
                seen.append(("ok", rows))
            except retry_cls as exc:
                seen.append(("retry", exc.retry_after_s, str(exc)))
        tel = gw.telemetry()
        outcomes[name] = (seen, tel["tenants"], tel["admission"])
    assert outcomes["port"] == outcomes["ref"]
    kinds = {s[0] for s in outcomes["port"][0]}
    assert kinds == {"ok", "retry", "tick"}     # every path was exercised
    hints = [s[1] for s in outcomes["port"][0] if s[0] == "retry"]
    assert len(set(hints)) > 3 and all(h > 0 for h in hints)


# --------------------------------------------------------- oracle store
def test_oracle_store_repeat_is_o1_load(tmp_path, monkeypatch):
    """The pieces the portfolio tests do not hold: a repeat loads the one
    artifact, and another sweep configuration is a fresh artifact."""
    from repro_torch.perfmodel.sweep import SweepEngine
    calls = {"n": 0}
    orig = SweepEngine.run

    def counting(self, *a, **kw):
        calls["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(SweepEngine, "run", counting)
    store = str(tmp_path / "oracle")
    base = get_evaluator("proxy", device="cpu")
    kw = dict(sweep_kwargs=dict(chunk_size=4_096), stop=6_000,
              oracle_store=store)
    r1 = OracleEvaluator(base, **kw).sweep_result()
    assert calls["n"] == 1 and len(os.listdir(store)) == 1
    r2 = OracleEvaluator(base, **kw).sweep_result()
    assert calls["n"] == 1                      # loaded, not re-swept
    assert np.array_equal(r1.pareto_ids, r2.pareto_ids)
    assert np.array_equal(r1.pareto_y, r2.pareto_y)
    OracleEvaluator(base, sweep_kwargs=dict(chunk_size=4_096), stop=5_000,
                    oracle_store=store).sweep_result()
    assert calls["n"] == 2 and len(os.listdir(store)) == 2


def test_sweep_result_save_load_guards(tmp_path):
    from repro_torch.perfmodel.sweep import (SweepEngine, load_sweep_result,
                                             save_sweep_result)
    res = SweepEngine(get_evaluator("proxy", device="cpu"),
                      chunk_size=4_096).run(0, 3_000)
    path = save_sweep_result(str(tmp_path / "art.npz"), res, key="k1")
    back = load_sweep_result(path, key="k1")
    assert np.array_equal(back.pareto_y, res.pareto_y)
    assert np.array_equal(back.topk_val, res.topk_val)
    with pytest.raises(ValueError, match="key"):
        load_sweep_result(path, key="some-other-study")
    with pytest.raises(FileNotFoundError):
        load_sweep_result(str(tmp_path / "missing.npz"))


# ------------------------------------------------------------ the codec
def test_codec_value_roundtrip_restricted_types():
    """The binary codec round-trips exactly the frame vocabulary's types,
    arrays bit-identically across the dtype allowlist."""
    assert codec_mod.ALLOWED_DTYPES == j_codec.ALLOWED_DTYPES
    cases = [
        None, True, False, 0, -1, 2**40, -(2**70), 1.5, float("inf"),
        "héllo", b"\x00\xff raw", (1, "two", None), [1.0, [2, 3]],
        {"k": (1, 2), "nested": {"x": b"y"}}, (),
    ]
    for v in cases:
        assert codec_mod.decode_value(codec_mod.encode_value(v)) == v
    for dtype in sorted(codec_mod.ALLOWED_DTYPES):
        arr = (RNG.random((3, 4)) * 100).astype(dtype)
        back = codec_mod.decode_value(codec_mod.encode_value(arr))
        assert back.dtype == arr.dtype and np.array_equal(back, arr)
    arr = np.array([np.nan, 1.0, -np.inf])
    back = codec_mod.decode_value(codec_mod.encode_value(arr))
    assert arr.tobytes() == back.tobytes()


def test_codec_rejects_offschema():
    """Anything outside the schema is a typed CodecError, never an
    object — a torch tensor included."""
    with pytest.raises(codec_mod.CodecError, match="dtype"):
        codec_mod.encode_value(np.array([object()]))
    with pytest.raises(codec_mod.CodecError, match="keys"):
        codec_mod.encode_value({1: "x"})
    with pytest.raises(codec_mod.CodecError, match="not wire-encodable"):
        codec_mod.encode_value(Keyring(KEYS))
    with pytest.raises(codec_mod.CodecError, match="not wire-encodable"):
        codec_mod.encode_value(torch.zeros(3))
    with pytest.raises(codec_mod.CodecError, match="unknown value tag"):
        codec_mod.decode_value(b"Z")
    with pytest.raises(codec_mod.CodecError, match="truncated"):
        codec_mod.decode_value(codec_mod.encode_value("hello")[:-2])
    with pytest.raises(codec_mod.CodecError, match="trailing"):
        codec_mod.decode_value(codec_mod.encode_value(1) + b"junk")


def test_codec_bounds_nesting_depth():
    one = struct.pack(">I", 1)
    v = {"a": [({"b": [1]},)]}
    assert codec_mod.decode_value(codec_mod.encode_value(v)) == v
    for header in (b"L" + one, b"U" + one,
                   b"M" + one + struct.pack(">I", 1) + b"k"):
        hostile = header * (codec_mod.MAX_NESTING_DEPTH + 8) + b"N"
        with pytest.raises(codec_mod.CodecError, match="nesting deeper"):
            codec_mod.decode_value(hostile)


def _same(a, b) -> bool:
    """Deep equality that holds arrays to dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and np.isnan(a):
        return np.isnan(b)
    return a == b


def _random_value(rng, depth: int = 0):
    kinds = ["none", "bool", "int", "bigint", "float", "str", "bytes",
             "array"]
    if depth < 3:
        kinds += ["tuple", "list", "dict"] * 2
    k = kinds[int(rng.integers(len(kinds)))]
    if k == "none":
        return None
    if k == "bool":
        return bool(rng.integers(2))
    if k == "int":
        return int(rng.integers(-2**62, 2**62))
    if k == "bigint":
        return int(rng.integers(1, 2**62)) * 2**70 * int(rng.choice([-1, 1]))
    if k == "float":
        return float(rng.choice([rng.normal() * 1e6, np.inf, -np.inf,
                                 np.nan, 0.0, -0.0]))
    if k == "str":
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, 6))
    if k == "bytes":
        return rng.bytes(int(rng.integers(0, 12)))
    if k == "array":
        dtype = sorted(codec_mod.ALLOWED_DTYPES)[
            int(rng.integers(len(codec_mod.ALLOWED_DTYPES)))]
        shape = tuple(int(s) for s in rng.integers(0, 4,
                                                   int(rng.integers(0, 4))))
        return np.asarray(rng.normal(size=shape) * 100).astype(dtype)
    n = int(rng.integers(0, 4))
    items = [_random_value(rng, depth + 1) for _ in range(n)]
    if k == "tuple":
        return tuple(items)
    if k == "list":
        return items
    return {f"k{i}-{rng.integers(99)}": v for i, v in enumerate(items)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_value_bytes_equal_the_reference(seed):
    """Seeded nested values of every type the schema allows (arrays of
    every allowed dtype, big ints, NaN and signed zeros): the two codecs
    write the same bytes, and each decodes the other's to equal values."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        v = _random_value(rng)
        mine, theirs = codec_mod.encode_value(v), j_codec.encode_value(v)
        assert mine == theirs
        assert _same(codec_mod.decode_value(theirs), _as_decoded(v))
        assert _same(j_codec.decode_value(mine), _as_decoded(v))


def _as_decoded(v):
    """`v` as either codec returns it: a 0-d array rides the wire with
    shape (1,) (the encoder's ``np.ascontiguousarray`` is at least 1-D)."""
    if isinstance(v, np.ndarray):
        return v.reshape(1) if v.ndim == 0 else v
    if isinstance(v, (list, tuple)):
        return type(v)(_as_decoded(x) for x in v)
    if isinstance(v, dict):
        return {k: _as_decoded(x) for k, x in v.items()}
    return v


def test_codec_zero_d_arrays_ride_as_one_element():
    """A 0-d array encodes to the reference's bytes, which carry shape
    (1,): both packages decode it one-dimensional.  The port keeps the
    reference's bytes; no frame of the schema carries a 0-d array (ids
    are 2-D, report arrays 1-D or more)."""
    for dtype in sorted(codec_mod.ALLOWED_DTYPES):
        arr = np.asarray(3).astype(dtype)
        blob = codec_mod.encode_value(arr)
        assert blob == j_codec.encode_value(arr)
        for back in (codec_mod.decode_value(blob),
                     j_codec.decode_value(blob)):
            assert back.shape == (1,) and back.dtype == arr.dtype
            assert back[0] == arr


def _report_pair(detail: str = "stalls"):
    """A port PPAReport and the reference's, holding the same arrays."""
    rep = _fresh().evaluate(EvalRequest(_ids(19, 5), detail))
    j_rep = JPPAReport(workloads=rep.workloads, detail=rep.detail,
                       area=rep.area, latency=rep.latency, stall=rep.stall,
                       op_time=rep.op_time, op_class=rep.op_class,
                       op_names=rep.op_names)
    return rep, j_rep


_SPAN = {"name": "worker.eval", "trace_id": "t", "span_id": "s",
         "parent_id": None, "proc": "w:1", "thread": "serve-eval",
         "t_start": 0.1, "t_end": 0.2, "status": "ok", "attrs": {"rows": 5}}


def _message_pair(kind: str):
    """The same message built from each package's classes."""
    idx = _ids(20, 5)
    if kind == "Dispatch":
        return (wire.Dispatch(7, ShardPayload(idx, "stalls", ("a", "b")),
                              ("tid", "sid")),
                j_wire.Dispatch(7, JShardPayload(idx, "stalls", ("a", "b")),
                                ("tid", "sid")))
    if kind == "ResultMsg":
        rep, j_rep = _report_pair()
        return (wire.ResultMsg(7, rep, (_SPAN,)),
                j_wire.ResultMsg(7, j_rep, (_SPAN,)))
    args = {"Hello": (b"spec-bytes",), "Ready": ("digest", ("a", "b")),
            "ErrorMsg": (7, "boom", (), "quota.rows"), "Ping": (3,),
            "Pong": (3,), "Bye": ("done",),
            "Announce": (("10.0.0.7", 9707), ("d1", "d2"), 4),
            "LeaseAck": (2.5,)}[kind]
    return getattr(wire, kind)(*args), getattr(j_wire, kind)(*args)


@pytest.mark.parametrize("kind", list(codec_mod.MESSAGE_TYPES))
def test_codec_message_bytes_equal_the_reference(kind):
    """All ten message types with the same field values encode to the
    same bytes, and each side decodes the other's body; a ShardPayload or
    PPAReport body comes back as the decoder's own class, compared field
    by field.  A Hello here carries the same spec bytes on both sides:
    real specs differ by design (each names its own package's classes,
    so their digests differ too)."""
    assert codec_mod.MESSAGE_TYPES == j_codec.MESSAGE_TYPES
    msg, j_msg = _message_pair(kind)
    body = codec_mod.encode_msg(msg)
    assert body == j_codec.encode_msg(j_msg)
    mine, theirs = codec_mod.decode_msg(body), j_codec.decode_msg(body)
    assert type(mine) is type(msg) and type(theirs) is type(j_msg)
    if kind == "Dispatch":
        for got, cls in ((mine.payload, ShardPayload),
                         (theirs.payload, JShardPayload)):
            assert type(got) is cls
            assert np.array_equal(got.idx, msg.payload.idx)
            assert (got.detail, got.workloads) == ("stalls", ("a", "b"))
        assert mine.trace_ctx == theirs.trace_ctx == ("tid", "sid")
    elif kind == "ResultMsg":
        assert type(mine.report) is PPAReport
        assert type(theirs.report) is JPPAReport
        _assert_reports_identical(mine.report, msg.report)
        _assert_reports_identical(theirs.report, msg.report)
        assert mine.spans == theirs.spans == (_SPAN,)
    else:
        assert mine == msg and theirs == j_msg
    if kind == "Hello":
        spec, j_spec = _worker_spec(_fresh()), j_worker_spec(_j_fresh())
        assert spec != j_spec
        assert codec_mod.spec_digest(spec) != j_codec.spec_digest(j_spec)
        assert codec_mod.spec_digest(spec) == j_codec.spec_digest(spec)


@pytest.mark.parametrize("signed,key_id,binding", [
    (False, None, b""), (True, None, b""), (True, "k2", b""),
    (True, "k1", b"nonce-a" + b"nonce-b")])
def test_sealed_frames_equal_the_reference(signed, key_id, binding):
    """seal_frame with the same keyring, key id, sequence number and
    binding gives the same frame, and each side's open_frame takes the
    other's."""
    ring = _keyring() if signed else None
    j_ring = JKeyring(KEYS, active="k1") if signed else None
    body = codec_mod.encode_msg(wire.Dispatch(
        9, ShardPayload(_ids(21, 3), "objectives", None)))
    for seq in (0, 1, 41):
        frame = codec_mod.seal_frame(body, ring, seq, key_id,
                                     binding=binding)
        assert frame == j_codec.seal_frame(body, j_ring, seq, key_id,
                                           binding=binding)
        assert j_codec.open_frame(frame, j_ring, seq,
                                  binding=binding) == body
        assert codec_mod.open_frame(frame, ring, seq,
                                    binding=binding) == body
    nonce, frame = codec_mod.make_nonce_frame()
    assert j_codec.nonce_of(frame) == nonce == codec_mod.nonce_of(frame)


def test_codec_message_roundtrip_every_type():
    idx = _ids(22, 5)
    payload = ShardPayload(idx, "stalls", ("ttft", "tpot"))
    report = _fresh().evaluate(EvalRequest(idx, "stalls"))
    msgs = [wire.Hello(b"spec-bytes"), wire.Ready("digest", ("a", "b")),
            wire.Dispatch(7, payload, ("tid", "sid")),
            wire.ResultMsg(7, report, (_SPAN,)),
            wire.ErrorMsg(7, "boom", (), "quota.rows"),
            wire.ErrorMsg(-1, "fatal"),
            wire.Ping(3), wire.Pong(3), wire.Bye("done"),
            wire.Announce(("10.0.0.7", 9707), ("d1", "d2"), 4),
            wire.LeaseAck(2.5)]
    for msg in msgs:
        back = codec_mod.decode_msg(codec_mod.encode_msg(msg))
        assert type(back) is type(msg)
        if isinstance(msg, wire.Dispatch):
            assert back.seq == msg.seq and back.trace_ctx == msg.trace_ctx
            assert np.array_equal(back.payload.idx, payload.idx)
            assert back.payload.detail == payload.detail
            assert back.payload.workloads == payload.workloads
        elif isinstance(msg, wire.ResultMsg):
            _assert_reports_identical(back.report, report)
            assert back.spans == (_SPAN,)
        else:
            assert back == msg


def test_auth_sign_verify_rotation_and_rejects():
    ring = _keyring("k1")
    body = codec_mod.encode_msg(wire.Ping(1))
    for kid in ("k1", "k2"):
        frame = codec_mod.seal_frame(body, ring, seq=0, key_id=kid)
        assert codec_mod.open_frame(frame, ring, expected_seq=0) == body
    with pytest.raises(codec_mod.AuthError, match="unsigned"):
        codec_mod.open_frame(codec_mod.seal_frame(body, None, 0), ring, 0)
    other = Keyring({"k9": b"stranger"})
    with pytest.raises(codec_mod.AuthError, match="unknown_key"):
        codec_mod.open_frame(codec_mod.seal_frame(body, other, 0), ring, 0)
    frame = bytearray(codec_mod.seal_frame(body, ring, 0))
    frame[-1] ^= 0x01
    with pytest.raises(codec_mod.AuthError, match="tamper"):
        codec_mod.open_frame(bytes(frame), ring, 0)
    frame = codec_mod.seal_frame(body, ring, seq=0)
    assert codec_mod.open_frame(frame, ring, 0) == body
    with pytest.raises(codec_mod.AuthError, match="replay"):
        codec_mod.open_frame(frame, ring, 1)
    frame = codec_mod.seal_frame(body, ring, seq=0, binding=b"sess-A")
    assert codec_mod.open_frame(frame, ring, 0, binding=b"sess-A") == body
    with pytest.raises(codec_mod.AuthError, match="tamper"):
        codec_mod.open_frame(frame, ring, 0, binding=b"sess-B")
    with pytest.raises(codec_mod.AuthError, match="tamper"):
        codec_mod.open_frame(frame, ring, 0)


def test_restricted_loads_blocks_gadgets_allows_spec():
    """The allowlisted constructor table rebuilds the port's specs (the
    zoo suite's included) but refuses the reference's, torch's
    tensor-rebuild functions and pickle gadgets before construction."""
    spec = _worker_spec(_fresh())
    rebuilt = evaluator_from_spec(spec, loads=codec_mod.restricted_loads)
    idx = _ids(23, 6)
    _assert_reports_identical(
        rebuilt.evaluate(EvalRequest(idx, "objectives")),
        _fresh().evaluate(EvalRequest(idx, "objectives")))
    zoo = get_evaluator("proxy", suite="zoo", device="cpu")
    zoo_back = evaluator_from_spec(_worker_spec(zoo),
                                   loads=codec_mod.restricted_loads)
    assert zoo_back.workloads == zoo.workloads
    assert np.array_equal(zoo_back.objectives(idx), zoo.objectives(idx))
    # the reference package's classes are not this loader's
    with pytest.raises(codec_mod.CodecError, match="repro.perfmodel"):
        codec_mod.restricted_loads(j_worker_spec(_j_fresh()))
    # no tensor belongs in a spec: torch's rebuild functions refuse
    with pytest.raises(codec_mod.CodecError, match="torch"):
        codec_mod.restricted_loads(pickle.dumps(torch.zeros(2)))

    class Gadget:                       # classic reduce-to-call payload
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(codec_mod.CodecError, match="not allowlisted"):
        codec_mod.restricted_loads(pickle.dumps(Gadget()))
    with pytest.raises(codec_mod.CodecError, match="not allowlisted"):
        codec_mod.restricted_loads(pickle.dumps(pytest.raises))


def test_restricted_loads_blocks_module_attribute_traversal():
    """Hand-crafted pickles cannot laterally escape the allowlist: a port
    module's re-exported ``os`` resolves to a module and is refused, and
    ``builtins.getattr`` is not allowlisted at all."""
    def su(s):                       # SHORT_BINUNICODE opcode
        b = s.encode("utf-8")
        return b"\x8c" + bytes([len(b)]) + b

    PROTO, STACK_GLOBAL, STOP = b"\x80\x04", b"\x93", b"."
    TUPLE2, REDUCE = b"\x86", b"R"
    import repro_torch.runtime.fault as port_fault
    assert port_fault.os is os
    evil = (PROTO + su("repro_torch.runtime.fault") + su("os")
            + STACK_GLOBAL + STOP)
    with pytest.raises(codec_mod.CodecError, match="not a class"):
        codec_mod.restricted_loads(evil)
    evil = (PROTO
            + su("builtins") + su("getattr") + STACK_GLOBAL
            + su("repro_torch.runtime.fault") + su("os") + STACK_GLOBAL
            + su("system") + TUPLE2 + REDUCE
            + su("true") + b"\x85" + REDUCE
            + STOP)
    with pytest.raises(codec_mod.CodecError, match="not allowlisted"):
        codec_mod.restricted_loads(evil)
    with pytest.raises(codec_mod.CodecError, match="not allowlisted"):
        codec_mod.restricted_loads(pickle.dumps(getattr))


# ------------------------------------------------------- secure fabric
@pytest.mark.parametrize("tier", ["proxy", "target"])
def test_secure_socket_bit_identical_both_tiers(tier):
    """Acceptance: codec + HMAC end-to-end — a keyed 2-worker fleet is
    bit-identical to in-process on both fidelity tiers, with zero auth
    or quota noise."""
    s1 = WorkerServer(options=WorkerOptions(keys=KEYS))
    s2 = WorkerServer(options=WorkerOptions(keys=KEYS))
    s1.start()
    s2.start()
    ev = None
    try:
        idx = _ids(24, 23)
        local = _fresh(tier)
        ev = ShardedEvaluator(_fresh(tier), mode="socket",
                              addresses=_addrs((s1, s2)), keyring=_keyring())
        for detail in DETAILS:
            req = EvalRequest(idx, detail=detail)
            _assert_reports_identical(ev.evaluate(req), local.evaluate(req))
        assert s1.auth_rejected() == 0 and s2.auth_rejected() == 0
        assert ev.quota_rerouted == 0
    finally:
        if ev is not None:
            ev.close()
        s1.close()
        s2.close()


def test_secure_worker_refuses_legacy_pickle_and_unsigned():
    srv = WorkerServer(options=WorkerOptions(keys=KEYS))
    srv.start()
    try:
        with pytest.raises(RuntimeError, match="binary codec"):
            SocketPool(_fresh(), addresses=[(srv.host, srv.port)],
                       insecure=True)
        assert srv.auth_rejected("pickle_codec") == 1
        with pytest.raises(RuntimeError, match="no repro_torch.serve worker"):
            SocketPool(_fresh(), addresses=[(srv.host, srv.port)])
        assert _wait_for(lambda: srv.auth_rejected("unsigned") >= 1)
        assert srv.dispatches_served == 0
    finally:
        srv.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a worker with CUDA builds a cuda spec")
def test_cuda_spec_on_a_cpu_worker_is_refused(servers):
    """A spec naming cuda, sent to a worker without CUDA, is refused with
    a typed ErrorMsg naming CUDA: the pool raises WorkerFault and no
    evaluation — on the CPU or anywhere — comes back."""
    s1, _ = servers
    spec = pickle.loads(_worker_spec(_fresh()))
    spec["device"] = "cuda"
    blob = pickle.dumps(spec, protocol=pickle.HIGHEST_PROTOCOL)
    served = s1.dispatches_served
    with pytest.raises(WorkerFault, match="CUDA"):
        SocketPool(_fresh(), addresses=[(s1.host, s1.port)], spec=blob)
    sock = wire.connect((s1.host, s1.port))
    try:
        ch = codec_mod.Channel(sock)
        ch.send(wire.Hello(blob))
        reply = ch.recv()
        assert isinstance(reply, wire.ErrorMsg) and reply.seq == -1
        assert reply.code == "spec.build" and "CUDA" in reply.message
        with pytest.raises(wire.ConnectionClosed):
            ch.recv()                           # and the worker hangs up
    finally:
        sock.close()
    assert s1.dispatches_served == served
    # the refusal is per connection: the worker serves CPU specs on
    pool = SocketPool(_fresh(), addresses=[(s1.host, s1.port)])
    idx = _ids(25, 3)
    _assert_reports_identical(
        pool.submit(ShardPayload(idx, "objectives", None)).result(60),
        _fresh().evaluate(EvalRequest(idx, "objectives")))
    pool.close()


def test_insecure_flag_restores_legacy_pickle_mode():
    srv = WorkerServer(options=WorkerOptions(insecure=True))
    srv.start()
    ev = None
    try:
        idx = _ids(26, 8)
        ev = ShardedEvaluator(_fresh(), mode="socket",
                              addresses=[(srv.host, srv.port)],
                              insecure=True)
        _assert_reports_identical(
            ev.evaluate(EvalRequest(idx, "objectives")),
            _fresh().evaluate(EvalRequest(idx, "objectives")))
    finally:
        if ev is not None:
            ev.close()
        srv.close()


def test_wire_tamper_and_replay_counted_never_evaluated():
    srv = WorkerServer(options=WorkerOptions(keys=KEYS))
    srv.start()
    try:
        ring = _keyring()
        sock = wire.connect((srv.host, srv.port))
        ch = codec_mod.Channel(sock, keyring=ring)
        ch.client_handshake()
        ch.send(wire.Hello(_worker_spec(_fresh())))
        assert isinstance(ch.recv(), wire.Ready)
        dispatch = wire.Dispatch(0, ShardPayload(_ids(27, 2),
                                                 "objectives", None))
        frame = bytearray(codec_mod.seal_frame(
            codec_mod.encode_msg(dispatch), ring, seq=1,
            binding=ch.binding))
        frame[-3] ^= 0xFF                        # corrupt the body
        wire.send_frame(sock, bytes(frame))
        reply = ch.recv()
        assert isinstance(reply, wire.ErrorMsg) and reply.code == "auth.tamper"
        sock.close()
        assert _wait_for(lambda: srv.auth_rejected("tamper") >= 1)
        assert srv.auth_rejected("tamper") == 1
        sock = wire.connect((srv.host, srv.port))
        ch = codec_mod.Channel(sock, keyring=ring)
        ch.client_handshake()
        ch.send(wire.Hello(_worker_spec(_fresh())))
        assert isinstance(ch.recv(), wire.Ready)
        good = codec_mod.seal_frame(codec_mod.encode_msg(dispatch), ring,
                                    seq=1, binding=ch.binding)
        wire.send_frame(sock, good)
        assert isinstance(ch.recv(), wire.ResultMsg)  # the original lands
        assert srv.dispatches_served == 1        # counted before the answer
        wire.send_frame(sock, good)               # verbatim replay
        reply = ch.recv()
        assert isinstance(reply, wire.ErrorMsg) and reply.code == "auth.replay"
        sock.close()
        assert _wait_for(lambda: srv.auth_rejected("replay") >= 1)
        assert srv.auth_rejected("replay") == 1
        assert srv.dispatches_served == 1         # replay never evaluated
    finally:
        srv.close()


class _RecordingSocket:
    """Socket proxy that keeps a copy of every outbound chunk."""

    def __init__(self, sock):
        self._sock = sock
        self.sent = []

    def sendall(self, data):
        self.sent.append(bytes(data))
        self._sock.sendall(data)

    def recv(self, n):
        return self._sock.recv(n)

    def close(self):
        self._sock.close()


def test_recorded_session_replayed_on_new_connection_is_rejected():
    srv = WorkerServer(options=WorkerOptions(keys=KEYS))
    srv.start()
    try:
        ring = _keyring()
        rec = _RecordingSocket(wire.connect((srv.host, srv.port)))
        ch = codec_mod.Channel(rec, keyring=ring)
        ch.client_handshake()
        ch.send(wire.Hello(_worker_spec(_fresh())))
        assert isinstance(ch.recv(), wire.Ready)
        ch.send(wire.Dispatch(0, ShardPayload(_ids(28, 2),
                                              "objectives", None)))
        assert isinstance(ch.recv(), wire.ResultMsg)
        rec.close()
        assert srv.dispatches_served == 1        # counted before the answer
        replay_sock = wire.connect((srv.host, srv.port))
        for chunk in rec.sent:
            try:
                replay_sock.sendall(chunk)
            except OSError:
                break                 # server already dropped the replay
        assert _wait_for(lambda: srv.auth_rejected() >= 1)
        replay_sock.close()
        assert srv.auth_rejected("tamper") >= 1
        assert srv.dispatches_served == 1     # nothing re-evaluated
    finally:
        srv.close()


def test_signed_frames_without_session_handshake_are_rejected():
    srv = WorkerServer(options=WorkerOptions(keys=KEYS))
    srv.start()
    try:
        ring = _keyring()
        sock = wire.connect((srv.host, srv.port))
        body = codec_mod.encode_msg(wire.Hello(b"spec"))
        wire.send_frame(sock, codec_mod.seal_frame(body, ring, seq=0))
        assert _wait_for(lambda: srv.auth_rejected("replay") >= 1)
        sock.close()
        assert srv.auth_rejected("replay") == 1
        assert srv.dispatches_served == 0
    finally:
        srv.close()


def test_pickle_channel_serializes_concurrent_sends():
    a, b = socket_mod.socketpair()
    try:
        ch = codec_mod.Channel(a, codec=codec_mod.CODEC_PICKLE)
        peer = codec_mod.Channel(b, codec=codec_mod.CODEC_PICKLE)
        n_threads, per_thread = 8, 40
        pad = "x" * 4096
        got, errs = [], []

        def reader():
            try:
                for _ in range(n_threads * per_thread):
                    got.append(peer.recv().seq)
            except Exception as exc:     # noqa: BLE001 — test harness
                errs.append(exc)

        def blast(t):
            for i in range(per_thread):
                ch.send(wire.ErrorMsg(t * per_thread + i, pad))

        rt = threading.Thread(target=reader)
        rt.start()
        threads = [threading.Thread(target=blast, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rt.join(timeout=30)
        assert not errs and not rt.is_alive()
        assert sorted(got) == list(range(n_threads * per_thread))
    finally:
        a.close()
        b.close()


def test_worker_prunes_idle_peer_rate_buckets():
    clk = ManualClock()
    srv = WorkerServer(options=WorkerOptions(rate_limit=10.0), clock=clk)
    try:
        msg = wire.Dispatch(0, ShardPayload(_ids(29, 1), "objectives", None))
        for i in range(50):
            assert srv._check_quota(msg, f"10.0.0.{i}") is None
        assert len(srv._buckets) == 50
        clk.advance(60.0)
        assert srv._check_quota(msg, "10.1.0.1") is None
        assert set(srv._buckets) == {"10.1.0.1"}
        clk.advance(0.05)
        assert srv._check_quota(msg, "10.1.0.1") is None
        assert "10.1.0.1" in srv._buckets
    finally:
        srv.close()


def test_max_frame_bytes_oversized_dispatch_integration():
    srv = WorkerServer(options=WorkerOptions(keys=KEYS))
    srv.start()
    try:
        pool = SocketPool(_fresh(), addresses=[(srv.host, srv.port)],
                          keyring=_keyring(), max_frame_bytes=1 << 15)
        with pytest.raises(codec_mod.FrameTooLarge, match="frame bound"):
            pool.submit(ShardPayload(_ids(30, 3000), "objectives", None))
        idx = _ids(31, 4)
        rep = pool.submit(ShardPayload(idx, "objectives", None)) \
            .result(timeout=60)
        _assert_reports_identical(
            rep, _fresh().evaluate(EvalRequest(idx, "objectives")))
        assert pool.live_workers() == 1 and pool.reconnects == 0
        pool.close()
    finally:
        srv.close()


# ---------------------------------------------------------- worker quotas
def test_quota_rows_rerouted_not_hammered():
    tight = WorkerServer(options=WorkerOptions(
        keys=KEYS, max_rows_per_dispatch=4))
    open_ = WorkerServer(options=WorkerOptions(keys=KEYS))
    tight.start()
    open_.start()
    ev = None
    try:
        idx = _ids(32, 30)                      # 15-row shards: over quota
        ev = ShardedEvaluator(_fresh(), mode="socket",
                              addresses=_addrs((tight, open_)),
                              keyring=_keyring(), retries=1)
        rep = ev.evaluate(EvalRequest(idx, "stalls"))
        _assert_reports_identical(
            rep, _fresh().evaluate(EvalRequest(idx, "stalls")))
        assert tight.quota_rejected("rows") >= 1
        assert ev.quota_rerouted >= 1
        assert ev.retried == 0                  # reroute consumed NO budget
        assert sorted(ev.registry.snapshot()["live"]) == [0, 1]
    finally:
        if ev is not None:
            ev.close()
        tight.close()
        open_.close()


def test_quota_rate_limit_token_bucket():
    srv = WorkerServer(options=WorkerOptions(
        keys=KEYS, rate_limit=0.001, rate_burst=2))
    srv.start()
    try:
        pool = SocketPool(_fresh(), addresses=[(srv.host, srv.port)],
                          keyring=_keyring())
        payload = ShardPayload(_ids(33, 2), "objectives", None)
        futs = [pool.submit(payload) for _ in range(4)]
        outcomes = []
        for f in futs:
            try:
                f.result(timeout=60)
                outcomes.append("ok")
            except QuotaExceeded as exc:
                assert exc.code == "quota.rate"
                outcomes.append("quota")
        assert outcomes.count("ok") == 2        # the burst allowance
        assert outcomes.count("quota") == 2
        assert srv.quota_rejected("rate") == 2
        assert pool.quota_rejected == 2
        assert pool.live_workers() == 1
        pool.close()
    finally:
        srv.close()


def _outlast_the_deadline(monkeypatch, srv):
    """Make every evaluation on `srv` long by construction: it starts only
    once its dispatch's deadline answer is counted, whatever the host's
    speed (a real evaluation of a few ms can beat a 0.1 ms timer whose
    thread waits for the GIL)."""
    import repro_torch.distributed.sharded as sharded_mod
    evaluate = sharded_mod._eval_payload
    started = [0]

    def after_the_deadline(evaluator, payload):
        started[0] += 1
        assert _wait_for(lambda: srv.quota_rejected("deadline") >= started[0])
        return evaluate(evaluator, payload)

    monkeypatch.setattr(sharded_mod, "_eval_payload", after_the_deadline)


def test_quota_deadline_rejects_long_dispatch(monkeypatch):
    """A dispatch past the wall-clock deadline answers with
    quota.deadline (typed, counted) instead of hanging the client; the
    worker counts before it answers, so the count is there on arrival."""
    srv = WorkerServer(options=WorkerOptions(keys=KEYS, deadline_s=1e-4))
    srv.start()
    _outlast_the_deadline(monkeypatch, srv)
    try:
        pool = SocketPool(_fresh(), addresses=[(srv.host, srv.port)],
                          keyring=_keyring())
        fut = pool.submit(ShardPayload(_ids(34, 64), "stalls", None))
        with pytest.raises(QuotaExceeded, match="deadline"):
            fut.result(timeout=60)
        assert srv.quota_rejected("deadline") == 1
        assert pool.live_workers() == 1
        pool.close()
    finally:
        srv.close()


def test_quota_deadline_is_counted_before_the_answer(monkeypatch):
    """The ordering itself: read in the client's done-callback — run the
    moment the answer lands — the worker's count already includes it,
    five dispatches in a row, even with a count that takes 50 ms (a worker
    that answered first and counted second would show the old count)."""
    srv = WorkerServer(options=WorkerOptions(keys=KEYS, deadline_s=1e-4))
    srv.start()
    _outlast_the_deadline(monkeypatch, srv)
    inc = srv._c_quota_rejected.inc

    def slow_inc(*a, **kw):
        time.sleep(0.05)
        inc(*a, **kw)

    monkeypatch.setattr(srv._c_quota_rejected, "inc", slow_inc)
    try:
        pool = SocketPool(_fresh(), addresses=[(srv.host, srv.port)],
                          keyring=_keyring())
        seen = []
        for i in range(5):
            fut = pool.submit(ShardPayload(_ids(35 + i, 64), "stalls",
                                           None))
            fut.add_done_callback(
                lambda f: seen.append(srv.quota_rejected("deadline")))
            with pytest.raises(QuotaExceeded, match="deadline"):
                fut.result(timeout=60)
        assert seen == [1, 2, 3, 4, 5]
        pool.close()
    finally:
        srv.close()


def test_quota_concurrency_admission_is_checked_before_eval():
    srv = WorkerServer(options=WorkerOptions(max_concurrent_evals=1))
    payload = ShardPayload(_ids(40, 2), "objectives", None)
    d1, d2 = wire.Dispatch(0, payload), wire.Dispatch(1, payload)
    assert srv._check_quota(d1, "peer") is None
    kind, detail = srv._check_quota(d2, "peer")
    assert kind == "concurrency" and "max_concurrent_evals=1" in detail
    srv._eval_slots.release()
    assert srv._check_quota(d2, "peer") is None
    srv._eval_slots.release()
    srv.close()


# ------------------------------------------------------------------ TLS
def _make_tls_certs(tmp_path):
    if shutil.which("openssl") is None:
        pytest.skip("openssl CLI not available for test certs")
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj",
         "/CN=127.0.0.1"],
        check=True, capture_output=True)
    return cert, key


def test_tls_wrapped_socket_bit_identical(tmp_path):
    import ssl
    cert, key = _make_tls_certs(tmp_path)
    srv = WorkerServer(options=WorkerOptions(keys=KEYS, certfile=cert,
                                             keyfile=key))
    srv.start()
    ev = None
    try:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE         # self-signed test cert
        idx = _ids(41, 10)
        ev = ShardedEvaluator(_fresh(), mode="socket",
                              addresses=[(srv.host, srv.port)],
                              keyring=_keyring(), ssl_context=ctx)
        _assert_reports_identical(
            ev.evaluate(EvalRequest(idx, "stalls")),
            _fresh().evaluate(EvalRequest(idx, "stalls")))
    finally:
        if ev is not None:
            ev.close()
        srv.close()


# ------------------------------------------------- spawned processes
def test_worker_cli_serves_a_signed_client():
    """``python -m repro_torch.serve.worker --key id=secret`` prints its
    address and serves a keyed client bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.worker", "--port", "0",
         "--key", "k1=alpha-secret", "--key", "k2=beta-secret"],
        stdout=subprocess.PIPE, text=True, env=env)
    pool = None
    try:
        line = proc.stdout.readline()
        assert "listening on 127.0.0.1:" in line and "[signed]" in line
        port = int(line.split("127.0.0.1:")[1].split()[0])
        pool = SocketPool(_fresh(), addresses=[("127.0.0.1", port)],
                          keyring=_keyring())
        idx = _ids(42, 6)
        rep = pool.submit(ShardPayload(idx, "stalls", None)).result(120)
        _assert_reports_identical(
            rep, _fresh().evaluate(EvalRequest(idx, "stalls")))
    finally:
        if pool is not None:
            pool.close()
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()


def test_secure_fabric_survives_chaos_and_sigkill():
    """Acceptance: the full hardened stack (codec + HMAC, spawned worker
    processes) stays bit-identical through chaos crash/hang and a
    SIGKILL mid-stream."""
    opts = WorkerOptions(keys=KEYS)
    w1 = start_worker_process(options=opts)
    w2 = start_worker_process(options=opts)
    ev = None
    try:
        idx = _ids(43, 32)
        want = _fresh().evaluate(EvalRequest(idx, "stalls"))
        plan = FaultPlan([FaultEvent(0, 0, "crash"),
                          FaultEvent(1, 1, "hang")])
        clock = _LandedClock(step=0.1)
        ev = ShardedEvaluator(_fresh(), mode="socket",
                              addresses=[w1.address, w2.address],
                              keyring=_keyring(), fault_plan=plan,
                              shard_timeout_s=0.3, speculate=False,
                              elastic=True, clock=clock)
        clock.watch(ev)
        reports, errors = [], []

        def stream():
            try:
                for _ in range(12):
                    reports.append(ev.evaluate(EvalRequest(idx, "stalls")))
            except Exception as exc:            # noqa: BLE001 — reraised
                errors.append(exc)

        t = threading.Thread(target=stream)
        t.start()
        _wait_for(lambda: len(reports) >= 2 or not t.is_alive(), 120)
        w2.kill()                               # SIGKILL, no goodbye
        t.join(timeout=300)
        assert not t.is_alive()
        assert not errors, errors
        assert len(reports) == 12
        for rep in reports:
            _assert_reports_identical(rep, want)
        assert ev.registry.snapshot()["evictions"] >= 1
        assert len(plan) == 0
    finally:
        if ev is not None:
            ev.close()
        for w in (w1, w2):
            if w.alive():
                w.kill()
