"""The port's worker membership (``repro_torch.serve.membership``) against
the reference's (``tests/test_membership.py``).

Every test of ``tests/test_membership.py`` has a counterpart here on the
port's types, under the same name.  Beside them: the lease table driven
through one seeded script of announces, withdrawals and clock moves on a
manual clock equals the reference's at every step (live set, version,
snapshot, counters), and the registrars of the two packages take each
other's signed announcements, since their frames are byte for byte the
same.  Waits poll a condition under a deadline of their own.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.obs.metrics import ManualClock as JManualClock
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.serve import Keyring as JKeyring
from repro.serve import MembershipView as JMembershipView
from repro.serve import Registrar as JRegistrar
from repro.serve import codec as j_codec
from repro.serve import wire as j_wire
from repro_torch.distributed import ShardedEvaluator
from repro_torch.obs.metrics import ManualClock, MetricsRegistry
from repro_torch.perfmodel import EvalRequest, ModelEvaluator, get_evaluator
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.serve import (Gateway, Keyring, MembershipView, Registrar,
                               RetryAfter, WorkerOptions, WorkerServer, wire)
from repro_torch.serve import codec as codec_mod

torch.set_num_threads(1)

KEYS = {"k1": b"membership-secret"}
COUNTERS = ("membership_joins", "membership_renewals",
            "membership_expirations", "membership_leaves")


def _ids(seed: int, n: int) -> np.ndarray:
    return SPACE.sample(np.random.default_rng(seed), n)


def _fresh(tier: str = "proxy") -> ModelEvaluator:
    return ModelEvaluator(get_evaluator(tier, device="cpu").models,
                          tier=tier, device="cpu")


def _assert_reports_identical(a, b):
    assert a.workloads == b.workloads and a.detail == b.detail
    assert np.array_equal(a.area, b.area)
    for w in a.workloads:
        assert np.array_equal(a.latency[w], b.latency[w])
        if a.detail == "stalls":
            assert np.array_equal(a.stall[w], b.stall[w])


def _wait_for(cond, timeout_s: float = 10.0) -> bool:
    """Poll `cond` until it holds or `timeout_s` passes; its last value."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return bool(cond())
        time.sleep(0.01)
    return True


# --------------------------------------------------------------- leases
def test_lease_lifecycle_on_manual_clock():
    """Join bumps the version; renewals do NOT; expiry and Bye do — and
    every transition lands in the membership counters."""
    clock = ManualClock()
    reg = MetricsRegistry()
    view = MembershipView(ttl_s=5.0, clock=clock, metrics=reg)
    assert view.live() == [] and view.version() == 0

    view.announce(("10.0.0.1", 7001), digests=("d1",), capacity=2)
    v_joined = view.version()
    assert view.live() == [("10.0.0.1", 7001)] and v_joined == 1
    assert reg.get("membership_joins").total() == 1
    assert reg.get("membership_live").value() == 1

    clock.advance(4.0)
    view.announce(("10.0.0.1", 7001), digests=("d1", "d2"))
    assert view.version() == v_joined
    assert reg.get("membership_renewals").total() == 1
    assert view.snapshot()["10.0.0.1:7001"]["digests"] == ["d1", "d2"]

    clock.advance(4.9)
    assert len(view) == 1
    clock.advance(0.2)
    assert view.live() == []
    assert view.version() == v_joined + 1
    assert reg.get("membership_expirations").total() == 1
    assert reg.get("membership_live").value() == 0

    view.announce(("10.0.0.2", 7002))
    assert view.remove(("10.0.0.2", 7002)) is True
    assert view.remove(("10.0.0.2", 7002)) is False
    assert reg.get("membership_leaves").total() == 1


def test_lease_snapshot_reports_ttl_remaining():
    clock = ManualClock()
    view = MembershipView(ttl_s=10.0, clock=clock)
    view.announce(("h", 1), capacity=3)
    clock.advance(4.0)
    snap = view.snapshot()["h:1"]
    assert snap["capacity"] == 3 and snap["renewals"] == 0
    assert snap["ttl_remaining_s"] == pytest.approx(6.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_lease_table_equals_the_reference(seed):
    """One seeded script of announces (joins and renewals), withdrawals
    and clock moves against both packages' views on manual clocks: the
    same live set, version, snapshot, gauge and counters at every step."""
    rng = np.random.default_rng(seed)
    clock, j_clock = ManualClock(), JManualClock()
    reg, j_reg = MetricsRegistry(), JMetricsRegistry()
    view = MembershipView(ttl_s=3.0, clock=clock, metrics=reg)
    j_view = JMembershipView(ttl_s=3.0, clock=j_clock, metrics=j_reg)
    hosts = [(f"10.0.0.{i}", 7000 + i) for i in range(5)]
    for _ in range(200):
        op = int(rng.integers(0, 4))
        addr = hosts[int(rng.integers(len(hosts)))]
        if op <= 1:
            digests = tuple(f"d{int(d)}" for d in rng.integers(0, 9, 2))
            cap = int(rng.integers(1, 5))
            assert view.announce(addr, digests, cap) == \
                j_view.announce(addr, digests, cap)
        elif op == 2:
            assert view.remove(addr) == j_view.remove(addr)
        else:
            dt = float(rng.choice([0.25, 1.0, 2.5]))
            clock.advance(dt)
            j_clock.advance(dt)
        assert view.live() == j_view.live()
        assert view.version() == j_view.version()
        assert view.snapshot() == j_view.snapshot()
        assert len(view) == len(j_view)
        for name in COUNTERS:
            assert reg.get(name).total() == j_reg.get(name).total()
        assert reg.get("membership_live").value() == \
            j_reg.get("membership_live").value()
    assert reg.get("membership_expirations").total() > 0
    assert reg.get("membership_leaves").total() > 0


# ------------------------------------------------------------ registrar
def test_registrar_grants_renews_and_withdraws_over_codec():
    ring = Keyring(KEYS)
    view = MembershipView(ttl_s=2.0)
    reg = Registrar(view, keyring=ring).start()
    try:
        sock = wire.connect(reg.address)
        ch = codec_mod.Channel(sock, keyring=ring)
        ch.client_handshake()
        ch.send(wire.Announce(("10.9.9.9", 4242), ("dig",), 2))
        ack = ch.recv()
        assert isinstance(ack, wire.LeaseAck)
        assert ack.ttl_s == pytest.approx(2.0)
        assert view.live() == [("10.9.9.9", 4242)]
        ch.send(wire.Announce(("10.9.9.9", 4242), ("dig",), 2))
        assert isinstance(ch.recv(), wire.LeaseAck)
        assert view.snapshot()["10.9.9.9:4242"]["renewals"] == 1
        ch.send(wire.Bye("draining"))
        sock.close()
        assert _wait_for(lambda: not view.live())
    finally:
        reg.close()


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_registrars_take_each_others_announcements(direction):
    """The frames are the same bytes, so a reference announcer leases a
    slot in the port's registrar and the other way round, signed."""
    if direction == "reference_to_port":
        view = MembershipView(ttl_s=2.0)
        reg = Registrar(view, keyring=Keyring(KEYS)).start()
        cw, cc, ring = j_wire, j_codec, JKeyring(KEYS)
    else:
        view = JMembershipView(ttl_s=2.0)
        reg = JRegistrar(view, keyring=JKeyring(KEYS)).start()
        cw, cc, ring = wire, codec_mod, Keyring(KEYS)
    try:
        sock = cw.connect(reg.address)
        ch = cc.Channel(sock, keyring=ring)
        ch.client_handshake()
        ch.send(cw.Announce(("10.1.2.3", 5555), ("dig",), 3))
        ack = ch.recv()
        assert type(ack).__name__ == "LeaseAck" and ack.ttl_s == 2.0
        assert view.live() == [("10.1.2.3", 5555)]
        assert view.snapshot()["10.1.2.3:5555"]["capacity"] == 3
        ch.send(cw.Bye("draining"))
        sock.close()
        assert _wait_for(lambda: not view.live())
        assert reg.auth_rejected == 0
    finally:
        reg.close()


def test_registrar_refuses_unauthenticated_announcers():
    ring = Keyring(KEYS)
    view = MembershipView()
    reg = Registrar(view, keyring=ring).start()
    try:
        sock = wire.connect(reg.address)
        ch = codec_mod.Channel(sock)            # no keyring: unsigned
        ch.send(wire.Announce(("evil", 666)))
        sock.close()
        assert _wait_for(lambda: reg.auth_rejected >= 1)
        assert reg.auth_rejected == 1
        assert view.live() == []

        sock = wire.connect(reg.address)
        wire.send_msg(sock, wire.Announce(("evil", 667)))   # legacy pickle
        sock.close()
        assert _wait_for(lambda: reg.auth_rejected >= 2)
        assert view.live() == []
    finally:
        reg.close()


def test_worker_announcer_joins_and_leaves_registrar():
    ring = Keyring(KEYS)
    view = MembershipView(ttl_s=2.0)
    reg = Registrar(view, keyring=ring).start()
    srv = WorkerServer(options=WorkerOptions(
        keys=KEYS, registrar=reg.address, announce_interval_s=0.1))
    srv.start()
    try:
        assert view.wait_for(1, timeout_s=10.0)
        assert view.live() == [(srv.host, srv.port)]
        key = f"{srv.host}:{srv.port}"
        assert _wait_for(lambda: view.snapshot().get(key, {}).get(
            "renewals", 0) >= 2)
    finally:
        srv.close()
        reg.close()
    assert _wait_for(lambda: not view.live())   # Bye beat the TTL


# ----------------------------------------------- membership-driven pool
def test_sharded_evaluator_follows_membership_churn():
    """Acceptance: lease expiry shrinks the fleet mid-stream and a
    rejoin grows it back — reports stay bit-identical throughout."""
    ring = Keyring(KEYS)
    view = MembershipView(ttl_s=1.0)
    reg = Registrar(view, keyring=ring).start()
    opts = WorkerOptions(keys=KEYS, registrar=reg.address,
                         announce_interval_s=0.1)
    s1 = WorkerServer(options=opts)
    s2 = WorkerServer(options=opts)
    s1.start()
    s2.start()
    ev = None
    try:
        assert view.wait_for(2, timeout_s=10.0)
        idx = _ids(1, 21)
        want = _fresh().evaluate(EvalRequest(idx, "stalls"))
        ev = ShardedEvaluator(_fresh(), mode="socket", membership=view,
                              keyring=ring)
        assert ev.workers == 2 and ev.membership is view
        _assert_reports_identical(ev.evaluate(EvalRequest(idx, "stalls")),
                                  want)

        s2.close()                              # silent death: TTL ages it out
        assert _wait_for(lambda: len(view) <= 1)
        assert view.live() == [(s1.host, s1.port)]
        _assert_reports_identical(ev.evaluate(EvalRequest(idx, "stalls")),
                                  want)
        assert ev.workers == 1

        s3 = WorkerServer(options=opts)         # rejoin on a fresh port
        s3.start()
        try:
            assert view.wait_for(2, timeout_s=10.0)
            _assert_reports_identical(
                ev.evaluate(EvalRequest(idx, "stalls")), want)
            assert ev.workers == 2
        finally:
            s3.close()
    finally:
        if ev is not None:
            ev.close()
        s1.close()
        s2.close()
        reg.close()


def test_gateway_telemetry_shows_membership_leases():
    ring = Keyring(KEYS)
    view = MembershipView(ttl_s=5.0)
    reg = Registrar(view, keyring=ring).start()
    srv = WorkerServer(options=WorkerOptions(
        keys=KEYS, registrar=reg.address, announce_interval_s=0.1,
        capacity=4))
    srv.start()
    gw = None
    try:
        assert view.wait_for(1, timeout_s=10.0)
        sharded = ShardedEvaluator(_fresh(), mode="socket", membership=view,
                                   keyring=ring)
        gw = Gateway(sharded)
        idx = _ids(2, 5)
        assert np.array_equal(gw.objectives(idx), _fresh().objectives(idx))
        key = f"{srv.host}:{srv.port}"
        # the Ready handshake hands the spec digest to the announcer,
        # which carries it on its NEXT renewal — wait that beat out
        assert _wait_for(lambda: gw.telemetry()["fleet"]["leases"].get(
            key, {}).get("digests"))
        leases = gw.telemetry()["fleet"]["leases"]
        assert leases[key]["capacity"] == 4
        assert leases[key]["ttl_remaining_s"] > 0
        assert leases[key]["digests"]
        snap = gw.snapshot()
        assert set(snap["metrics"]) == {"gateway", "service", "evaluator"}
        assert snap["telemetry"]["fleet"]["mode"] == "socket"
    finally:
        if gw is not None:
            gw.close()
        srv.close()
        reg.close()


def test_retry_after_hints_bounded_under_membership_churn():
    """Drain-ETA hints stay positive and bounded while workers join and
    leave under the gateway's queue — never negative, never unbounded."""
    ring = Keyring(KEYS)
    view = MembershipView(ttl_s=0.5)
    reg = Registrar(view, keyring=ring).start()
    opts = WorkerOptions(keys=KEYS, registrar=reg.address,
                         announce_interval_s=0.1)
    s1 = WorkerServer(options=opts)
    s1.start()
    gw = None
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            w = WorkerServer(options=opts)
            w.start()
            stop.wait(0.15)
            w.close()
            stop.wait(0.15)

    t = threading.Thread(target=churn, daemon=True)
    try:
        assert view.wait_for(1, timeout_s=10.0)
        sharded = ShardedEvaluator(_fresh(), mode="socket", membership=view,
                                   keyring=ring)
        gw = Gateway(sharded, max_queued_rows=3)
        t.start()
        idx = _ids(3, 40)
        hints = []
        for r in range(8):
            base = r * 5
            for i in range(3):
                gw.submit(EvalRequest(idx[base + i:base + i + 1]),
                          tenant=f"t{i}")
            with pytest.raises(RetryAfter) as ei:
                gw.submit(EvalRequest(idx[base + 3:base + 5]), tenant="late")
            hints.append(ei.value.retry_after_s)
            gw.tick()
        for h in hints:
            assert 0 < h <= 60.0, f"unbounded/negative drain ETA: {h}"
    finally:
        stop.set()
        t.join(timeout=10)
        if gw is not None:
            gw.close()
        s1.close()
        reg.close()
