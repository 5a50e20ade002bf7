"""Dynamic worker membership: TTL leases instead of a static address list.

``SocketPool(addresses=[...])`` hard-codes the fleet at
construction — fine for a loopback bench, wrong for a real cluster where
workers come and go.  This module inverts the direction of discovery:
**workers dial the gateway**, announce ``(address, spec digests,
capacity)`` to a :class:`Registrar`, and hold a lease that lapses unless
renewed by heartbeat.  The pool consumes a :class:`MembershipView` — a
live, versioned set of worker addresses — so join/leave events drive
the existing elastic-resize path, and
:meth:`~repro_torch.serve.gateway.Gateway.telemetry` can show *leases*, not
just sockets.

Lease semantics: an :class:`~repro_torch.serve.wire.Announce` frame (re)news
the lease for ``ttl_s``; a :class:`~repro_torch.serve.wire.Bye` removes it
immediately; a worker that crashes simply stops renewing and ages out
after ``ttl_s`` — no failure detector beyond the clock.  The view keeps
a monotonic **version** that bumps on every topology change (join,
leave, expiry — NOT renewals), which is what lets consumers sync in
O(1) on the common no-change path.

The registrar speaks the same framed codec as the dispatch plane
(:mod:`repro_torch.serve.codec`): announcements are HMAC-signed under the
shared keyring, so an unauthenticated host cannot register itself into
the fleet (or unregister someone else).  All instruments live in the
injected :class:`~repro_torch.obs.metrics.MetricsRegistry`:
``membership_joins`` / ``membership_renewals`` /
``membership_expirations`` / ``membership_leaves`` counters and the
``membership_live`` gauge.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import Clock, MetricsRegistry
from repro_torch.serve import codec as _codec
from repro_torch.serve import wire

DEFAULT_TTL_S = 5.0

Address = Tuple[str, int]


class Lease:
    """One worker's claim on fleet membership."""

    __slots__ = ("address", "digests", "capacity", "expires_at", "joined_at",
                 "renewals")

    def __init__(self, address: Address, digests: Tuple[str, ...],
                 capacity: int, now: float, ttl_s: float):
        self.address = address
        self.digests = digests
        self.capacity = capacity
        self.joined_at = now
        self.expires_at = now + ttl_s
        self.renewals = 0


class MembershipView:
    """Thread-safe lease table with lazy expiry.

    Expiry is swept on every read (``live``/``version``/``snapshot``)
    against the injected clock, so tests drive it with a
    :class:`~repro_torch.obs.metrics.ManualClock` and production needs no
    dedicated reaper thread — any consumer touching the view collects
    the garbage.
    """

    def __init__(self, *, ttl_s: float = DEFAULT_TTL_S,
                 clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.ttl_s = float(ttl_s)
        self.clock: Clock = clock if clock is not None else time.monotonic
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_joins = self.metrics.counter(
            "membership_joins", "workers granted a fresh lease")
        self._c_renewals = self.metrics.counter(
            "membership_renewals", "lease heartbeat renewals")
        self._c_expirations = self.metrics.counter(
            "membership_expirations", "leases lapsed past TTL")
        self._c_leaves = self.metrics.counter(
            "membership_leaves", "graceful lease withdrawals (Bye)")
        self._g_live = self.metrics.gauge(
            "membership_live", "workers currently holding a lease")
        self._lock = threading.Lock()
        self._leases: Dict[Address, Lease] = {}
        self._version = 0

    # -- writes ----------------------------------------------------------
    def announce(self, address: Address, digests: Tuple[str, ...] = (),
                 capacity: int = 1) -> float:
        """Grant or renew a lease; returns the TTL for the ack."""
        address = (str(address[0]), int(address[1]))
        now = self.clock()
        with self._lock:
            self._sweep(now)
            lease = self._leases.get(address)
            if lease is None:
                self._leases[address] = Lease(address, tuple(digests),
                                              int(capacity), now, self.ttl_s)
                self._version += 1
                self._c_joins.inc()
            else:
                lease.expires_at = now + self.ttl_s
                lease.digests = tuple(digests)
                lease.capacity = int(capacity)
                lease.renewals += 1
                self._c_renewals.inc()
            self._g_live.set(len(self._leases))
        return self.ttl_s

    def remove(self, address: Address) -> bool:
        """Graceful withdrawal (worker said Bye)."""
        address = (str(address[0]), int(address[1]))
        with self._lock:
            gone = self._leases.pop(address, None) is not None
            if gone:
                self._version += 1
                self._c_leaves.inc()
                self._g_live.set(len(self._leases))
        return gone

    def _sweep(self, now: float) -> None:
        # caller holds the lock
        dead = [a for a, l in self._leases.items() if l.expires_at <= now]
        for a in dead:
            del self._leases[a]
            self._version += 1
            self._c_expirations.inc()
        if dead:
            self._g_live.set(len(self._leases))

    # -- reads -----------------------------------------------------------
    def live(self) -> List[Address]:
        """Addresses currently under lease, sorted for deterministic slot
        assignment across consumers."""
        with self._lock:
            self._sweep(self.clock())
            return sorted(self._leases)

    def version(self) -> int:
        """Monotonic topology version: changes iff the live set changed."""
        with self._lock:
            self._sweep(self.clock())
            return self._version

    def __len__(self) -> int:
        return len(self.live())

    def snapshot(self) -> Dict[str, dict]:
        """Per-lease telemetry for the gateway fleet view."""
        with self._lock:
            now = self.clock()
            self._sweep(now)
            return {
                f"{a[0]}:{a[1]}": {
                    "capacity": l.capacity,
                    "digests": list(l.digests),
                    "renewals": l.renewals,
                    "ttl_remaining_s": max(0.0, l.expires_at - now),
                }
                for a, l in sorted(self._leases.items())
            }

    def wait_for(self, n: int, timeout_s: float = 10.0,
                 poll_s: float = 0.02) -> bool:
        """Block until at least ``n`` workers hold leases (real-clock
        convenience for construction paths and tests)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self.live()) >= n:
                return True
            time.sleep(poll_s)
        return len(self.live()) >= n


class Registrar:
    """The gateway-side TCP endpoint workers announce themselves to.

    Each worker holds one persistent connection; every
    :class:`~repro_torch.serve.wire.Announce` on it renews the lease and is
    acked with :class:`~repro_torch.serve.wire.LeaseAck`; a
    :class:`~repro_torch.serve.wire.Bye` withdraws immediately; a dead
    connection just stops renewing — the TTL does the rest.  Frames are
    authenticated exactly like the dispatch plane: with a ``keyring``,
    unsigned/tampered/replayed announcements are rejected (and counted
    as ``registrar_auth_rejected``); the legacy pickle codec is only
    accepted under ``insecure=True``.
    """

    def __init__(self, view: Optional[MembershipView] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 keyring: Optional[_codec.Keyring] = None,
                 insecure: bool = False,
                 ssl_context=None,
                 max_frame_bytes: int = 1 << 20,
                 metrics: Optional[MetricsRegistry] = None):
        self.view = view if view is not None else MembershipView(
            metrics=metrics)
        self.keyring = keyring
        self.insecure = bool(insecure)
        self.ssl_context = ssl_context
        self.max_frame_bytes = int(max_frame_bytes)
        self.metrics = (metrics if metrics is not None
                        else self.view.metrics)
        self._c_auth_rejected = self.metrics.counter(
            "registrar_auth_rejected",
            "announce frames rejected by authentication",
            labelnames=("reason",))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self.address: Address = (self.host, self.port)
        self._closed = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def auth_rejected(self) -> int:
        return int(self._c_auth_rejected.total())

    def start(self) -> "Registrar":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="registrar-accept", daemon=True)
        self._accept_thread.start()
        return self

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            try:
                self._sock.close()
            except OSError:
                pass

    # -- internals -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="registrar-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        announced: Optional[Address] = None
        try:
            if self.ssl_context is not None:
                conn = self.ssl_context.wrap_socket(conn, server_side=True)
            first = wire.recv_frame(conn, self.max_frame_bytes)
            mode = _codec.sniff_codec(first)
            if mode == _codec.CODEC_PICKLE and not self.insecure:
                self._c_auth_rejected.inc(reason="pickle_codec")
                return
            ch = _codec.Channel(
                conn, codec=mode,
                keyring=self.keyring if mode == _codec.CODEC_BINARY else None,
                max_frame_bytes=self.max_frame_bytes)
            if mode == _codec.CODEC_BINARY and _codec.is_nonce_frame(first):
                ch.server_handshake(first)
                msg = ch.recv()
            else:
                msg = ch.feed(first)
            while True:
                if isinstance(msg, wire.Announce):
                    announced = (str(msg.address[0]), int(msg.address[1]))
                    ttl = self.view.announce(announced, msg.digests,
                                             msg.capacity)
                    ch.send(wire.LeaseAck(ttl_s=ttl))
                elif isinstance(msg, wire.Bye):
                    if announced is not None:
                        self.view.remove(announced)
                        announced = None
                    break
                else:
                    raise wire.WireError(
                        f"unexpected {type(msg).__name__} on registrar")
                msg = ch.recv()
        except _codec.AuthError as exc:
            self._c_auth_rejected.inc(reason=exc.reason)
        except (wire.WireError, OSError):
            pass                  # dead connection: the TTL handles it
        finally:
            try:
                conn.close()
            except OSError:
                pass
