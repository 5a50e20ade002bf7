"""The ``repro_torch.serve`` worker daemon: a remote evaluator over TCP.

Run one per card (or per host/core budget on a CPU fleet)::

    PYTHONPATH=src python -m repro_torch.serve.worker --port 9707 \\
        --key prod=0123abcd... --max-rows-per-dispatch 200000 \\
        --registrar gateway-host:9700

A worker starts *evaluator-agnostic*.  Each client connection opens with
a :class:`~repro_torch.serve.wire.Hello` carrying the pickled evaluator
spec (the process pool's template, see :func:`~repro_torch.distributed.
sharded._worker_spec`); the worker rebuilds the evaluator on the device
type the spec names — cached process-wide by spec digest, so reconnects
and sibling connections serving the same study skip the rebuild —
answers :class:`~repro_torch.serve.wire.Ready`, then serves
``Dispatch(ShardPayload) -> ResultMsg(PPAReport)`` until the client
hangs up.  A spec that cannot be built here (a ``cuda`` spec on a worker
without CUDA, say) is answered with ``ErrorMsg(code="spec.build")`` and
the connection closed: the client sees a
:class:`~repro_torch.distributed.faults.WorkerFault`, never an
evaluation on another device.

**Trust boundary**: the first frame of a connection picks the codec —
the schema-restricted binary codec (default, optionally HMAC-signed
under ``--key`` with replay-protected sequence numbers) or legacy
pickle, which is refused unless the worker runs ``--insecure``.
Secure-mode specs deserialize through the allowlisted constructor table
(:func:`repro_torch.serve.codec.restricted_loads`), optionally further
pinned to an out-of-band ``spec_digests`` allowlist.  Auth rejects are
counted (``worker_auth_rejected{reason}``), answered with a typed
``ErrorMsg(code="auth.*")`` best-effort, and never evaluated.

**Quotas**: ``max_rows_per_dispatch`` (shard size), a worker-wide
``max_concurrent_evals`` admission semaphore, a per-dispatch wall-clock
``deadline_s``, and a per-peer-host token-bucket ``rate_limit`` — all
enforced BEFORE the evaluation thread sees the payload, rejected with
``ErrorMsg(code="quota.*")`` that the client treats as
non-retryable-at-this-worker (reroute, don't hammer), and counted as
``worker_quota_rejected{kind}``.  Every answer is counted before it is
sent, so a client holding an answer always reads its count.

Evaluations run on a per-connection executor thread while the reader
thread keeps answering :class:`~repro_torch.serve.wire.Ping` heartbeats
— a worker grinding through a big shard still proves liveness, which is
what lets the client side distinguish *slow* from *dead*.

With ``--registrar host:port`` the worker dials the gateway's
:class:`~repro_torch.serve.membership.Registrar` and keeps a TTL lease
alive (announce → renew loop, Bye on shutdown) instead of waiting to be
found in a static address list.

:func:`start_worker_process` spawns a daemon in a child process (spawn
context: a forked child cannot use CUDA) and returns a handle with the
bound port — the test/bench/example harness for 2-worker loopback
clusters, and the thing to SIGKILL when proving fault tolerance.  On a
machine with a card it builds the ``ppa_eval`` library in the parent
first, so each child opens its own CUDA context and only loads it.
"""
from __future__ import annotations

import argparse
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.obs.metrics import Clock, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve import codec as _codec
from repro_torch.serve import wire

# evaluators by spec sha256 — shared across connections so a fleet
# serving one study builds once per process, not once per reconnect
_EVALUATORS: Dict[str, object] = {}
_EVALUATORS_LOCK = threading.Lock()


def _evaluator_for(spec: bytes, loads=None) -> Tuple[str, object]:
    digest = _codec.spec_digest(spec)
    with _EVALUATORS_LOCK:
        ev = _EVALUATORS.get(digest)
        if ev is None:
            from repro_torch.distributed.sharded import evaluator_from_spec
            ev = evaluator_from_spec(spec, loads=loads)
            _EVALUATORS[digest] = ev
    return digest, ev


class _TokenBucket:
    """Per-peer dispatch rate limiter: ``rate`` tokens/s, ``burst`` cap."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = self.burst
        self.stamp = now

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class WorkerOptions:
    """Everything a hardened worker enforces, bundled so the spawn
    harness and the CLI share one surface.  All fields picklable (the
    keyring travels as its raw ``keys`` mapping)."""
    keys: Optional[Dict[str, bytes]] = None       # HMAC keyring (id->secret)
    active_key: Optional[str] = None
    insecure: bool = False                        # accept legacy pickle codec
    max_frame_bytes: int = wire.MAX_MESSAGE_BYTES
    spec_digests: Tuple[str, ...] = ()            # out-of-band spec allowlist
    max_rows_per_dispatch: int = 0                # 0 = unlimited
    max_concurrent_evals: int = 0                 # 0 = unlimited
    deadline_s: float = 0.0                       # 0 = no deadline
    rate_limit: float = 0.0                       # dispatches/s/peer; 0 = off
    rate_burst: float = 0.0                       # 0 = 2x rate
    registrar: Optional[Tuple[str, int]] = None   # membership endpoint
    announce_interval_s: float = 0.0              # 0 = ttl/3 from LeaseAck
    capacity: int = 1                             # advisory, for Announce
    certfile: Optional[str] = None                # TLS server cert (PEM)
    keyfile: Optional[str] = None                 # TLS private key (PEM)

    def keyring(self) -> Optional[_codec.Keyring]:
        if not self.keys:
            return None
        return _codec.Keyring(self.keys, active=self.active_key)


class WorkerServer:
    """Accepts connections on ``host:port`` (``port=0`` = ephemeral) and
    serves the wire protocol; one reader thread + one eval thread per
    connection, quotas enforced on the reader.  ``sock`` hands it a
    socket already bound and listening (the spawn harness's), in place
    of ``host:port``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 options: Optional[WorkerOptions] = None,
                 max_message_bytes: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Clock] = None,
                 sock: Optional[socket.socket] = None):
        self.options = options if options is not None else WorkerOptions()
        self.max_frame_bytes = int(
            max_message_bytes if max_message_bytes is not None
            else self.options.max_frame_bytes)
        self.keyring = self.options.keyring()
        self.insecure = bool(self.options.insecure)
        self._ssl_context = None
        if self.options.certfile:
            import ssl
            self._ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_context.load_cert_chain(self.options.certfile,
                                              self.options.keyfile)
        self._sock = sock if sock is not None else _listen(host, port)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = threading.Event()
        self._clock: Clock = clock if clock is not None else time.monotonic
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._c_connections = self.metrics.counter(
            "worker_connections_served", "client connections accepted")
        self._c_dispatches = self.metrics.counter(
            "worker_dispatches_served", "shard dispatches answered OK")
        self._c_auth_rejected = self.metrics.counter(
            "worker_auth_rejected", "frames/connections rejected by "
            "authentication", labelnames=("reason",))
        self._c_quota_rejected = self.metrics.counter(
            "worker_quota_rejected", "dispatches rejected by quota",
            labelnames=("kind",))
        self._h_eval = self.metrics.histogram(
            "worker_eval_s", "per-dispatch evaluation wall time (s)")
        # worker-wide eval admission (across connections)
        self._eval_slots = (
            threading.BoundedSemaphore(self.options.max_concurrent_evals)
            if self.options.max_concurrent_evals > 0 else None)
        self._buckets: Dict[str, _TokenBucket] = {}
        self._buckets_lock = threading.Lock()
        self._announcer: Optional[_Announcer] = None
        # Perfetto process lane for spans minted on this worker
        self._proc = f"worker:{self.host}:{self.port}"

    @property
    def connections_served(self) -> int:
        return int(self._c_connections.value())

    @property
    def dispatches_served(self) -> int:
        return int(self._c_dispatches.value())

    def auth_rejected(self, reason: Optional[str] = None) -> int:
        c = self._c_auth_rejected
        return int(c.value(reason=reason) if reason is not None
                   else c.total())

    def quota_rejected(self, kind: Optional[str] = None) -> int:
        c = self._c_quota_rejected
        return int(c.value(kind=kind) if kind is not None else c.total())

    # -- accept loop ----------------------------------------------------
    def serve_forever(self) -> None:
        if self.options.registrar is not None:
            self._announcer = _Announcer(self)
            self._announcer.start()
        try:
            while not self._closed.is_set():
                try:
                    conn, _addr = self._sock.accept()
                except OSError:
                    break                        # listener closed
                self._c_connections.inc()
                t = threading.Thread(target=self._serve_conn, args=(conn,),
                                     name="serve-conn", daemon=True)
                t.start()
        finally:
            self.close()

    def start(self) -> threading.Thread:
        """Run the accept loop on a background thread (in-process use)."""
        t = threading.Thread(target=self.serve_forever,
                             name="serve-accept", daemon=True)
        t.start()
        return t

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            if self._announcer is not None:
                self._announcer.stop()
            try:
                self._sock.close()
            except OSError:
                pass

    # -- quota checks (reader thread, before the eval lane) --------------
    def _check_quota(self, msg: wire.Dispatch,
                     peer: str) -> Optional[Tuple[str, str]]:
        """None when admitted, else ``(kind, detail)`` for the reject."""
        o = self.options
        if o.rate_limit > 0:
            now = self._clock()
            with self._buckets_lock:
                # evict buckets idle long enough to have fully refilled —
                # indistinguishable from fresh ones, so dropping them is
                # lossless and the dict stays bounded by ACTIVE peers
                # instead of growing one entry per client IP forever
                stale = [p for p, b in self._buckets.items()
                         if p != peer and (now - b.stamp) * b.rate >= b.burst]
                for p in stale:
                    del self._buckets[p]
                bucket = self._buckets.get(peer)
                if bucket is None:
                    burst = o.rate_burst if o.rate_burst > 0 \
                        else max(1.0, 2.0 * o.rate_limit)
                    bucket = _TokenBucket(o.rate_limit, burst, now)
                    self._buckets[peer] = bucket
                admitted = bucket.try_take(now)
            if not admitted:
                return ("rate", f"peer {peer} above "
                        f"{o.rate_limit:g} dispatches/s")
        if o.max_rows_per_dispatch > 0:
            idx = getattr(msg.payload, "idx", None)
            rows = int(idx.shape[0]) if hasattr(idx, "shape") else 0
            if rows > o.max_rows_per_dispatch:
                return ("rows", f"shard of {rows} rows exceeds "
                        f"max_rows_per_dispatch={o.max_rows_per_dispatch}")
        if self._eval_slots is not None:
            if not self._eval_slots.acquire(blocking=False):
                return ("concurrency", f"worker at max_concurrent_evals="
                        f"{o.max_concurrent_evals}")
        return None

    # -- per-connection protocol ----------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            peer = conn.getpeername()[0]
        except OSError:
            peer = "?"
        if self._ssl_context is not None:
            try:
                conn = self._ssl_context.wrap_socket(conn, server_side=True)
            except (OSError, ValueError):
                conn.close()                     # failed TLS handshake
                return
        ch: Optional[_codec.Channel] = None
        # one eval lane per connection: dispatches execute in order while
        # the reader loop stays free to answer heartbeats
        ex = ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="serve-eval")

        def reply(msg: object) -> None:
            ch.send(msg)

        def run_dispatch(evaluator, msg: wire.Dispatch,
                         holds_slot: bool) -> None:
            ctx = getattr(msg, "trace_ctx", None)
            tracer = (Tracer(clock=self._clock, proc=self._proc)
                      if ctx is not None else None)

            def shipped_spans() -> Tuple:
                if tracer is None:
                    return ()
                return tuple(s.as_dict() for s in tracer.drain())

            # exactly one answer per dispatch: the deadline timer and the
            # eval thread race for it under this lock.  The winner counts
            # BEFORE it sends, so a client that has the answer in hand
            # always reads its count (counting after the send let a fast
            # client read the old value)
            answered = threading.Lock()
            done = [False]

            def answer(msg_out: object, count) -> bool:
                with answered:
                    if done[0]:
                        return False
                    done[0] = True
                if count is not None:
                    count()
                try:
                    reply(msg_out)
                except (OSError, wire.WireError):
                    pass                    # client already gone
                return True

            timer: Optional[threading.Timer] = None
            if self.options.deadline_s > 0:
                def expire() -> None:
                    answer(wire.ErrorMsg(
                        msg.seq, f"dispatch exceeded the "
                        f"{self.options.deadline_s:g}s deadline",
                        (), "quota.deadline"),
                        lambda: self._c_quota_rejected.inc(kind="deadline"))
                timer = threading.Timer(self.options.deadline_s, expire)
                timer.daemon = True
                timer.start()
            try:
                from repro_torch.distributed.sharded import _eval_payload
                t0 = self._clock()
                if tracer is not None:
                    idx = getattr(msg.payload, "idx", None)
                    rows = int(idx.shape[0]) if hasattr(idx, "shape") else 0
                    with tracer.span("worker.eval", parent=tuple(ctx),
                                     seq=msg.seq, rows=rows):
                        rep = _eval_payload(evaluator, msg.payload)
                else:
                    rep = _eval_payload(evaluator, msg.payload)
                self._h_eval.observe(self._clock() - t0)
                answer(wire.ResultMsg(msg.seq, rep, shipped_spans()),
                       self._c_dispatches.inc)
            except Exception as exc:        # noqa: BLE001 — wire boundary
                answer(wire.ErrorMsg(msg.seq, f"{type(exc).__name__}: "
                                              f"{exc}", shipped_spans()),
                       None)
            finally:
                if timer is not None:
                    timer.cancel()
                if holds_slot:
                    self._eval_slots.release()

        try:
            first = wire.recv_frame(conn, self.max_frame_bytes)
            mode = _codec.sniff_codec(first)
            if mode == _codec.CODEC_PICKLE and not self.insecure:
                # a legacy client dialed a hardened worker: typed refusal
                # over ITS codec (sending pickle is safe; loading is not)
                self._c_auth_rejected.inc(reason="pickle_codec")
                try:
                    wire.send_msg(conn, wire.ErrorMsg(
                        -1, "this worker requires the binary codec "
                        "(legacy pickle needs --insecure)", (),
                        "auth.codec"))
                except OSError:
                    pass
                return
            ch = _codec.Channel(
                conn, codec=mode,
                keyring=self.keyring if mode == _codec.CODEC_BINARY
                else None,
                max_frame_bytes=self.max_frame_bytes)
            if mode == _codec.CODEC_BINARY and _codec.is_nonce_frame(first):
                ch.server_handshake(first)
                hello = wire.check_hello(ch.recv())
            else:
                hello = wire.check_hello(ch.feed(first))
            digest = _codec.spec_digest(hello.spec)
            if self.options.spec_digests and \
                    digest not in self.options.spec_digests:
                self._c_auth_rejected.inc(reason="spec_digest")
                reply(wire.ErrorMsg(-1, f"spec digest {digest[:12]}… is "
                                    "not in this worker's allowlist", (),
                                    "auth.spec_digest"))
                return
            loads = (_codec.legacy_loads if self.insecure
                     else _codec.restricted_loads)
            try:
                digest, evaluator = _evaluator_for(hello.spec, loads)
            except _codec.CodecError:
                raise                   # an off-allowlist spec: below
            except Exception as exc:    # noqa: BLE001 — wire boundary
                # the spec names something this worker cannot build (a
                # cuda evaluator without CUDA): refuse the connection,
                # never serve it on another device
                reply(wire.ErrorMsg(-1, f"evaluator build failed: "
                                        f"{type(exc).__name__}: {exc}", (),
                                    "spec.build"))
                return
            if self._announcer is not None:
                self._announcer.add_digest(digest)
            reply(wire.Ready(digest, tuple(evaluator.workloads)))
            while True:
                msg = ch.recv()
                if isinstance(msg, wire.Dispatch):
                    verdict = self._check_quota(msg, peer)
                    if verdict is not None:
                        kind, detail = verdict
                        self._c_quota_rejected.inc(kind=kind)
                        reply(wire.ErrorMsg(msg.seq, detail, (),
                                            f"quota.{kind}"))
                        continue
                    ex.submit(run_dispatch, evaluator, msg,
                              self._eval_slots is not None)
                elif isinstance(msg, wire.Ping):
                    reply(wire.Pong(msg.seq))
                elif isinstance(msg, wire.Bye):
                    break
                else:
                    raise wire.WireError(
                        f"unexpected message {type(msg).__name__}")
        except _codec.AuthError as exc:
            # tampered / replayed / unsigned / unknown-key traffic: count,
            # answer with a typed refusal, drop the connection — the frame
            # is NEVER decoded, let alone evaluated
            self._c_auth_rejected.inc(reason=exc.reason)
            if ch is not None:
                try:
                    ch.send(wire.ErrorMsg(-1, str(exc), (),
                                          f"auth.{exc.reason}"))
                except (OSError, wire.WireError):
                    pass
        except wire.ConnectionClosed:
            pass                                # normal client departure
        except (wire.WireError, OSError) as exc:
            if ch is not None:
                try:
                    ch.send(wire.ErrorMsg(-1, str(exc)))
                except (OSError, wire.WireError):
                    pass
        finally:
            ex.shutdown(wait=False)
            try:
                conn.close()
            except OSError:
                pass


class _Announcer(threading.Thread):
    """Keeps this worker's membership lease alive: dial the registrar,
    Announce, renew every ``interval`` (default TTL/3 from the ack),
    redial with backoff on failure, Bye on shutdown."""

    def __init__(self, server: WorkerServer):
        super().__init__(name="worker-announcer", daemon=True)
        self.server = server
        self._stop = threading.Event()
        self._digests: Tuple[str, ...] = tuple(server.options.spec_digests)
        self._lock = threading.Lock()
        self._ch: Optional[_codec.Channel] = None

    def add_digest(self, digest: str) -> None:
        with self._lock:
            if digest not in self._digests:
                self._digests = self._digests + (digest,)

    def stop(self) -> None:
        self._stop.set()
        ch = self._ch
        if ch is not None:
            try:
                ch.send(wire.Bye("worker shutdown"))
            except (OSError, wire.WireError):
                pass
            try:
                ch.sock.close()
            except OSError:
                pass

    def _announce_once(self) -> float:
        o = self.server.options
        if self._ch is None:
            sock = wire.connect(o.registrar, timeout_s=5.0)
            self._ch = _codec.Channel(sock, keyring=self.server.keyring,
                                      max_frame_bytes=1 << 20)
            self._ch.client_handshake()
        with self._lock:
            digests = self._digests
        self._ch.send(wire.Announce((self.server.host, self.server.port),
                                    digests, o.capacity))
        ack = self._ch.recv()
        if not isinstance(ack, wire.LeaseAck):
            raise wire.WireError(f"expected LeaseAck, got "
                                 f"{type(ack).__name__}")
        return float(ack.ttl_s)

    def run(self) -> None:
        o = self.server.options
        interval = o.announce_interval_s
        while not self._stop.is_set():
            try:
                ttl = self._announce_once()
                if o.announce_interval_s <= 0:
                    interval = max(0.05, ttl / 3.0)
            except (OSError, wire.WireError, _codec.AuthError):
                ch, self._ch = self._ch, None
                if ch is not None:
                    try:
                        ch.sock.close()
                    except OSError:
                        pass
                interval = max(0.1, interval or 0.5)
            self._stop.wait(interval or 0.5)


# ---------------------------------------------------------------------------
# process harness
# ---------------------------------------------------------------------------

def _listen(host: str, port: int) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(16)
    return sock


def _spawned_main(sock: socket.socket,
                  options: Optional[WorkerOptions] = None) -> None:
    WorkerServer(sock=sock, options=options).serve_forever()


@dataclass
class WorkerHandle:
    """A spawned worker daemon: its process and bound address."""
    process: object                 # multiprocessing.Process
    host: str
    port: int
    address: Tuple[str, int] = field(init=False)

    def __post_init__(self):
        self.address = (self.host, self.port)

    def kill(self) -> None:
        """SIGKILL — the fault-tolerance test hammer: no cleanup, no
        goodbye, in-flight dispatches die with the process."""
        self.process.kill()
        self.process.join()

    def terminate(self) -> None:
        self.process.terminate()
        self.process.join()

    def alive(self) -> bool:
        return self.process.is_alive()


def start_worker_process(host: str = "127.0.0.1", port: int = 0, *,
                         options: Optional[WorkerOptions] = None
                         ) -> WorkerHandle:
    """Spawn a worker daemon in a child process and return its handle.

    The listening socket is bound here (``port=0`` picks an ephemeral
    port) and handed to the child with the spawn, so the address is known
    before the child runs and nothing is read back from it: connections
    wait in the socket's backlog until the child serves them (a client's
    handshake timeout covers its start-up), and a child that dies before
    serving resets them.  ``options`` configures auth/quotas/membership in
    the child.

    On a machine with a card the ``ppa_eval`` library is built here,
    before the spawn, so sibling workers started together each load the
    finished library (the build also renames its output into place
    atomically, so a loader never sees a partial one)."""
    import multiprocessing as mp

    import torch
    if torch.cuda.is_available():
        from repro_torch.kernels._build import build
        from repro_torch.kernels.ppa_eval import ops
        build([(ops.SOURCE, ops.FLAGS)])
    sock = _listen(host, port)
    try:
        bound = sock.getsockname()[:2]
        proc = mp.get_context("spawn").Process(
            target=_spawned_main, args=(sock, options), daemon=True)
        proc.start()
    finally:
        sock.close()                    # the child holds its own copy
    return WorkerHandle(process=proc, host=bound[0], port=bound[1])


def _parse_key(text: str) -> Tuple[str, bytes]:
    """``id=hex-or-text`` CLI key syntax."""
    if "=" not in text:
        raise argparse.ArgumentTypeError(
            f"--key wants id=secret, got {text!r}")
    kid, secret = text.split("=", 1)
    try:
        return kid, bytes.fromhex(secret)
    except ValueError:
        return kid, secret.encode("utf-8")


def _parse_addr(text: str) -> Tuple[str, int]:
    host, _, port = text.rpartition(":")
    return (host or "127.0.0.1", int(port))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.worker",
        description="repro_torch.serve evaluation worker daemon (the "
                    "evaluator and its device come from each client's spec)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (printed on startup)")
    ap.add_argument("--key", type=_parse_key, action="append", default=[],
                    metavar="ID=SECRET",
                    help="HMAC keyring entry (hex or raw text secret); "
                         "repeatable — first is the signing key")
    ap.add_argument("--insecure", action="store_true",
                    help="accept the legacy pickle codec "
                         "(single-trust-domain deployments only)")
    ap.add_argument("--max-frame-bytes", type=int,
                    default=wire.MAX_MESSAGE_BYTES)
    ap.add_argument("--spec-digest", action="append", default=[],
                    metavar="SHA256",
                    help="only serve specs with these digests (repeatable)")
    ap.add_argument("--max-rows-per-dispatch", type=int, default=0,
                    help="reject shards above this many rows (0 = off)")
    ap.add_argument("--max-concurrent-evals", type=int, default=0,
                    help="worker-wide concurrent evaluation cap (0 = off)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-dispatch wall-clock deadline (0 = off)")
    ap.add_argument("--rate-limit", type=float, default=0.0,
                    help="per-peer dispatches/second token bucket (0 = off)")
    ap.add_argument("--registrar", type=_parse_addr, default=None,
                    metavar="HOST:PORT",
                    help="announce to this membership registrar")
    ap.add_argument("--capacity", type=int, default=1,
                    help="advisory concurrent-eval capacity for Announce")
    ap.add_argument("--certfile", default=None, help="TLS server cert PEM")
    ap.add_argument("--keyfile", default=None, help="TLS private key PEM")
    args = ap.parse_args(argv)
    options = WorkerOptions(
        keys=dict(args.key) or None,
        active_key=args.key[0][0] if args.key else None,
        insecure=args.insecure,
        max_frame_bytes=args.max_frame_bytes,
        spec_digests=tuple(args.spec_digest),
        max_rows_per_dispatch=args.max_rows_per_dispatch,
        max_concurrent_evals=args.max_concurrent_evals,
        deadline_s=args.deadline_s,
        rate_limit=args.rate_limit,
        registrar=args.registrar,
        capacity=args.capacity,
        certfile=args.certfile,
        keyfile=args.keyfile)
    srv = WorkerServer(args.host, args.port, options=options)
    print(f"repro-serve-worker listening on {srv.host}:{srv.port}"
          + (" [signed]" if srv.keyring else "")
          + (" [insecure]" if srv.insecure else ""), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
