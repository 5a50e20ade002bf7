"""Length-prefixed wire framing + message vocabulary for ``repro_torch.serve``.

The process pool established the contract: a worker is anything
that can rebuild an evaluator from a pickled spec and answer
:class:`~repro_torch.distributed.sharded.ShardPayload` dispatches with
:class:`~repro_torch.perfmodel.evaluator.PPAReport` payloads.  This module
carries that contract over a TCP socket:

* **Framing** — every frame is an 8-byte big-endian length prefix
  followed by the frame bytes.  :func:`send_frame` / :func:`recv_frame`
  are the transport; ``recv_frame`` rejects frames above ``max_bytes``
  before reading them (a corrupt or hostile length prefix cannot OOM
  the receiver).  What's INSIDE the frame is the codec's business:
  :mod:`repro_torch.serve.codec` provides the default schema-restricted
  binary codec (optionally HMAC-signed, replay-protected) and the
  legacy pickle shim behind ``insecure=True``.
* **Messages** — ``Hello`` (the evaluator spec bytes: the handshake
  that turns a bare worker daemon into THIS evaluator's worker),
  ``Ready`` (spec digest ack), ``Dispatch``/``ResultMsg``/``ErrorMsg``
  (one shard request/response, correlated by ``seq`` so many dispatches
  ride one connection; ``ErrorMsg.code`` carries typed reject hints
  like ``quota.rows``), ``Ping``/``Pong`` (heartbeats answered while
  evaluations are in flight), ``Bye`` (graceful close), and the
  membership pair ``Announce``/``LeaseAck`` (workers leasing a slot in
  the gateway's registrar, see :mod:`repro_torch.serve.membership`).

Trust model: the binary codec + keyring makes the fabric safe to expose
beyond one trust domain (see README "Security model"); the legacy
pickle mode assumes the same trust domain as the process pool and
stays available only behind an explicit ``insecure=True``.

No tensor ever rides a frame: payloads and reports hold numpy arrays on
the host, so a worker evaluating on its card copies its results back
before it answers.
"""
from __future__ import annotations

import dataclasses
import socket
import ssl as _ssl
import struct
from typing import Optional, Tuple

WIRE_VERSION = 1

# 8-byte big-endian unsigned length prefix
_HEADER = struct.Struct(">Q")

# refuse frames above this before allocating (a flipped length bit cannot
# ask the receiver to materialize petabytes); endpoints can tighten it
# per-connection via ``max_frame_bytes``
MAX_MESSAGE_BYTES = 1 << 31


class WireError(RuntimeError):
    """Malformed traffic: bad frame, oversized message, version mismatch."""


class ConnectionClosed(WireError):
    """The peer closed (or was killed) mid-conversation."""


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hello:
    """Client handshake: the pickled evaluator spec this connection serves
    (the same bytes :func:`~repro_torch.distributed.sharded._worker_spec`
    feeds the process pool's initializer).  Secure-mode workers
    deserialize it through the allowlisted constructor table
    (:func:`repro_torch.serve.codec.restricted_loads`) and may additionally
    require its digest to be pre-approved."""
    spec: bytes
    wire_version: int = WIRE_VERSION


@dataclasses.dataclass(frozen=True)
class Ready:
    """Worker ack: the sha256 digest of the spec it (re)built, plus the
    workload names of the evaluator it is now serving."""
    digest: str
    workloads: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One shard request; ``seq`` correlates the eventual response.

    ``trace_ctx`` is an optional ``(trace_id, span_id)`` pair naming the
    client-side wire span: when present, the worker opens its evaluation
    span *under* it so the per-request causal tree crosses the machine
    boundary.  Old peers pickled this class without the field — always
    read it via ``getattr(msg, "trace_ctx", None)``.
    """
    seq: int
    payload: object                # ShardPayload (kept loose: wire is generic)
    trace_ctx: Optional[Tuple[str, str]] = None


@dataclasses.dataclass(frozen=True)
class ResultMsg:
    """One shard response.  ``spans`` carries the worker-side span dicts
    (empty when the dispatch was untraced); read via
    ``getattr(msg, "spans", ())`` for old-peer compatibility."""
    seq: int
    report: object                 # PPAReport
    spans: Tuple = ()


@dataclasses.dataclass(frozen=True)
class ErrorMsg:
    """One failed request (``seq >= 0``) or a connection-fatal protocol
    error (``seq < 0``).  ``code`` is a typed machine hint: empty for
    plain evaluation failures, ``quota.*`` for worker-side quota rejects
    (the client reroutes instead of retrying the same worker), ``auth.*``
    for authentication rejects.  Read via ``getattr(msg, "code", "")``
    for old-peer compatibility."""
    seq: int
    message: str
    spans: Tuple = ()
    code: str = ""


@dataclasses.dataclass(frozen=True)
class Ping:
    seq: int


@dataclasses.dataclass(frozen=True)
class Pong:
    seq: int


@dataclasses.dataclass(frozen=True)
class Bye:
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class Announce:
    """Worker -> registrar: lease (or renew) a membership slot.

    ``address`` is where the worker's dispatch port listens, ``digests``
    the spec digests it already serves (empty = will build anything its
    own allowlist accepts), ``capacity`` an advisory concurrent-eval
    count for placement."""
    address: Tuple[str, int]
    digests: Tuple[str, ...] = ()
    capacity: int = 1


@dataclasses.dataclass(frozen=True)
class LeaseAck:
    """Registrar -> worker: the lease is held for ``ttl_s`` more seconds;
    renew (re-Announce) before it lapses or the membership view drops
    the worker."""
    ttl_s: float


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, frame: bytes) -> None:
    """Length-prefix + send one raw frame (callers serialize per socket)."""
    sock.sendall(_HEADER.pack(len(frame)) + frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionClosed(f"peer closed after {len(buf)}/{n} bytes")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket,
               max_bytes: int = MAX_MESSAGE_BYTES) -> bytes:
    """Receive one raw frame (blocking; raises ConnectionClosed on EOF,
    WireError on an oversized frame)."""
    (n,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if n > max_bytes:
        raise WireError(f"frame of {n} bytes exceeds the {max_bytes}-byte "
                        "message bound")
    return _recv_exact(sock, n)


def send_msg(sock: socket.socket, msg: object) -> None:
    """LEGACY single-trust-domain path: frame + send one pickled message
    (callers serialize access per socket).  New code should speak through
    :class:`repro_torch.serve.codec.Channel` instead."""
    import pickle
    send_frame(sock, pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))


def recv_msg(sock: socket.socket,
             max_bytes: int = MAX_MESSAGE_BYTES) -> object:
    """LEGACY single-trust-domain path: receive one pickled message
    (deserialized through the codec module's sanctioned shim)."""
    from repro_torch.serve import codec
    return codec.legacy_loads(recv_frame(sock, max_bytes))


def check_hello(msg: object) -> Hello:
    """Validate the opening message of a connection."""
    if not isinstance(msg, Hello):
        raise WireError(f"expected Hello, got {type(msg).__name__}")
    if msg.wire_version != WIRE_VERSION:
        raise WireError(f"wire version mismatch: peer speaks "
                        f"v{msg.wire_version}, this build v{WIRE_VERSION}")
    return msg


def connect(address: Tuple[str, int], *,
            timeout_s: Optional[float] = 10.0,
            ssl_context: Optional[_ssl.SSLContext] = None) -> socket.socket:
    """TCP connect with TCP_NODELAY (small request/response frames should
    not wait on Nagle) and the timeout cleared after establishment.
    With ``ssl_context`` the socket is TLS-wrapped (the handshake runs
    under the connect timeout)."""
    sock = socket.create_connection(address, timeout=timeout_s)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if ssl_context is not None:
        sock = ssl_context.wrap_socket(sock, server_hostname=address[0])
    sock.settimeout(None)
    return sock
