"""Trusted wire codec for ``repro_torch.serve``: no pickle on the hot path.

A transport that pickles every frame is acceptable inside one trust
domain and arbitrary-code-execution-as-a-service outside it.  This module
replaces pickle with a **schema-restricted binary codec** plus optional
per-frame authentication, negotiated implicitly by the first frame of a
connection (codec frames open with a magic marker; pickle frames open
with the pickle opcode, accepted only when both sides opt into
``insecure=True``).

Three layers, all in this file so the trust boundary is one module:

* **Value encoding** — a tagged binary format for exactly the types the
  frame vocabulary needs: ``None``, bools, ints, floats, str, bytes,
  tuples/lists, str-keyed dicts, and numpy arrays from a dtype
  allowlist.  The decoder constructs *only* these types; there is no
  object/reduce/class machinery to smuggle code through.
* **Message schema** — :data:`MESSAGE_TYPES` maps the narrow frame
  vocabulary (``Hello``/``Ready``/``Dispatch``/``ResultMsg``/
  ``ErrorMsg``/``Ping``/``Pong``/``Bye`` plus the membership frames
  ``Announce``/``LeaseAck``) to explicit field schemas; payloads are
  limited to :class:`~repro_torch.distributed.sharded.ShardPayload` and
  :class:`~repro_torch.perfmodel.evaluator.PPAReport` structures, encoded
  field by field (bit-identical array round-trip: dtype + shape + raw
  C-order bytes).  Anything off-schema is a :class:`CodecError`, never
  an object.
* **Frame auth** — every codec frame can be HMAC-SHA256 signed with a
  shared-secret :class:`Keyring` (key id travels in the frame header,
  so keys rotate without downtime) and carries a monotonic
  per-connection, per-direction sequence number; keyed connections open
  with a session-nonce handshake whose pair of random nonces is folded
  into every frame MAC, so a recorded signed session cannot replay over
  a new connection.  A receiver with a keyring rejects unsigned frames,
  unknown key ids, bad MACs (``tamper``), out-of-order sequence numbers
  and signed frames outside a nonce-bound session (``replay``) — all as
  typed :class:`AuthError`\\ s, counted by the caller, **before** any
  payload decoding happens.

The evaluator *spec* (the process pool's pickled constructor template)
cannot ride the restricted codec as-is.  Two defenses replace blind
unpickling: :func:`restricted_loads` deserializes it through an
**allowlisted constructor table** (only ``repro_torch.*`` model/space
classes, numpy array reconstructors and a short list of builtins
resolve; everything else raises — the reference package's ``repro.*``
classes and torch's tensor-rebuild functions included, since no tensor
belongs in a spec), and workers can additionally pin an out-of-band
``spec_digests`` allowlist so only pre-approved studies rebuild at all.
:func:`legacy_loads` is the *only* raw ``pickle.loads`` on the serve
surface (the ``pickle-outside-codec`` lint rule enforces this) and is
reachable only behind ``insecure=True``.
"""
from __future__ import annotations

import hashlib
import hmac
import io
import os
import pickle
import struct
import threading
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.serve import wire

MAGIC = b"RSC1"                     # codec frame marker (pickle starts 0x80)
FLAG_SIGNED = 0x01
FLAG_NONCE = 0x02                   # session-nonce handshake frame
_MAC = hashlib.sha256
_MAC_BYTES = 32
NONCE_BYTES = 16

# containers deeper than this are hostile, not ours: the frame schema
# nests ~4 levels (message dict -> report dict -> array dict -> array)
MAX_NESTING_DEPTH = 64

_U8 = struct.Struct(">B")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")

# the only dtypes a frame may carry — everything the ShardPayload /
# PPAReport schema produces, nothing with object or void innards
ALLOWED_DTYPES = frozenset({
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64",
})


class CodecError(wire.WireError):
    """Off-schema traffic: unknown tag/type, bad dtype, truncated body."""


class AuthError(wire.WireError):
    """Frame authentication failed; ``reason`` is one of ``unsigned`` /
    ``unknown_key`` / ``tamper`` / ``replay``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"auth rejected ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


# ---------------------------------------------------------------------------
# restricted value encoding
# ---------------------------------------------------------------------------

# dtype-name caches keyed by the interned dtype object: v.dtype.name is
# a surprisingly expensive property, and this sits on the dispatch hot
# path for every array in every frame
_DTYPE_WIRE: Dict[object, bytes] = {}
_DTYPE_BY_NAME: Dict[str, np.dtype] = {n: np.dtype(n)
                                       for n in ALLOWED_DTYPES}


def _enc_value(v, out: List[bytes]) -> None:
    t = type(v)
    if t is str:
        b = v.encode("utf-8")
        out.append(b"S" + _U32.pack(len(b)) + b)
    elif v is None:
        out.append(b"N")
    elif v is True:
        out.append(b"T")
    elif v is False:
        out.append(b"F")
    elif t is int:
        if -(1 << 63) <= v < (1 << 63):
            out.append(b"I" + _I64.pack(v))
        else:
            s = str(v).encode("ascii")
            out.append(b"J" + _U32.pack(len(s)) + s)
    elif t is float:
        out.append(b"D" + _F64.pack(v))
    elif t is tuple:
        out.append(b"U" + _U32.pack(len(v)))
        for item in v:
            _enc_value(item, out)
    elif t is list:
        out.append(b"L" + _U32.pack(len(v)))
        for item in v:
            _enc_value(item, out)
    elif t is dict:
        out.append(b"M" + _U32.pack(len(v)))
        for k, item in v.items():
            if type(k) is not str:
                raise CodecError(f"dict keys must be str, got "
                                 f"{type(k).__name__}")
            kb = k.encode("utf-8")
            out.append(_U32.pack(len(kb)) + kb)
            _enc_value(item, out)
    elif isinstance(v, np.ndarray):
        dt = v.dtype
        header = _DTYPE_WIRE.get(dt)
        if header is None:
            name = dt.name
            if name not in ALLOWED_DTYPES:
                raise CodecError(f"dtype {name!r} is not wire-encodable")
            nb = name.encode("ascii")
            header = _U8.pack(len(nb)) + nb
            _DTYPE_WIRE[dt] = header
        arr = np.ascontiguousarray(v)
        out.append(b"A" + header + _U8.pack(arr.ndim))
        for d in arr.shape:
            out.append(_U64.pack(d))
        out.append(_U64.pack(arr.nbytes))
        out.append(arr.tobytes())
    elif isinstance(v, np.bool_):
        out.append(b"T" if bool(v) else b"F")
    elif isinstance(v, (int, np.integer)):
        v = int(v)
        if -(1 << 63) <= v < (1 << 63):
            out.append(b"I" + _I64.pack(v))
        else:
            s = str(v).encode("ascii")
            out.append(b"J" + _U32.pack(len(s)) + s)
    elif isinstance(v, (float, np.floating)):
        out.append(b"D" + _F64.pack(float(v)))
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out.append(b"B" + _U32.pack(len(b)) + b)
    else:
        raise CodecError(f"type {type(v).__name__} is not wire-encodable")


# tag bytes as ints (data[i] indexes to int in py3) for the decode switch
_T_N, _T_T, _T_F = ord("N"), ord("T"), ord("F")
_T_I, _T_J, _T_D = ord("I"), ord("J"), ord("D")
_T_S, _T_B = ord("S"), ord("B")
_T_U, _T_L, _T_M, _T_A = ord("U"), ord("L"), ord("M"), ord("A")


def _truncated(pos: int, data: bytes) -> CodecError:
    return CodecError(f"truncated frame body at offset {pos} "
                      f"(have {len(data)})")


def _dec_value(data: bytes, pos: int, depth: int = 0):
    """Decode one value at ``pos``; returns ``(value, next_pos)``.

    Flat ``(data, pos)`` recursion instead of a cursor object: this runs
    once per field of every frame, so method-call and slice overhead here
    is codec overhead on every dispatch.  Nesting is bounded at
    :data:`MAX_NESTING_DEPTH` so a hostile frame of stacked container
    headers raises :class:`CodecError`, never ``RecursionError`` (which
    would escape the typed except clauses of reader threads).
    """
    try:
        tag = data[pos]
    except IndexError:
        raise _truncated(pos, data) from None
    pos += 1
    try:
        if tag == _T_S:
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            end = pos + n
            if end > len(data):
                raise _truncated(pos, data)
            return data[pos:end].decode("utf-8"), end
        if tag == _T_I:
            return _I64.unpack_from(data, pos)[0], pos + 8
        if tag == _T_D:
            return _F64.unpack_from(data, pos)[0], pos + 8
        if tag == _T_N:
            return None, pos
        if tag == _T_T:
            return True, pos
        if tag == _T_F:
            return False, pos
        if tag == _T_U or tag == _T_L:
            if depth >= MAX_NESTING_DEPTH:
                raise CodecError(f"nesting deeper than {MAX_NESTING_DEPTH} "
                                 "levels")
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            items = []
            append = items.append
            for _ in range(n):
                v, pos = _dec_value(data, pos, depth + 1)
                append(v)
            return (tuple(items), pos) if tag == _T_U else (items, pos)
        if tag == _T_M:
            if depth >= MAX_NESTING_DEPTH:
                raise CodecError(f"nesting deeper than {MAX_NESTING_DEPTH} "
                                 "levels")
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            out: Dict[str, object] = {}
            for _ in range(n):
                (kn,) = _U32.unpack_from(data, pos)
                pos += 4
                kend = pos + kn
                if kend > len(data):
                    raise _truncated(pos, data)
                key = data[pos:kend].decode("utf-8")
                out[key], pos = _dec_value(data, kend, depth + 1)
            return out, pos
        if tag == _T_A:
            (dn,) = _U8.unpack_from(data, pos)
            pos += 1
            name = data[pos:pos + dn].decode("ascii")
            pos += dn
            dtype = _DTYPE_BY_NAME.get(name)
            if dtype is None:
                raise CodecError(f"dtype {name!r} is not wire-decodable")
            (ndim,) = _U8.unpack_from(data, pos)
            pos += 1
            shape = []
            count = 1
            for _ in range(ndim):
                (d,) = _U64.unpack_from(data, pos)
                pos += 8
                shape.append(d)
                count *= d
            (nbytes,) = _U64.unpack_from(data, pos)
            pos += 8
            if nbytes != count * dtype.itemsize:
                raise CodecError(f"array byte count {nbytes} does not "
                                 f"match shape {tuple(shape)} dtype {name}")
            end = pos + nbytes
            if end > len(data):
                raise _truncated(pos, data)
            # frombuffer straight off the frame: ONE copy total (the
            # .copy() that detaches from the read-only frame bytes)
            arr = np.frombuffer(data, dtype=dtype, count=count,
                                offset=pos).reshape(shape).copy()
            return arr, end
        if tag == _T_J:
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            end = pos + n
            if end > len(data):
                raise _truncated(pos, data)
            return int(data[pos:end].decode("ascii")), end
        if tag == _T_B:
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            end = pos + n
            if end > len(data):
                raise _truncated(pos, data)
            return data[pos:end], end
    except struct.error:
        raise _truncated(pos, data) from None
    raise CodecError(f"unknown value tag {bytes([tag])!r}")


def encode_value(v) -> bytes:
    out: List[bytes] = []
    _enc_value(v, out)
    return b"".join(out)


def decode_value(data: bytes):
    v, pos = _dec_value(data, 0)
    if pos != len(data):
        raise CodecError(f"{len(data) - pos} trailing bytes after value")
    return v


# ---------------------------------------------------------------------------
# message schema
# ---------------------------------------------------------------------------

def _payload_to_wire(p) -> Dict[str, object]:
    """ShardPayload -> schema dict (duck-typed: the codec must not import
    repro_torch.distributed at module load, the worker daemon imports
    lazily)."""
    return {"_t": "ShardPayload",
            "idx": np.asarray(p.idx),
            "detail": str(p.detail),
            "workloads": (None if p.workloads is None
                          else tuple(str(w) for w in p.workloads))}


def _payload_from_wire(d: Dict[str, object]):
    from repro_torch.distributed.sharded import ShardPayload
    idx = _field(d, "idx", np.ndarray)
    wl = d.get("workloads")
    if wl is not None and not isinstance(wl, tuple):
        raise CodecError("ShardPayload.workloads must be a tuple or None")
    return ShardPayload(idx=idx, detail=_field(d, "detail", str),
                        workloads=wl)


def _report_to_wire(r) -> Dict[str, object]:
    def arrs(dct):
        return None if dct is None else {k: np.asarray(v)
                                         for k, v in dct.items()}
    return {"_t": "PPAReport",
            "workloads": tuple(r.workloads),
            "detail": str(r.detail),
            "area": np.asarray(r.area),
            "latency": arrs(r.latency),
            "stall": arrs(r.stall),
            "op_time": arrs(r.op_time),
            "op_class": arrs(r.op_class),
            "op_names": (None if r.op_names is None
                         else {k: tuple(v) for k, v in r.op_names.items()})}


def _report_from_wire(d: Dict[str, object]):
    from repro_torch.perfmodel.evaluator import PPAReport

    def arrs(key):
        v = d.get(key)
        if v is None:
            return None
        if not isinstance(v, dict) or not all(
                isinstance(a, np.ndarray) for a in v.values()):
            raise CodecError(f"PPAReport.{key} must be a dict of arrays")
        return v

    return PPAReport(workloads=_field(d, "workloads", tuple),
                     detail=_field(d, "detail", str),
                     area=_field(d, "area", np.ndarray),
                     latency=arrs("latency") or {},
                     stall=arrs("stall"), op_time=arrs("op_time"),
                     op_class=arrs("op_class"), op_names=d.get("op_names"))


def _field(d: Dict[str, object], name: str, typ):
    v = d.get(name)
    if not isinstance(v, typ):
        raise CodecError(f"field {name!r} must be {typ.__name__}, got "
                         f"{type(v).__name__}")
    return v


def _spans_to_wire(spans) -> list:
    return [dict(s) for s in (spans or ())]


def _opt_body(v):
    """Payload slot of Dispatch/ResultMsg: structured types get their
    schema dict, plain values pass through the restricted encoder."""
    if v is None or isinstance(v, (str, bytes, int, float, bool)):
        return v
    if hasattr(v, "idx") and hasattr(v, "detail"):
        return _payload_to_wire(v)
    if hasattr(v, "area") and hasattr(v, "latency"):
        return _report_to_wire(v)
    raise CodecError(f"unsupported payload type {type(v).__name__}")


def _opt_unbody(v):
    if isinstance(v, dict) and v.get("_t") == "ShardPayload":
        return _payload_from_wire(v)
    if isinstance(v, dict) and v.get("_t") == "PPAReport":
        return _report_from_wire(v)
    return v


def encode_msg(msg) -> bytes:
    """One wire message -> restricted binary body."""
    t = type(msg).__name__
    if t == "Hello":
        d = {"_t": t, "spec": msg.spec, "wire_version": msg.wire_version}
    elif t == "Ready":
        d = {"_t": t, "digest": msg.digest, "workloads": tuple(msg.workloads)}
    elif t == "Dispatch":
        d = {"_t": t, "seq": msg.seq, "payload": _opt_body(msg.payload),
             "trace_ctx": (None if msg.trace_ctx is None
                           else tuple(msg.trace_ctx))}
    elif t == "ResultMsg":
        d = {"_t": t, "seq": msg.seq, "report": _opt_body(msg.report),
             "spans": _spans_to_wire(getattr(msg, "spans", ()))}
    elif t == "ErrorMsg":
        d = {"_t": t, "seq": msg.seq, "message": msg.message,
             "code": getattr(msg, "code", ""),
             "spans": _spans_to_wire(getattr(msg, "spans", ()))}
    elif t in ("Ping", "Pong"):
        d = {"_t": t, "seq": msg.seq}
    elif t == "Bye":
        d = {"_t": t, "reason": msg.reason}
    elif t == "Announce":
        d = {"_t": t, "address": tuple(msg.address),
             "digests": tuple(msg.digests), "capacity": msg.capacity}
    elif t == "LeaseAck":
        d = {"_t": t, "ttl_s": float(msg.ttl_s)}
    else:
        raise CodecError(f"{t} is not a wire message")
    return encode_value(d)


def decode_msg(body: bytes):
    """Restricted binary body -> wire message (allowlisted constructors
    only; anything off-schema raises :class:`CodecError`)."""
    d = decode_value(body)
    if not isinstance(d, dict) or "_t" not in d:
        raise CodecError("frame body is not a message")
    t = d["_t"]
    if t == "Hello":
        return wire.Hello(spec=_field(d, "spec", bytes),
                          wire_version=_field(d, "wire_version", int))
    if t == "Ready":
        return wire.Ready(digest=_field(d, "digest", str),
                          workloads=_field(d, "workloads", tuple))
    if t == "Dispatch":
        ctx = d.get("trace_ctx")
        return wire.Dispatch(seq=_field(d, "seq", int),
                             payload=_opt_unbody(d.get("payload")),
                             trace_ctx=None if ctx is None else tuple(ctx))
    if t == "ResultMsg":
        return wire.ResultMsg(seq=_field(d, "seq", int),
                              report=_opt_unbody(d.get("report")),
                              spans=tuple(d.get("spans") or ()))
    if t == "ErrorMsg":
        return wire.ErrorMsg(seq=_field(d, "seq", int),
                             message=_field(d, "message", str),
                             spans=tuple(d.get("spans") or ()),
                             code=str(d.get("code") or ""))
    if t == "Ping":
        return wire.Ping(seq=_field(d, "seq", int))
    if t == "Pong":
        return wire.Pong(seq=_field(d, "seq", int))
    if t == "Bye":
        return wire.Bye(reason=_field(d, "reason", str))
    if t == "Announce":
        return wire.Announce(address=tuple(_field(d, "address", tuple)),
                             digests=tuple(d.get("digests") or ()),
                             capacity=_field(d, "capacity", int))
    if t == "LeaseAck":
        return wire.LeaseAck(ttl_s=_field(d, "ttl_s", float))
    raise CodecError(f"unknown message type {t!r}")


MESSAGE_TYPES = ("Hello", "Ready", "Dispatch", "ResultMsg", "ErrorMsg",
                 "Ping", "Pong", "Bye", "Announce", "LeaseAck")


# ---------------------------------------------------------------------------
# frame authentication
# ---------------------------------------------------------------------------

class Keyring:
    """Shared-secret HMAC keys, id-addressable for rotation.

    ``keys`` maps key id -> secret (str secrets are encoded utf-8);
    ``active`` names the signing key (default: the first).  Verification
    accepts ANY key in the ring, so rotating means: add the new key to
    every ring, flip ``active`` on senders, drop the old key later.
    """

    def __init__(self, keys: Mapping[str, object],
                 active: Optional[str] = None):
        if not keys:
            raise ValueError("Keyring needs at least one key")
        self._keys: Dict[str, bytes] = {}
        for kid, secret in keys.items():
            if not isinstance(kid, str) or not kid or len(kid) > 255:
                raise ValueError(f"bad key id {kid!r}")
            self._keys[kid] = (secret.encode("utf-8")
                               if isinstance(secret, str) else bytes(secret))
        self.active = active if active is not None else next(iter(self._keys))
        if self.active not in self._keys:
            raise ValueError(f"active key {self.active!r} not in ring")

    def has(self, key_id: str) -> bool:
        return key_id in self._keys

    def sign(self, key_id: str, data: bytes) -> bytes:
        return hmac.new(self._keys[key_id], data, _MAC).digest()

    def verify(self, key_id: str, data: bytes, mac: bytes) -> bool:
        key = self._keys.get(key_id)
        if key is None:
            return False
        return hmac.compare_digest(
            hmac.new(key, data, _MAC).digest(), mac)


def make_nonce_frame() -> Tuple[bytes, bytes]:
    """A fresh session-nonce handshake frame; returns ``(nonce, frame)``.
    The nonce travels in the clear — it adds no secrecy, only freshness:
    once both sides fold the pair of nonces into every frame MAC, a
    recorded session cannot replay over a NEW connection (the responder's
    fresh nonce changes every MAC).  A man in the middle can corrupt the
    exchange, but that only yields a connection where nothing verifies."""
    nonce = os.urandom(NONCE_BYTES)
    return nonce, MAGIC + bytes([FLAG_NONCE]) + nonce


def is_nonce_frame(data: bytes) -> bool:
    return data[:4] == MAGIC and len(data) > 4 and bool(data[4] & FLAG_NONCE)


def nonce_of(frame: bytes) -> bytes:
    """The nonce carried by a handshake frame (typed error off-shape)."""
    if not is_nonce_frame(frame) or len(frame) != 5 + NONCE_BYTES:
        raise CodecError("malformed session nonce frame")
    return frame[5:]


def seal_frame(body: bytes, keyring: Optional[Keyring], seq: int,
               key_id: Optional[str] = None, *,
               binding: bytes = b"") -> bytes:
    """Wrap a message body in the codec frame header; signed when a
    keyring is given (the MAC covers magic, flags, key id, the
    per-direction sequence number and the session ``binding`` — the
    concatenated connection nonces — so none of them can be spliced and
    a frame from one connection never verifies on another)."""
    if keyring is None:
        return MAGIC + bytes([0]) + body
    kid = (key_id if key_id is not None else keyring.active).encode("utf-8")
    head = MAGIC + bytes([FLAG_SIGNED]) + _U8.pack(len(kid)) + kid \
        + _U64.pack(seq)
    return head + keyring.sign(kid.decode("utf-8"),
                               binding + head + body) + body


def open_frame(data: bytes, keyring: Optional[Keyring],
               expected_seq: int, *, binding: bytes = b"") -> bytes:
    """Validate + unwrap one codec frame; every failure is typed and
    happens BEFORE the body is decoded."""
    if data[:4] != MAGIC:
        raise CodecError("not a codec frame")
    if len(data) < 5:
        raise CodecError("truncated frame header")
    flags = data[4]
    if flags & FLAG_NONCE:
        raise CodecError("unexpected session nonce frame mid-stream")
    if not flags & FLAG_SIGNED:
        if keyring is not None:
            raise AuthError("unsigned", "this endpoint requires signed "
                            "frames")
        return data[5:]
    pos = 5
    if len(data) < pos + 1:
        raise CodecError("truncated frame header")
    kid_len = data[pos]
    pos += 1
    if len(data) < pos + kid_len + 8 + _MAC_BYTES:
        raise CodecError("truncated frame header")
    kid = data[pos:pos + kid_len].decode("utf-8", errors="replace")
    pos += kid_len
    (seq,) = _U64.unpack(data[pos:pos + 8])
    pos += 8
    mac = data[pos:pos + _MAC_BYTES]
    pos += _MAC_BYTES
    body = data[pos:]
    if keyring is None:
        raise AuthError("unknown_key", "signed frame but this endpoint has "
                        "no keyring")
    if not keyring.has(kid):
        raise AuthError("unknown_key", f"key id {kid!r}")
    head = data[:5 + 1 + kid_len + 8]
    if not keyring.verify(kid, binding + head + body, mac):
        raise AuthError("tamper", f"bad MAC under key {kid!r}")
    if seq != expected_seq:
        raise AuthError("replay", f"frame seq {seq}, expected "
                        f"{expected_seq}")
    return body


# ---------------------------------------------------------------------------
# the channel: framing + codec + auth + replay state for one socket
# ---------------------------------------------------------------------------

CODEC_BINARY = "binary"
CODEC_PICKLE = "pickle"


class Channel:
    """One side of a serve connection.

    ``codec='binary'`` speaks the restricted codec (optionally signed);
    ``codec='pickle'`` is the legacy single-trust-domain transport.
    ``send`` serializes + seals under an internal lock (the signing
    sequence number and the socket write must stay in lockstep — and the
    pickle path serializes the raw ``sendall`` too, so reader / eval /
    timer threads cannot interleave a frame stream);
    ``recv``/``feed`` verify and decode, maintaining the receive-side
    replay counter.  ``max_frame_bytes`` bounds BOTH directions: an
    outbound frame above it raises :class:`FrameTooLarge` before any
    byte hits the wire.

    **Session binding**: a keyed channel must run the nonce handshake
    before any signed traffic — the connecting side calls
    :meth:`client_handshake`, the accepting side feeds the peer's nonce
    frame to :meth:`server_handshake`.  Both nonces are folded into
    every frame MAC, so a recorded signed session replayed verbatim
    over a NEW connection fails verification (the fresh responder nonce
    changes every expected MAC).  Signed frames before the handshake
    are ``AuthError("replay")`` — the replay window they would reopen
    is exactly what the handshake closes.
    """

    def __init__(self, sock, *, codec: str = CODEC_BINARY,
                 keyring: Optional[Keyring] = None,
                 key_id: Optional[str] = None,
                 max_frame_bytes: int = wire.MAX_MESSAGE_BYTES):
        if codec not in (CODEC_BINARY, CODEC_PICKLE):
            raise ValueError(f"codec must be binary|pickle, got {codec!r}")
        if codec == CODEC_PICKLE and keyring is not None:
            raise ValueError("the legacy pickle codec cannot be signed; "
                             "use the binary codec for authenticated "
                             "traffic")
        self.sock = sock
        self.codec = codec
        self.keyring = keyring
        self.key_id = key_id
        self.max_frame_bytes = int(max_frame_bytes)
        self.binding = b""              # session nonces, folded into MACs
        self._handshaken = codec != CODEC_BINARY or keyring is None
        self._send_seq = 0
        self._recv_seq = 0
        self._send_lock = threading.Lock()

    def client_handshake(self) -> None:
        """Run the connecting side of the session-nonce exchange (no-op
        on unsigned or pickle channels): send our nonce, receive the
        peer's, bind both into every subsequent frame MAC."""
        if self.codec != CODEC_BINARY or self.keyring is None \
                or self._handshaken:
            return
        local, frame = make_nonce_frame()
        wire.send_frame(self.sock, frame)
        peer = nonce_of(wire.recv_frame(self.sock, self.max_frame_bytes))
        self.binding = local + peer     # initiator nonce first
        self._handshaken = True

    def server_handshake(self, peer_frame: bytes) -> None:
        """Run the accepting side: ``peer_frame`` is the connection's
        first frame (already sniffed as a nonce frame); answer with our
        own nonce and bind the pair."""
        peer = nonce_of(peer_frame)
        local, frame = make_nonce_frame()
        wire.send_frame(self.sock, frame)
        self.binding = peer + local     # initiator nonce first
        self._handshaken = True

    def send(self, msg) -> None:
        if self.codec == CODEC_PICKLE:
            frame = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
            if len(frame) > self.max_frame_bytes:
                raise FrameTooLarge(len(frame), self.max_frame_bytes)
            with self._send_lock:
                wire.send_frame(self.sock, frame)
            return
        if not self._handshaken:
            raise AuthError("replay", "session nonce handshake required "
                            "before signed traffic")
        body = encode_msg(msg)
        with self._send_lock:
            frame = seal_frame(body, self.keyring, self._send_seq,
                               self.key_id, binding=self.binding)
            if len(frame) > self.max_frame_bytes:
                raise FrameTooLarge(len(frame), self.max_frame_bytes)
            self._send_seq += 1
            wire.send_frame(self.sock, frame)

    def recv(self):
        return self.feed(wire.recv_frame(self.sock, self.max_frame_bytes))

    def feed(self, raw: bytes):
        """Decode one already-received frame (the accept-side sniff path
        hands the first frame here after choosing the codec)."""
        if self.codec == CODEC_PICKLE:
            return legacy_loads(raw)
        if not self._handshaken and len(raw) > 4 \
                and raw[4] & FLAG_SIGNED:
            # a signed frame with no session handshake is indistinguishable
            # from a cross-connection replay of a recorded session — refuse
            raise AuthError("replay", "signed frame before the session "
                            "nonce handshake")
        body = open_frame(raw, self.keyring, self._recv_seq,
                          binding=self.binding)
        self._recv_seq += 1
        return decode_msg(body)


class FrameTooLarge(wire.WireError):
    """An OUTBOUND frame exceeds the configured bound — refused before
    sending (the receiver would drop the connection anyway)."""

    def __init__(self, size: int, bound: int):
        super().__init__(f"outbound frame of {size} bytes exceeds the "
                         f"{bound}-byte frame bound")
        self.size = size
        self.bound = bound


def sniff_codec(first_frame: bytes) -> str:
    """Which codec an incoming connection speaks, from its first frame:
    the codec magic, or pickle's protocol-2+ opcode (0x80)."""
    if first_frame[:4] == MAGIC:
        return CODEC_BINARY
    if first_frame[:1] == b"\x80":
        return CODEC_PICKLE
    raise CodecError(f"unrecognized first frame "
                     f"(starts {first_frame[:4]!r})")


# ---------------------------------------------------------------------------
# evaluator spec deserialization: the two sanctioned paths
# ---------------------------------------------------------------------------

# module prefixes the restricted spec loader may resolve constructors
# from: this package's model/space/workload classes plus numpy's array
# reconstruction machinery.  NOTHING else resolves — os/subprocess/
# builtins.eval style gadgets raise before construction.
_SPEC_MODULE_PREFIXES = ("repro_torch.",)
_SPEC_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                 "numpy.core.numeric", "numpy._core.numeric", "numpy.dtypes",
                 "collections"}
# NO builtins.getattr / builtins.object here: getattr turns ANY reachable
# module attribute (e.g. an `os` re-exported by some repro_torch module) into
# an arbitrary-call gadget, which is exactly the traversal this loader
# exists to close.  Only value constructors resolve.
_SPEC_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "str",
                  "bytes", "bytearray", "int", "float", "bool", "complex"}
# the only non-class module attributes the spec format legitimately
# references: numpy's array/scalar reconstruction functions.  Everything
# else resolved from an allowlisted module must be a CLASS — modules
# (re-exported `os`/`pickle`), functions and bound callables raise.
_SPEC_FUNCTIONS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "builtins":
            if name in _SPEC_BUILTINS:
                return super().find_class(module, name)
            raise CodecError(f"spec constructor builtins.{name} is not "
                             "allowlisted")
        if module in _SPEC_MODULES or module.startswith(
                _SPEC_MODULE_PREFIXES):
            obj = super().find_class(module, name)
            if isinstance(obj, type) or (module, name) in _SPEC_FUNCTIONS:
                return obj
            raise CodecError(f"spec constructor {module}.{name} resolves "
                             f"to a {type(obj).__name__}, not a class — "
                             "not allowlisted")
        raise CodecError(f"spec constructor {module}.{name} is not "
                         "allowlisted")


def restricted_loads(data: bytes):
    """Deserialize an evaluator spec through the allowlisted constructor
    table — the secure-mode replacement for ``pickle.loads`` on spec
    bytes (defense in depth under frame auth: even a signed spec cannot
    name constructors outside the evaluator schema)."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def legacy_loads(data: bytes):
    """The legacy pickle shim — the ONLY raw ``pickle.loads`` permitted
    under ``serve/`` (enforced by the ``pickle-outside-codec`` lint
    rule).  Reachable only when both endpoints opted into
    ``insecure=True``: single trust domain, same machine-room rules as
    the process pool."""
    return pickle.loads(data)


def spec_digest(spec: bytes) -> str:
    """The sha256 hex digest workers cache/allowlist specs by."""
    return hashlib.sha256(spec).hexdigest()
