"""Causal tracing: spans, per-thread context, cross-machine adoption.

Model (deliberately small — it rides the dispatch hot path):

- A :class:`Span` is one timed operation with a ``trace_id`` shared by
  the whole causal tree and a ``parent_id`` linking it to its cause.
- A :class:`Tracer` keeps a *per-thread* stack of open spans so nested
  calls on one thread parent automatically, plus one bounded buffer of
  finished spans.  Cross-thread / cross-machine causality is explicit:
  pass ``parent=(trace_id, span_id)`` (a portable ``trace_ctx``) and the
  remote side's spans re-parent under the client span;
  :meth:`Tracer.adopt` merges their dicts back.
- Spans end with ``status`` ``"ok"``, ``"error"`` (the attempt failed
  and was observed failing), or ``"lost"`` (orphaned — shard timeout,
  abandoned straggler twin, worker SIGKILL / connection death).

``NOOP`` (a :class:`NoopTracer`) is the default for components that take
a tracer; every method is a constant-time no-op so instrumentation left in
place costs effectively nothing when tracing is off.

``PROCESS_TRACER`` (a :class:`ProcessTracer`) is the one tracer of the
process, used by the sweep engine, ``moe_block`` and ``adamw_update`` when
no tracer is passed.  It records only while ``torch.profiler`` records or
while :meth:`ProcessTracer.force` has turned it on; each span it records
is also a host range of the same name on the profiler's timeline, and a
device span carries a pair of CUDA events, resolved to stream seconds
(``attrs["device_s"]``) only when the spans are read.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, ClassVar, Deque, Dict, Iterable, List,
                    Optional, Tuple, Union)

import torch
import torch.autograd.profiler as _profiler

from repro_torch.obs.metrics import Clock, MONOTONIC

SPAN_STATUSES = ("ok", "error", "lost")

#: (trace_id, span_id) — the wire-portable causal context.
TraceContext = Tuple[str, str]

DEFAULT_MAX_SPANS = 65536


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    proc: str
    thread: str
    t_start: float
    t_end: Optional[float] = None
    status: str = "ok"
    attrs: Dict[str, object] = field(default_factory=dict)
    #: False on the no-op stand-in: attrs worth computing only when kept
    recording: ClassVar[bool] = True

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    @property
    def ctx(self) -> TraceContext:
        return (self.trace_id, self.span_id)

    def as_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "proc": self.proc,
            "thread": self.thread,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "status": self.status,
            "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "Span":
        return Span(
            name=str(d["name"]),
            trace_id=str(d["trace_id"]),
            span_id=str(d["span_id"]),
            parent_id=(None if d.get("parent_id") is None else str(d["parent_id"])),
            proc=str(d.get("proc", "?")),
            thread=str(d.get("thread", "?")),
            t_start=float(d["t_start"]),
            t_end=(None if d.get("t_end") is None else float(d["t_end"])),
            status=str(d.get("status", "ok")),
            attrs=dict(d.get("attrs", {}) or {}),
        )


class _SpanHandle:
    """Context manager returned by ``Tracer.span(...)``."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer.finish(self._span, status="error" if exc_type is not None else None)
        if exc_type is not None:
            self._span.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        return False


class _Activation:
    """Context manager that makes a detached span *current* on this
    thread for the duration of the block, without finishing it."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._stack().append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = self._tracer._stack()
        if stack and stack[-1] is self._span:
            stack.pop()
        return False


_PARENT_INHERIT = "inherit"


class Tracer:
    """Span factory with per-thread open-span stacks.

    ``proc`` names the process for span-id minting and the Perfetto
    process lane (e.g. ``"client"`` or ``"worker:127.0.0.1:9001"``).
    Finished spans land in one bounded deque (oldest dropped first);
    ``drain()`` empties it, ``spans()`` copies it.
    """

    enabled = True

    def __init__(
        self,
        *,
        clock: Clock = MONOTONIC,
        proc: str = "main",
        max_spans: int = DEFAULT_MAX_SPANS,
    ) -> None:
        self.clock = clock
        self.proc = str(proc)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._finished: Deque[Span] = deque(maxlen=int(max_spans))
        self._ids = itertools.count(1)

    # -- thread-local stack ------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def current_ctx(self) -> Optional[TraceContext]:
        cur = self.current()
        return cur.ctx if cur is not None else None

    # -- span lifecycle ----------------------------------------------------

    def _new_id(self) -> str:
        return f"{self.proc}/{next(self._ids)}"

    def start(
        self,
        name: str,
        *,
        parent: Union[str, None, TraceContext, Span] = _PARENT_INHERIT,
        detached: bool = False,
        **attrs: object,
    ) -> Span:
        """Open a span.

        ``parent`` is the current thread's open span by default; pass an
        explicit ``(trace_id, span_id)`` tuple (e.g. a wire ``trace_ctx``)
        or a ``Span``, or ``None`` to force a new root.  ``detached=True``
        keeps the span off the thread-local stack — required when the
        span will be finished from another thread or out of order
        (shard fan-out, wire futures).
        """
        if isinstance(parent, Span):
            parent = parent.ctx
        if parent == _PARENT_INHERIT:
            parent = self.current_ctx()
        span_id = self._new_id()
        if parent is None:
            trace_id, parent_id = span_id, None
        else:
            trace_id, parent_id = str(parent[0]), str(parent[1])
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=span_id,
            parent_id=parent_id,
            proc=self.proc,
            thread=threading.current_thread().name,
            t_start=self.clock(),
            attrs=dict(attrs) if attrs else {},
        )
        if not detached:
            self._stack().append(span)
        return span

    def finish(self, span: Span, status: Optional[str] = None) -> None:
        if span.t_end is not None:
            return
        span.t_end = self.clock()
        if status is not None:
            span.status = status
        stack = getattr(self._local, "stack", None)
        if stack and span in stack:
            stack.remove(span)
        with self._lock:
            self._finished.append(span)

    def lose(self, span: Span, reason: str = "") -> None:
        """Close an orphaned span with ``status="lost"``."""
        if reason:
            span.attrs.setdefault("lost_reason", reason)
        self.finish(span, status="lost")

    def span(self, name: str, *, parent=_PARENT_INHERIT, **attrs: object) -> _SpanHandle:
        return _SpanHandle(self, self.start(name, parent=parent, **attrs))

    def activate(self, span: Span) -> _Activation:
        return _Activation(self, span)

    # -- cross-machine -----------------------------------------------------

    def adopt(self, span_dicts: Iterable[Dict[str, object]]) -> int:
        """Merge spans serialized by a remote tracer into this buffer."""
        n = 0
        adopted = [Span.from_dict(d) for d in span_dicts or ()]
        with self._lock:
            for s in adopted:
                self._finished.append(s)
                n += 1
        return n

    # -- buffer access -----------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def drain(self) -> List[Span]:
        with self._lock:
            out = list(self._finished)
            self._finished.clear()
        return out


class _NoopSpanHandle:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return _NOOP_SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


class _NoopSpan:
    """Inert span stand-in; mutating it is harmless and unrecorded."""

    __slots__ = ("attrs",)
    name = trace_id = span_id = proc = thread = ""
    parent_id = None
    t_start = 0.0
    t_end: Optional[float] = None
    status = "ok"
    recording = False

    def __init__(self) -> None:
        self.attrs: Dict[str, object] = {}

    @property
    def ctx(self) -> TraceContext:
        return ("", "")

    def as_dict(self) -> Dict[str, object]:
        return {}


_NOOP_SPAN = _NoopSpan()
_NOOP_HANDLE = _NoopSpanHandle()


class NoopTracer:
    """Disabled tracer: every operation is a constant-time no-op."""

    enabled = False
    proc = "noop"

    def current(self) -> None:
        return None

    def current_ctx(self) -> None:
        return None

    def start(self, name: str, **kw: object) -> _NoopSpan:
        return _NOOP_SPAN

    def finish(self, span: object, status: Optional[str] = None) -> None:
        pass

    def lose(self, span: object, reason: str = "") -> None:
        pass

    def span(self, name: str, **kw: object) -> _NoopSpanHandle:
        return _NOOP_HANDLE

    def activate(self, span: object) -> _NoopSpanHandle:
        return _NOOP_HANDLE

    def adopt(self, span_dicts: Iterable[Dict[str, object]]) -> int:
        return 0

    def spans(self) -> List[Span]:
        return []

    def drain(self) -> List[Span]:
        return []


NOOP = NoopTracer()


def _cuda_event(device: torch.device):
    """A timing event recorded on `device`'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _number(v: torch.Tensor):
    """A tensor attr as a Python number (a list if it holds several); a
    DTensor reads its local shard, so reading takes no collective."""
    if hasattr(v, "to_local"):
        v = v.to_local()
    return v.item() if v.numel() == 1 else v.tolist()


class ProcessTracer(Tracer):
    """The process's tracer, gated on the profiler.

    ``enabled`` is true while ``torch.profiler`` records (the module flag
    ``torch.autograd.profiler._is_profiler_enabled``) or while
    :meth:`force` has turned it on.  Off, :meth:`span` and :meth:`start`
    read that flag and return the no-op span: no clock read, no CUDA
    event, no tensor, no launch, no sync.  On, a span is kept in the
    bounded buffer as :class:`Tracer` keeps it and, while the profiler
    records, is also a host range of the same name on the profiler's
    timeline (``_RecordFunctionFast``: kineto lists ``record_function``
    ranges on the device timeline as well, this form only on the host).

    ``device=`` opens a device span: on a CUDA device a timing event is
    recorded on the current stream when the span opens and another when
    it closes.  Events, and attrs that hold tensors (0-d counts computed
    on the device), are turned into numbers only when the spans are read
    (:meth:`spans`, :meth:`drain`), after the caller's sync: the stream
    seconds land in ``attrs["device_s"]``.  `event` (a factory taking the
    device and returning a recorded event) is the tests'.
    """

    def __init__(self, *, max_spans: int = DEFAULT_MAX_SPANS,
                 event: Callable[[torch.device], object] = _cuda_event
                 ) -> None:
        super().__init__(clock=time.perf_counter, proc="process",
                         max_spans=max_spans)
        self._forced = False
        self._event = event
        self._open: Dict[str, tuple] = {}   # span_id -> (range, event, device)
        self._pending: Deque[tuple] = deque(maxlen=int(max_spans))

    @property
    def enabled(self) -> bool:
        return self._forced or _profiler._is_profiler_enabled

    def force(self, on: bool = True) -> None:
        """Record with the profiler off too (the operator's switch)."""
        self._forced = bool(on)

    def start(self, name: str, *, parent=_PARENT_INHERIT,
              detached: bool = False, device=None, **attrs: object):
        if not (self._forced or _profiler._is_profiler_enabled):
            return _NOOP_SPAN
        span = super().start(name, parent=parent, detached=detached,
                             **attrs)
        rng = ev = None
        if _profiler._is_profiler_enabled:
            rng = torch._C._profiler._RecordFunctionFast(name)
            rng.__enter__()
        if device is not None and torch.device(device).type == "cuda":
            device = torch.device(device)
            ev = self._event(device)
        if rng is not None or ev is not None:
            self._open[span.span_id] = (rng, ev, device)
        return span

    def finish(self, span, status: Optional[str] = None) -> None:
        if not span.recording or span.t_end is not None:
            return
        rng, ev0, device = self._open.pop(span.span_id, (None, None, None))
        events = None if ev0 is None else (ev0, self._event(device))
        if rng is not None:
            rng.__exit__(None, None, None)
        super().finish(span, status)
        if events is not None or any(isinstance(v, torch.Tensor)
                                     for v in span.attrs.values()):
            with self._lock:
                self._pending.append((span, events))

    def span(self, name: str, *, parent=_PARENT_INHERIT, device=None,
             **attrs: object):
        if not (self._forced or _profiler._is_profiler_enabled):
            return _NOOP_HANDLE
        return _SpanHandle(self, self.start(name, parent=parent,
                                            device=device, **attrs))

    def activate(self, span):
        if not span.recording:
            return _NOOP_HANDLE
        return super().activate(span)

    def _resolve(self) -> None:
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for span, events in pending:
            if events is not None:
                events[1].synchronize()
                span.attrs["device_s"] = events[0].elapsed_time(
                    events[1]) / 1e3
            for k, v in span.attrs.items():
                if isinstance(v, torch.Tensor):
                    span.attrs[k] = _number(v)

    def spans(self) -> List[Span]:
        self._resolve()
        return super().spans()

    def drain(self) -> List[Span]:
        self._resolve()
        return super().drain()


#: The process's tracer (see :class:`ProcessTracer`).
PROCESS_TRACER = ProcessTracer()
