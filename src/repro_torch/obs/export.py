"""Exporters: Perfetto/Chrome trace JSON, span-tree checks, CSV metrics.

The trace format is the Chrome ``trace_event`` JSON (object form with a
``traceEvents`` list), loadable by Perfetto / ``chrome://tracing``:
one ``"X"`` (complete) event per finished span with microsecond
``ts``/``dur``, plus ``"M"`` metadata events naming each process lane.
Span identity/causality ride in ``args`` (``trace_id``/``span_id``/
``parent_id``/``status`` + user attrs).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.trace import SPAN_STATUSES, Span

SpanLike = Union[Span, Dict[str, object]]

TRACE_SCHEMA_VERSION = 1


def _as_spans(spans: Iterable[SpanLike]) -> List[Span]:
    out: List[Span] = []
    for s in spans:
        out.append(s if isinstance(s, Span) else Span.from_dict(s))
    return out


def trace_events(spans: Iterable[SpanLike]) -> Dict[str, object]:
    """Render spans as a Chrome/Perfetto ``trace_event`` JSON object."""
    sp = _as_spans(spans)
    procs = sorted({s.proc for s in sp})
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[Dict[str, object]] = []
    for p in procs:
        events.append(
            {"ph": "M", "name": "process_name", "pid": pid_of[p], "tid": 0, "args": {"name": p}}
        )
    for s in sp:
        key = (s.proc, s.thread)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == s.proc]) + 1
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid_of[s.proc],
                    "tid": tids[key],
                    "args": {"name": s.thread},
                }
            )
        t_end = s.t_end if s.t_end is not None else s.t_start
        args: Dict[str, object] = {
            "trace_id": s.trace_id,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "status": s.status,
        }
        args.update(s.attrs)
        events.append(
            {
                "ph": "X",
                "name": s.name,
                "cat": "repro",
                "ts": s.t_start * 1e6,
                "dur": max(0.0, (t_end - s.t_start) * 1e6),
                "pid": pid_of[s.proc],
                "tid": tids[key],
                "args": args,
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "repro_torch.obs", "schema_version": TRACE_SCHEMA_VERSION},
    }


def write_trace(path: str, spans: Iterable[SpanLike]) -> str:
    obj = trace_events(spans)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1, default=str)
    return path


def validate_trace_events(obj: object) -> List[str]:
    """Schema-check an exported trace object; returns a list of problems
    (empty = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return ["top level is not an object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            errors.append(f"{where}: pid/tid must be ints")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"{where}: X event missing numeric ts")
            if not isinstance(ev.get("dur"), (int, float)) or ev.get("dur", -1) < 0:
                errors.append(f"{where}: X event needs dur >= 0")
            args = ev.get("args")
            if not isinstance(args, dict) or "span_id" not in args or "trace_id" not in args:
                errors.append(f"{where}: args must carry span_id/trace_id")
            elif args.get("status") not in SPAN_STATUSES:
                errors.append(f"{where}: bad status {args.get('status')!r}")
    return errors


# -- span-tree structure ---------------------------------------------------


def build_tree(spans: Iterable[SpanLike]) -> Tuple[List[Span], Dict[str, List[Span]]]:
    """Return (roots, children-by-parent-span-id), children time-sorted."""
    sp = _as_spans(spans)
    children: Dict[str, List[Span]] = {}
    ids = {s.span_id for s in sp}
    roots: List[Span] = []
    for s in sp:
        if s.parent_id is None or s.parent_id not in ids:
            roots.append(s)
        else:
            children.setdefault(s.parent_id, []).append(s)
    for lst in children.values():
        lst.sort(key=lambda s: (s.t_start, s.span_id))
    roots.sort(key=lambda s: (s.t_start, s.span_id))
    return roots, children


def completeness_errors(
    spans: Iterable[SpanLike], trace_id: Optional[str] = None
) -> List[str]:
    """Structural checks for a causal tree: one root per trace, no
    dangling parents, no open (unfinished) spans, statuses legal."""
    sp = _as_spans(spans)
    if trace_id is not None:
        sp = [s for s in sp if s.trace_id == trace_id]
    errors: List[str] = []
    if not sp:
        return ["no spans"]
    ids = {s.span_id for s in sp}
    by_trace: Dict[str, List[Span]] = {}
    for s in sp:
        by_trace.setdefault(s.trace_id, []).append(s)
        if s.parent_id is not None and s.parent_id not in ids:
            errors.append(f"span {s.span_id} ({s.name}) has dangling parent {s.parent_id}")
        if s.t_end is None:
            errors.append(f"span {s.span_id} ({s.name}) never finished")
        if s.status not in SPAN_STATUSES:
            errors.append(f"span {s.span_id} ({s.name}) has bad status {s.status!r}")
    for tid, members in sorted(by_trace.items()):
        roots = [s for s in members if s.parent_id is None]
        if len(roots) != 1:
            errors.append(
                f"trace {tid} has {len(roots)} roots ({[s.name for s in roots]}), expected 1"
            )
    return errors


def render_tree(spans: Iterable[SpanLike], trace_id: Optional[str] = None) -> str:
    """ASCII causal tree with durations, statuses, and process identity."""
    sp = _as_spans(spans)
    if trace_id is not None:
        sp = [s for s in sp if s.trace_id == trace_id]
    roots, children = build_tree(sp)
    lines: List[str] = []

    def _fmt(s: Span) -> str:
        dur = s.duration_s
        dur_txt = f"{dur * 1e3:8.3f}ms" if dur is not None else "    open"
        mark = {"ok": " ", "error": "!", "lost": "?"}.get(s.status, "?")
        attrs = ""
        if s.attrs:
            parts = [f"{k}={v}" for k, v in sorted(s.attrs.items())]
            attrs = "  [" + " ".join(parts) + "]"
        return f"{mark} {s.name}  {dur_txt}  ({s.proc}/{s.thread}) {s.status}{attrs}"

    def _walk(s: Span, prefix: str, is_last: bool) -> None:
        connector = "`-- " if is_last else "|-- "
        lines.append(prefix + connector + _fmt(s))
        kids = children.get(s.span_id, [])
        child_prefix = prefix + ("    " if is_last else "|   ")
        for i, kid in enumerate(kids):
            _walk(kid, child_prefix, i == len(kids) - 1)

    for root in roots:
        lines.append(_fmt(root))
        kids = children.get(root.span_id, [])
        for i, kid in enumerate(kids):
            _walk(kid, "", i == len(kids) - 1)
    return "\n".join(lines)


# -- metrics ---------------------------------------------------------------


def metrics_csv_lines(flat: Dict[str, float]) -> List[str]:
    """Flat metrics map -> ``metric,value`` CSV lines (header first)."""
    lines = ["metric,value"]
    for key, value in sorted(flat.items()):
        lines.append(f"{key},{value:.9g}")
    return lines


def write_metrics_json(path: str, snapshot: Dict[str, object]) -> str:
    with open(path, "w") as fh:
        json.dump(snapshot, fh, indent=2, sort_keys=True, default=str)
    return path
