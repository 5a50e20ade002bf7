"""Fleet dashboard: render a Gateway observability snapshot as text.

Usage::

    python -m repro_torch.obs.report snapshot.json    # a saved snapshot
    report.fleet_report(gateway)                      # a live Gateway

The snapshot shape is what :meth:`repro_torch.serve.gateway.Gateway.
snapshot` produces (and ``Gateway.save_snapshot`` writes as the CLI's
input)::

    {"telemetry": <Gateway.telemetry()>,
     "metrics": {"gateway": ..., "service": ..., "evaluator": ...}}

A bare :class:`~repro_torch.distributed.service.EvalService` is read by
putting it behind a gateway: ``fleet_report(Gateway(service))``.
Sections: per-tier queue-latency percentiles, per-tenant admission,
per-worker heartbeat RTT + shard timings, degradation-rung hit rates,
and raw traffic counters; a section with nothing to show is left out.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def _table(headers: List[str], rows: List[List[object]]) -> List[str]:
    cells = [[str(c) for c in row] for row in rows]
    widths = [len(h) for h in headers]
    for row in cells:
        for i, c in enumerate(row):
            widths[i] = max(widths[i], len(c))
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip()]
    out.append("  ".join("-" * w for w in widths))
    for row in cells:
        out.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
    return out


def _fmt(v: object) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _hist_series(metrics: Dict, registry: str, name: str) -> List[Dict]:
    entry = (metrics or {}).get(registry, {}).get(name)
    if not entry:
        return []
    return entry.get("series", [])


def fleet_report(source) -> str:
    """Render the dashboard.  ``source`` is a snapshot dict or any
    object with a ``snapshot()`` method (a live ``Gateway``)."""
    snap = source if isinstance(source, dict) else source.snapshot()
    tel = snap.get("telemetry", snap)
    metrics = snap.get("metrics", {})
    svc = tel.get("service", {})
    lines: List[str] = ["== repro_torch.obs fleet report =="]

    # -- traffic ----------------------------------------------------------
    lines.append("")
    lines.append("-- traffic --")
    lines += _table(
        ["submits", "cache_hits", "fused", "coalesced", "admitted", "rejected"],
        [
            [
                _fmt(svc.get("submits")),
                _fmt(svc.get("cache_hits")),
                _fmt(svc.get("fused_dispatches")),
                _fmt(svc.get("coalesced_requests")),
                _fmt(tel.get("admission", {}).get("admitted")),
                _fmt(tel.get("admission", {}).get("rejected")),
            ]
        ],
    )

    # -- tiers ------------------------------------------------------------
    tiers = svc.get("tiers", {})
    if tiers:
        lines.append("")
        lines.append("-- qos tiers (queue latency) --")
        rows = [
            [t, d.get("weight"), d.get("served"), d.get("queued"), _fmt(d.get("p50_ms")), _fmt(d.get("p99_ms"))]
            for t, d in sorted(tiers.items())
        ]
        lines += _table(["tier", "weight", "served", "queued", "p50_ms", "p99_ms"], rows)

    # -- degradation ladder ----------------------------------------------
    degraded = svc.get("degraded", {})
    if degraded:
        submits = max(1, int(svc.get("submits") or 1))
        lines.append("")
        lines.append("-- degradation rungs --")
        rows = [
            [rung, int(n), f"{100.0 * int(n) / submits:.2f}%"]
            for rung, n in sorted(degraded.items())
        ]
        lines += _table(["rung", "hits", "rate/submit"], rows)

    # -- tenants ----------------------------------------------------------
    tenants = tel.get("tenants", {})
    if tenants:
        lines.append("")
        lines.append("-- tenants (admission) --")
        rows = [
            [
                t,
                d.get("admitted"),
                d.get("admitted_rows"),
                d.get("used_rows"),
                d.get("rows_per_window"),
                d.get("rejected_budget"),
                d.get("rejected_backpressure"),
            ]
            for t, d in sorted(tenants.items())
        ]
        lines += _table(
            ["tenant", "admitted", "rows", "used", "budget", "rej_budget", "rej_bp"], rows
        )

    # -- fleet ------------------------------------------------------------
    fleet = tel.get("fleet")
    if fleet:
        lines.append("")
        lines.append("-- fleet --")
        lines += _table(
            ["mode", "workers", "live", "known", "evictions"],
            [
                [
                    fleet.get("mode"),
                    fleet.get("workers"),
                    fleet.get("live"),
                    fleet.get("known"),
                    fleet.get("evictions"),
                ]
            ],
        )
        rtt = fleet.get("heartbeat_rtt") or {}
        if rtt:
            lines.append("")
            lines.append("-- heartbeat rtt (per worker) --")
            rows = [
                [w, d.get("count"), _fmt(d.get("p50_ms")), _fmt(d.get("p99_ms"))]
                for w, d in sorted(rtt.items())
            ]
            lines += _table(["worker", "pings", "p50_ms", "p99_ms"], rows)

    # -- per-worker shard timings ----------------------------------------
    shard = _hist_series(metrics, "evaluator", "sharded_shard_s")
    if shard:
        lines.append("")
        lines.append("-- shard timings (per worker slot) --")
        rows = []
        for s in shard:
            slot = s.get("labels", {}).get("slot", "?")
            p50 = s.get("p50")
            p99 = s.get("p99")
            rows.append(
                [
                    slot,
                    s.get("count"),
                    _fmt(None if p50 is None else p50 * 1e3),
                    _fmt(None if p99 is None else p99 * 1e3),
                ]
            )
        lines += _table(["slot", "shards", "p50_ms", "p99_ms"], rows)

    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description="Render a fleet dashboard"
    )
    parser.add_argument("snapshot", help="path to a Gateway.save_snapshot() JSON file")
    args = parser.parse_args(argv)
    with open(args.snapshot) as fh:
        snap = json.load(fh)
    print(fleet_report(snap))
    return 0


if __name__ == "__main__":
    sys.exit(main())
