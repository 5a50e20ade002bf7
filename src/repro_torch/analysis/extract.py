"""CLI: extract the influence graph from the port's perfmodel source and
guard the checked-in artifact.

* ``python -m repro_torch.analysis.extract``          — human-readable summary
* ``python -m repro_torch.analysis.extract --check``  — fail (exit 1) if the
  freshly extracted graph's *signature* (nodes/edges/guards/primaries, not
  line numbers) differs from ``influence_graph.json`` — the tripwire for
  perfmodel refactors that silently change influence edges
* ``python -m repro_torch.analysis.extract --write``  — write the artifact
  (to ``--artifact``; the checked-in one is the reference's extraction and
  is not refreshed from the port)
* ``python -m repro_torch.analysis.extract --param P`` — render one
  parameter's influence chain
* ``python -m repro_torch.analysis.extract --probe [--device cpu]`` —
  cross-validate against the probe-based QualE map (its evaluator on the
  card unless ``--device cpu``) and print the rule-audit telemetry
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.analysis.influence import (ARTIFACT_PATH, cross_validate,
                                            extract_influence_graph,
                                            load_artifact)


def _diff_signatures(old: dict, new: dict) -> list:
    lines = []
    for field in ("params", "derived", "terms", "stalls", "metrics",
                  "guard_kinds", "primary"):
        if old.get(field) != new.get(field):
            lines.append(f"  {field}: {old.get(field)!r} -> "
                         f"{new.get(field)!r}")
    o_edges = {tuple(map(str, e[:3])) + (tuple(e[3]),)
               for e in old.get("edges", [])}
    n_edges = {tuple(map(str, e[:3])) + (tuple(e[3]),)
               for e in new.get("edges", [])}
    for e in sorted(o_edges - n_edges):
        lines.append(f"  - edge gone: {e}")
    for e in sorted(n_edges - o_edges):
        lines.append(f"  + edge new:  {e}")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.extract",
        description="influence-graph extraction from the perfmodel source")
    ap.add_argument("--check", action="store_true",
                    help="compare against the checked-in artifact")
    ap.add_argument("--write", action="store_true",
                    help="write the checked-in artifact")
    ap.add_argument("--json", action="store_true",
                    help="dump the full graph (with provenance) as JSON")
    ap.add_argument("--param", default=None,
                    help="render one parameter's influence chain")
    ap.add_argument("--probe", action="store_true",
                    help="cross-validate against the probe-based QualE map")
    ap.add_argument("--artifact", type=Path, default=ARTIFACT_PATH)
    ap.add_argument("--device", default=None,
                    help="--probe's evaluator device (default: the card)")
    args = ap.parse_args(argv)

    graph = extract_influence_graph()

    if args.write:
        args.artifact.write_text(
            json.dumps(graph.as_json(), indent=2) + "\n")
        print(f"wrote {args.artifact} ({len(graph.edges)} edges)")
        return 0

    if args.check:
        if not args.artifact.exists():
            print(f"FAIL: artifact {args.artifact} missing "
                  f"(run --write and commit it)")
            return 1
        old = load_artifact(args.artifact)
        diff = _diff_signatures(old.signature(), graph.signature())
        if diff:
            print("FAIL: extracted influence graph differs from the "
                  "checked-in artifact — a perfmodel change moved "
                  "influence edges:")
            print("\n".join(diff))
            return 1
        print(f"OK: influence graph matches {args.artifact} "
              f"({len(graph.edges)} edges, "
              f"primaries {graph.primary_resources()})")
        return 0

    if args.json:
        print(json.dumps(graph.as_json(), indent=2))
        return 0

    if args.param:
        print(graph.render_param(args.param))
        return 0

    if args.probe:
        from repro_torch.core.quale import derive_influence_map
        from repro_torch.perfmodel.evaluator import get_evaluator
        audit = cross_validate(graph, derive_influence_map(
            get_evaluator("proxy", device=args.device)))
        print(json.dumps(audit.as_dict(), indent=2))
        for line in audit.corrections():
            print(line)
        return 0

    print(f"params:  {', '.join(graph.params)}")
    print(f"derived: {', '.join(graph.derived)}")
    print(f"terms:   {', '.join(graph.terms)}  "
          f"(guards: {graph.guard_kinds})")
    print(f"stalls:  {', '.join(graph.stalls)}")
    print(f"metrics: {', '.join(graph.metrics)}")
    print(f"edges:   {len(graph.edges)}")
    print("primary relief (extracted AHK):")
    for c, p in sorted(graph.primary_resources().items()):
        sites = graph.provenance("stall->primary", c, p)
        print(f"  {c:16s} -> {p:14s}  [{'; '.join(sites)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
