"""The influence graph the reference extracts from its perfmodel source.

The port keeps its own copy of the artifact (``influence_graph.json``) and
one reader of it, :mod:`repro_torch.analysis.influence`; the extractor and
the linter are not ported yet.  The DSE loop reads the AHK primary edges
(:func:`primary_resources`) and audits its probe map against the graph
(:func:`cross_validate`).
"""
from repro_torch.analysis.influence import (InfluenceGraph, RuleAudit,
                                            cross_validate,
                                            extract_influence_graph,
                                            primary_resources)

__all__ = ["InfluenceGraph", "RuleAudit", "cross_validate",
           "extract_influence_graph", "primary_resources"]
