"""The port's copy of the influence graph the reference extracts from its
perfmodel source (``influence_graph.json``), and a loader for its parts.

The extractor itself (``repro.analysis``) is not ported yet; the artifact
is what the DSE loop needs from it: the AHK primary edges.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict

GRAPH_PATH = Path(__file__).with_name("influence_graph.json")


@functools.lru_cache(maxsize=1)
def _graph() -> dict:
    with open(GRAPH_PATH, encoding="utf-8") as f:
        return json.load(f)


def primary_resources() -> Dict[str, str]:
    """stall class -> the parameter that most directly relieves it (the AHK
    primary edges, key ``"primary"`` of the graph)."""
    return dict(_graph()["primary"])
