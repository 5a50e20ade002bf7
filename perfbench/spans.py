"""The program's own spans of the traced window, for the readers of the
``program_span`` and ``program_counter`` metrics.

The program's process tracer (``repro_torch.obs.PROCESS_TRACER``) records
only while ``torch.profiler`` records, so in a run of the harness its
buffer holds the spans of the traced window alone.  Reading them resolves
their device events and tensor counts (after the window's sync).  A
program without that tracer gives no spans, and each reader then reports
nothing."""
from __future__ import annotations

import importlib
from typing import Iterable, List, Optional


def window() -> list:
    """Every span the program's process tracer holds; [] when the program
    has no such tracer."""
    try:
        obs = importlib.import_module("repro_torch.obs")
    except ImportError:
        return []
    tracer = getattr(obs, "PROCESS_TRACER", None)
    return [] if tracer is None else tracer.spans()


def named(name: str) -> List:
    return [s for s in window() if s.name == name]


def per_chunk_ms(names: Iterable[str]) -> Optional[float]:
    """The host ms of the sweep spans named `names`, summed, over the
    window's chunks (``sweep.chunk`` spans); None without either."""
    names = set(names)
    spans = window()
    chunks = sum(1 for s in spans if s.name == "sweep.chunk")
    parts = [s for s in spans if s.name in names]
    if not chunks or not parts:
        return None
    return 1e3 * sum(s.t_end - s.t_start for s in parts) / chunks


def attr_sums(name: str, *keys: str) -> Optional[List[float]]:
    """The sums of attrs `keys` over the spans named `name` that carry all
    of them; None where none does."""
    got = [s.attrs for s in named(name) if all(k in s.attrs for k in keys)]
    if not got:
        return None
    return [float(sum(a[k] for a in got)) for k in keys]
