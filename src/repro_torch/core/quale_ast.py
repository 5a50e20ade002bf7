"""DEPRECATED shim: the AST-based QualE path lives in
:mod:`repro_torch.analysis.influence`.

The port's counterpart of ``repro.core.quale_ast``: the reference's
single-file walker grew into the interprocedural extractor of its
``analysis`` package, which the port carries as
:mod:`repro_torch.analysis` (guard-aware dataflow, ``file:line``
provenance, stall/term edges and the AHK primaries, held to the checked-in
artifact by ``python -m repro_torch.analysis.extract --check``).  This
module re-exports the compatible surface and warns on import; new code
should import from :mod:`repro_torch.analysis.influence` directly.

As in the reference, ``DERIVED_TO_METRICS`` is the extracted table: it
holds only edges that exist in the source, so the ``vector_width``
passthrough key, which no roofline term reads (``vector_flops`` carries
its influence), is not in it.  Param-level results are unchanged.
"""
from __future__ import annotations

import warnings

from repro_torch.analysis.influence import derive_influence_map_from_source

__all__ = ["derive_influence_map_from_source", "DERIVED_TO_METRICS"]

warnings.warn(
    "repro_torch.core.quale_ast is deprecated; use "
    "repro_torch.analysis.influence (the interprocedural extractor) instead",
    DeprecationWarning, stacklevel=2)


def __getattr__(name):
    if name == "DERIVED_TO_METRICS":
        from repro_torch.analysis.influence import derived_to_metrics
        return {k: set(v) for k, v in derived_to_metrics().items()}
    raise AttributeError(name)
