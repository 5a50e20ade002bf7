"""``repro_torch.core.quale_ast``, the deprecation shim over the port's
extractor, against the reference's shim: it warns on import, and its
source map and ``DERIVED_TO_METRICS`` are the reference's."""
import importlib
import warnings

import pytest
import torch

from repro_torch.core.quale import derive_influence_map
from repro_torch.perfmodel import get_evaluator
from repro_torch.perfmodel.designspace import PARAM_NAMES

torch.set_num_threads(1)


def _import(name):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mod = importlib.reload(importlib.import_module(name))
    return mod, w


@pytest.fixture(scope="module")
def shims():
    return _import("repro_torch.core.quale_ast")[0], \
        _import("repro.core.quale_ast")[0]


def test_shim_warns_deprecation():
    qa, w = _import("repro_torch.core.quale_ast")
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert dep and "repro_torch.analysis.influence" in str(dep[0].message)
    assert callable(qa.derive_influence_map_from_source)
    assert qa.__all__ == ["derive_influence_map_from_source",
                          "DERIVED_TO_METRICS"]


def test_source_map_and_table_equal_the_reference(shims):
    port, ref = shims
    assert port.derive_influence_map_from_source() == \
        ref.derive_influence_map_from_source()
    assert port.DERIVED_TO_METRICS == ref.DERIVED_TO_METRICS
    assert port.DERIVED_TO_METRICS["tensor_flops"] == {"ttft", "tpot"}
    assert port.DERIVED_TO_METRICS["area_mm2"] == {"area"}
    assert "vector_width" not in port.DERIVED_TO_METRICS
    with pytest.raises(AttributeError):
        port.not_an_attr


def test_source_map_covers_probed_map(shims):
    """Static reachability over-approximates the influence the port's
    probes observe on the CPU evaluator, for every parameter."""
    src_map = shims[0].derive_influence_map_from_source()
    probed = derive_influence_map(get_evaluator("proxy", device="cpu"),
                                  n_probes=6, seed=0)
    for p in PARAM_NAMES:
        assert "area" in src_map[p], p
        assert probed.metric_edges[p] <= src_map[p], (
            p, probed.metric_edges[p], src_map[p])
