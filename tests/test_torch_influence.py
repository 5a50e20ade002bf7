"""The port's influence graph (extracted from the port's perfmodel
source), its artifact reader, static influence map and rule audit against
the reference's extraction from its perfmodel source."""
import re

import pytest
import torch

from repro.analysis.influence import (cross_validate as j_cross_validate,
                                      extract_influence_graph as j_extract,
                                      load_artifact as j_load_artifact)
from repro.core.loop import LuminaDSE as JLuminaDSE
from repro.core.quale import derive_influence_map as j_derive
from repro.core.quale import static_influence_map as j_static
from repro.perfmodel import get_evaluator as j_get_evaluator
from repro_torch.analysis import primary_resources
from repro_torch.analysis.influence import (ARTIFACT_PATH, EK_PARAM_DERIVED,
                                            InfluenceGraph, RuleAudit,
                                            cross_validate,
                                            extract_influence_graph,
                                            load_artifact)
from repro_torch.core.loop import LuminaDSE
from repro_torch.core.quale import derive_influence_map, static_influence_map
from repro_torch.perfmodel import get_evaluator
from repro_torch.perfmodel.critical_path import STALL_CLASSES
from repro_torch.perfmodel.designspace import PARAM_NAMES

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return extract_influence_graph(), j_extract()


@pytest.fixture(scope="module")
def probes():
    port = derive_influence_map(get_evaluator("proxy", device="cpu"))
    ref = j_derive(j_get_evaluator("proxy"))
    return port, ref


def test_signature_equals_the_reference_extraction(graphs):
    """The port's extraction from its own source is the graph the
    reference extracts from its source, and the port's copy of the
    artifact is that graph too, not a stale one."""
    port, ref = graphs
    assert port.signature() == ref.signature()
    assert load_artifact().signature() == ref.signature()
    assert port.params == tuple(PARAM_NAMES)
    assert port.stalls == tuple(STALL_CLASSES)


@pytest.mark.parametrize("query", ["param_metrics", "stall_params",
                                   "param_derived", "derived_stalls",
                                   "derived_to_metrics", "primary_resources"])
def test_graph_queries_equal_the_reference(graphs, query):
    port, ref = graphs
    assert getattr(port, query)() == getattr(ref, query)()


def test_params_for_stall_and_rendering_equal_the_reference(graphs):
    port, ref = graphs
    for stall in STALL_CLASSES:
        assert port.params_for_stall(stall) == ref.params_for_stall(stall)
    # the port's artifact is the reference's, provenance lines included;
    # the extraction names the port's own lines, so it is held to the
    # artifact's signature and to its rendering without the sites
    artifact = j_load_artifact()
    assert load_artifact().as_json() == artifact.as_json()
    assert port.signature() == artifact.signature()

    def unsited(txt):
        return re.sub(r"@ \S+", "@", txt)
    for p in PARAM_NAMES:
        assert load_artifact().render_param(p) == artifact.render_param(p)
        assert unsited(port.render_param(p)) == \
            unsited(artifact.render_param(p))
    e = port.edges_of(EK_PARAM_DERIVED)[0]
    assert port.provenance(e.kind, e.src, e.dst) == e.sites != ()
    with pytest.raises(KeyError):
        port.render_param("not_a_param")


def test_reader_round_trips_and_loads_once(graphs):
    port, _ = graphs
    assert InfluenceGraph.from_json(port.as_json()) == port
    assert load_artifact(ARTIFACT_PATH) == \
        InfluenceGraph.from_json(j_load_artifact().as_json())
    assert load_artifact(ARTIFACT_PATH).signature() == port.signature()
    assert extract_influence_graph() is port          # extracted once
    assert primary_resources() == port.primary


def test_static_influence_map_equals_the_reference():
    port, ref = static_influence_map(), j_static()
    assert port.metric_edges == ref.metric_edges
    assert port.stall_edges == ref.stall_edges
    assert port.as_prompt() == ref.as_prompt()


def test_cross_validate_equals_the_reference(graphs, probes):
    port_g, ref_g = graphs
    port_p, ref_p = probes
    assert port_p.metric_edges == ref_p.metric_edges
    assert port_p.stall_edges == ref_p.stall_edges
    audit = cross_validate(port_g, port_p)
    want = j_cross_validate(ref_g, ref_p)
    assert isinstance(audit, RuleAudit)
    assert audit.as_dict() == want.as_dict()
    assert audit.corrections() == want.corrections()
    assert audit.metric_probe_only == want.metric_probe_only
    # the same probe map through either reader gives the same audit
    assert cross_validate(port_g, ref_p).as_dict() == want.as_dict()


def test_rule_audit_equals_the_reference():
    port = LuminaDSE(get_evaluator("proxy", device="cpu"), seed=0)
    ref = JLuminaDSE(j_get_evaluator("proxy"), seed=0)
    audit = port.rule_audit()
    assert audit.as_dict() == ref.rule_audit().as_dict()
    assert audit.counts()["metric_probe_only"] == 0
    # an injected static map audits clean against its own graph
    static = LuminaDSE(get_evaluator("proxy", device="cpu"),
                       imap=static_influence_map())
    counts = static.rule_audit().counts()
    assert counts["metric_probe_only"] == counts["stall_probe_only"] == 0
    assert counts["metric_source_only"] == counts["stall_source_only"] == 0
