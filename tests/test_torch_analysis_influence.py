"""The port's influence-graph extractor over its own perfmodel source,
held to the reference's extraction over the reference's source.

The port's perfmodel is torch code, and two of its idioms have no
counterpart in the reference's ``jnp`` source: ``_dominant_class`` casts
its where-tree (``torch.where(...).to(torch.int32)``), and ``_op_terms``
places its op table with ``hwb["sa_dim"].device``.  Two fixture modules
pin how the extractor reads each, and a monkeypatch shows that the real
source fails to extract without either fix.
"""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.analysis.influence import (
    derive_influence_map_from_source as j_derive_from_source)
from repro.analysis.influence import derived_to_metrics as j_derived_to_metrics
from repro.analysis.influence import extract_influence_graph as j_extract
from repro.analysis.influence import primary_resources as j_primary
from repro_torch.analysis import influence as I
from repro_torch.analysis.dataflow import AnalysisError, ModuleIndex
from repro_torch.analysis.extract import main as extract_main
from repro_torch.analysis.influence import (ARTIFACT_PATH, EK_DERIVED_STALL,
                                            EK_DERIVED_TERM, EK_PARAM_DERIVED,
                                            EK_STALL_PRIMARY,
                                            derive_influence_map_from_source,
                                            derived_to_metrics,
                                            extract_influence_graph,
                                            load_artifact, primary_resources)

REPO = Path(__file__).resolve().parents[1]
PERFMODEL = "src/repro_torch/perfmodel/"


@pytest.fixture(scope="module")
def graphs():
    return extract_influence_graph(), j_extract()


def _index(sources):
    """A ModuleIndex over {module name: path}."""
    return ModuleIndex.build([SimpleNamespace(__name__=n, __file__=str(p))
                              for n, p in sources.items()])


def test_extraction_parses_the_ports_perfmodel(graphs):
    port, _ = graphs
    files = {s.rpartition(":")[0] for e in port.edges for s in e.sites}
    assert files and all(f.startswith(PERFMODEL) for f in files), files
    assert len(port.edges) == 57


def test_signature_equals_the_reference_extraction(graphs):
    port, ref = graphs
    assert port.signature() == ref.signature()
    assert port.signature() == load_artifact().signature()


@pytest.mark.parametrize("query", ["param_metrics", "stall_params",
                                   "param_derived", "derived_stalls",
                                   "derived_to_metrics", "primary_resources"])
def test_graph_queries_equal_the_reference_extraction(graphs, query):
    port, ref = graphs
    assert getattr(port, query)() == getattr(ref, query)()


def test_module_functions_equal_the_reference():
    assert primary_resources() == j_primary()
    assert derived_to_metrics() == j_derived_to_metrics()
    assert derive_influence_map_from_source() == j_derive_from_source()
    assert "vector_width" not in derived_to_metrics()


_LINES = {}


def _line(path: Path, n: int) -> str:
    if path not in _LINES:
        _LINES[path] = path.read_text().splitlines()
    lines = _LINES[path]
    assert 1 <= n <= len(lines), (path, n)
    return lines[n - 1]


def test_every_edge_has_real_provenance(graphs):
    """Each site names an existing line of the port's perfmodel; a key
    read's site (param -> derived, derived -> term / stall) holds the key
    the edge claims, and a primary edge's sites hold the parameter or a
    derived key it reaches."""
    port, _ = graphs
    reach = port.param_derived()
    for e in port.edges:
        assert e.sites, (e.kind, e.src, e.dst)
        for s in e.sites:
            fname, _, line = s.rpartition(":")
            assert fname.startswith(PERFMODEL), s
            text = _line(REPO / fname, int(line))
            if e.kind in (EK_PARAM_DERIVED, EK_DERIVED_TERM,
                          EK_DERIVED_STALL):
                assert f'"{e.src}"' in text, (e.kind, e.src, s, text)
            elif e.kind == EK_STALL_PRIMARY:
                keys = {e.dst} | reach[e.dst]
                assert any(f'"{k}"' in text for k in keys), (e, s, text)


def test_signature_ignores_line_drift(graphs, tmp_path):
    """The perfmodel with every line pushed down extracts to the same
    signature with other sites."""
    port, _ = graphs
    srcs = {}
    for mod in I._perfmodel_modules():
        p = tmp_path / "src/repro_torch/perfmodel" / Path(mod.__file__).name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("# moved\n\n\n" + Path(mod.__file__).read_text())
        srcs[mod.__name__] = p
    shifted = I._extract(_index(srcs))
    assert shifted.signature() == port.signature()
    assert shifted.as_json() != port.as_json()
    sig = json.dumps(port.signature())
    assert "line" not in sig and "site" not in sig


# ---------------------------------------------------------------------------
# the two torch idioms
# ---------------------------------------------------------------------------

CAST = """
    import torch
    A, B, C = 0, 1, 2

    def bare(t):
        x = t["x"] > t["y"]
        return torch.where(t["k"], A, torch.where(x, B, C))

    def cast(t):
        x = t["x"] > t["y"]
        return torch.where(t["k"], A, torch.where(x, B, C)).to(torch.int32)
"""

DEVICE = """
    def table(device):
        return {"flops": device}

    def term(hw):
        o = table(hw["place"].device)
        return o["flops"] / hw["peak"] + hw["place"].shape[0] * hw["peak"].ndim
"""


def _fixture(tmp_path, name, text):
    p = tmp_path / "src" / f"{name}.py"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    idx = _index({name: p})
    return idx, idx.modules[name]


def _leaves(idx, fn):
    return [(g, ast.dump(leaf))
            for g, leaf in I._branches(idx, fn, fn.returns[0][0],
                                       expand_locals=True)]


def test_cast_of_a_where_tree_has_the_bare_trees_leaves(tmp_path):
    idx, mod = _fixture(tmp_path, "cast_fixture", CAST)
    bare = _leaves(idx, mod.functions["bare"])
    assert _leaves(idx, mod.functions["cast"]) == bare
    assert [leaf for _, leaf in bare] == [ast.dump(ast.Name(n, ast.Load()))
                                          for n in "ABC"]


def test_cast_fails_without_its_fix(tmp_path, monkeypatch):
    idx, mod = _fixture(tmp_path, "cast_fixture", CAST)
    monkeypatch.setattr(I, "_is_cast", lambda e: False)
    got = _leaves(idx, mod.functions["cast"])
    assert got != _leaves(idx, mod.functions["bare"])
    assert len(got) == 1 and "attr='to'" in got[0][1]
    with pytest.raises(AnalysisError, match="non-constant attribution leaf"):
        I._extract(ModuleIndex.build(I._perfmodel_modules()))


def _keys(idx, fn):
    uses = I._key_uses(idx, fn, fn.returns[0][0], frozenset(["hw"]),
                       frozenset(), set())
    peaks = I._peak_keys(idx, [(fn, fn.returns[0][0], frozenset(["hw"]),
                                False)])
    return sorted({u.key for u in uses}), sorted({k for k, _ in peaks})


def test_tensor_metadata_reads_no_key(tmp_path):
    idx, mod = _fixture(tmp_path, "device_fixture", DEVICE)
    assert _keys(idx, mod.functions["term"]) == (["peak"], ["peak"])


def test_tensor_metadata_fails_without_its_fix(tmp_path, monkeypatch):
    idx, mod = _fixture(tmp_path, "device_fixture", DEVICE)
    monkeypatch.setattr(I, "_METADATA_ATTRS", frozenset())
    uses, _ = _keys(idx, mod.functions["term"])
    assert uses == ["peak", "place"]
    with pytest.raises(AnalysisError, match="primary parameter not unique"):
        I._extract(ModuleIndex.build(I._perfmodel_modules()))


def test_an_unknown_source_shape_still_raises(tmp_path):
    idx, mod = _fixture(tmp_path, "leaf_fixture", """
        import torch
        def dom(t):
            return torch.where(t["k"], 0, 1).float()
    """)
    fn = mod.functions["dom"]
    (_, leaf), = I._branches(idx, fn, fn.returns[0][0])
    assert isinstance(leaf, ast.Call)          # .float() is not peeled


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_check_passes_without_jax():
    code = ("import json, sys\n"
            "from repro_torch.analysis.extract import main\n"
            "rc = main(['--check'])\n"
            "print(json.dumps([rc, sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'repro.')) or m == 'repro')]))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rc, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and loaded == []
    assert "OK: influence graph matches" in out.stdout


def test_check_fails_on_a_tampered_artifact(tmp_path, capsys):
    d = json.loads(ARTIFACT_PATH.read_text())
    gone = d["edges"].pop(0)
    d["primary"]["memory_bw"] = "sram_kb"
    bad = tmp_path / "influence_graph.json"
    bad.write_text(json.dumps(d))
    assert extract_main(["--check", "--artifact", str(bad)]) == 1
    out = capsys.readouterr().out
    assert out.startswith("FAIL")
    assert "+ edge new:  ('%s', '%s', '%s'" % (gone["kind"], gone["src"],
                                               gone["dst"]) in out
    assert re.search(r"primary: .*'sram_kb'.* -> .*'mem_channels'", out)
    assert extract_main(["--check", "--artifact",
                         str(tmp_path / "missing.json")]) == 1


def test_cli_renders_the_extracted_graph(capsys):
    assert extract_main(["--param", "mem_channels"]) == 0
    txt = capsys.readouterr().out
    assert "mem_bw" in txt and "memory_bw" in txt and PERFMODEL in txt
    assert extract_main(["--json"]) == 0
    assert json.loads(capsys.readouterr().out)["primary"] == \
        primary_resources()
    assert extract_main([]) == 0
    assert "primary relief (extracted AHK):" in capsys.readouterr().out
