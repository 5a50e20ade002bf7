"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name through the harness."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import bench, reference

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"]
    assert B["paths"] == ["perfbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert (ROOT / "perfbench" / "run.py").is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("key,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(key, keys):
    for e in B[key]:
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert keys <= set(e) <= keys | extra, e
        assert NAME.match(e["name"]), e["name"]
    names = [e["name"] for e in B[key]]
    assert len(names) == len(set(names))


def test_names_units_and_lines():
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in B["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in B["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(e["layer"])
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for c in B["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_metric_is_reported_somewhere_it_applies():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {e["name"]: e for e in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in cells:
        reported = [e for e in B["end_to_end"] if bench._applies(e, w)]
        assert len(reported) >= 2 and any(e["name"] == "setup_s"
                                          for e in reported)
        assert any(bench._applies(m, w) for m in B["per_layer"])
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells and bench._applies(e2e[m["moves"]], w)


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_each_cell_finds_its_files_by_name(w):
    c = bench.cell(B, w)
    conf = bench.config_file(B, c["config"])
    assert conf["name"] == c["config"]
    mix = bench.traffic(c["traffic"])
    kind = bench.kind_module(mix["kind"])
    assert hasattr(kind, "Job")
    lim = bench.limits(w)
    assert lim["compare"] and all(
        v["limit"] >= 0 for v in lim["compare"].values())
    for m in bench.cell_metrics(B, w, True):
        assert callable(bench.metric_reader(m["name"]).read)


def compared(ref, model: dict) -> dict:
    """Published key -> model field of every key the reference `ref`
    compares for `model`: its ``PUBLISHED``, and each ``PUBLISHED_WHEN``
    mapping whose field the model sets."""
    keys = dict(ref.PUBLISHED)
    for field, more in getattr(ref, "PUBLISHED_WHEN", {}).items():
        if model.get(field):
            keys.update(more)
    return keys


def check_config(entry: dict, conf: dict) -> None:
    """A configuration file against its BENCHMARK.json entry: the same
    source and cut, and every published key its own reference compares
    (:func:`compared`) equal to the field it sets (smaller where the key
    is in ``reduced``); a key missing from ``published`` fails."""
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    ref = reference.of(conf)
    pub, run = conf["published"], conf["model"]
    assert ref.PUBLISHED
    for key, field in compared(ref, run).items():
        assert key in pub, f"{key} missing from published"
        if key in conf["reduced"]:
            assert run[field] < pub[key], key
        else:
            assert run[field] == pub[key], key
    assert ref.param_spec(run)


def test_config_files_state_their_cut():
    for c in B["configs"]:
        check_config(c, json.loads((ROOT / c["file"]).read_text()))


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_metric_readers_import_nothing_of_the_program():
    for p in (ROOT / "perfbench" / "metrics").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                assert all(m.split(".")[0] == "perfbench" for m in mods), p
