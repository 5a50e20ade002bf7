"""A configuration names its family's reference and cost module, and the
harness reaches them by that name alone: the weights, the kinds, the
``mfu`` readers and the configuration check.  A stand-in family,
registered here only, goes through every one of them."""
import ast
import copy
import hashlib
import json
import sys
import types
from collections import Counter
from pathlib import Path

import pytest
import torch

from perfbench import bench, costs, reference
from perfbench.costs import peaks
from perfbench.kinds import train
from perfbench.reference import lm
from perfbench.tests import _small, test_perfbench_files as files
from perfbench.tests._small import CONFIGS, small, small_model
from perfbench.tests.test_perfbench_files import check_config
from perfbench.tests.test_perfbench_reference import (check_layout,
                                                      check_prefill_logits)
from perfbench.weights import make_weights

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
B = json.loads((ROOT / "BENCHMARK.json").read_text())

# sha256 over each leaf's name and bytes, in param_spec's order, of the
# weights make_weights gave at the small sizes before the lookup existed
# (when weights.py took lm's param_spec and scaled each leaf itself)
PARENT_SUMS = {
    ("qwen2-moe-a2.7b", 0):
        "c26fa8e413df3b72a4bb46942a54fcafa39a3224edca40ad4f3c85a8078dcb2c",
    ("qwen2-moe-a2.7b", 1):
        "131417969afb88e110af68cb2a0f37bd522b6eaec699519c8d2ac4a671e7e48e",
    ("qwen2.5-14b-6l", 0):
        "4d446e9654712c499044d6d530b8523db14a92c5d6f0e0d606a099daa65c58c1",
    ("qwen2.5-14b-6l", 1):
        "a3ff66725f896b7778c0254197874ec407a118ebc26d0f6935298ed6b595ce4d",
}


def config(name: str) -> dict:
    return bench.config_file(B, name)


def small_conf(name: str) -> dict:
    c = config(name)
    return dict(c, model=dict(c["model"], **small_model(name)))


def checksum(weights: dict) -> str:
    h = hashlib.sha256()
    for n, t in weights.items():
        h.update(n.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(PARENT_SUMS))
def test_weights_are_the_bytes_they_were(name, seed):
    assert checksum(make_weights(small_conf(name), seed, CPU)) \
        == PARENT_SUMS[(name, seed)]


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_has_a_small_file(cell):
    s = small(cell)
    assert isinstance(s["traffic"], dict)
    assert s["model"] is None or isinstance(s["model"], dict)


@pytest.mark.parametrize("name", CONFIGS)
def test_each_configuration_has_one_small_model(name):
    assert small_model(name)["n_layers"] >= 1


def test_cells_of_one_configuration_that_differ_in_size_fail(monkeypatch):
    name = "qwen2.5-14b-6l"
    real = _small.small

    def small_of(cell):
        s = real(cell)
        if cell.endswith(".train"):
            s = dict(s, model=dict(s["model"], d_ff=96))
        return s
    monkeypatch.setattr(_small, "small", small_of)
    with pytest.raises(ValueError, match=name):
        small_model(name)


def check_modules(conf):
    """The configuration's reference and cost modules give the contract."""
    ref, cost = reference.of(conf), costs.of(conf)
    for fn in ("param_spec", "init_leaf", "precision", "logits", "loss",
               "train_steps"):
        assert callable(getattr(ref, fn)), fn
    assert isinstance(ref.PUBLISHED, dict) and ref.PUBLISHED
    assert callable(cost.prefill_flops) and callable(cost.train_flops)


@pytest.mark.parametrize("name", CONFIGS)
def test_each_configuration_names_its_reference_and_costs(name):
    check_modules(config(name))


def test_only_lm_s_own_files_import_lm():
    """The kinds, the weights and the mfu readers reach the lm family by
    the configuration's name; flash_attention's readers cost that kernel
    by name, so they import its cost functions."""
    pb = ROOT / "perfbench"
    own = {pb / "reference" / "lm.py", pb / "costs" / "lm.py"}
    for p in pb.rglob("*.py"):
        if p in own or "tests" in p.parts or \
                p.name.startswith("flash_attention"):
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom):
                mods = [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            assert not any(m.endswith((".reference.lm", ".costs.lm"))
                           for m in mods), (p, mods)


# ------------------------------------------------------------- a stand-in
STANDIN_PUBLISHED = {"hidden_size": "d_model", "num_hidden_layers":
                     "n_layers", "vocab_size": "vocab",
                     "layer_norm_epsilon": "norm_eps"}
STANDIN_FLOPS = 7.0e12


def _standin(calls: Counter, decay: bool = True):
    """A reference module and a cost module of a family named "standin":
    lm's functions, a PUBLISHED mapping over other keys, where `decay` a
    1-D ``decay`` leaf after lm's (whose own init_leaf cannot scale a 1-D
    matrix), and a fixed FLOP count; every call counted in `calls`."""
    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    def param_spec(model):
        return lm.param_spec(model) + (
            [("decay", (model["d_model"],))] if decay else [])

    def init_leaf(name, t):
        if name == "decay":
            t.mul_(0.5).sub_(6.0)
        else:
            lm.init_leaf(name, t)

    ref = types.ModuleType("perfbench.reference.standin")
    ref.PUBLISHED = STANDIN_PUBLISHED
    for name, fn in (("param_spec", param_spec), ("init_leaf", init_leaf),
                     ("precision", lm.precision), ("logits", lm.logits),
                     ("loss", lm.loss), ("train_steps", lm.train_steps)):
        setattr(ref, name, counted(name, fn))
    cost = types.ModuleType("perfbench.costs.standin")
    cost.prefill_flops = counted("prefill_flops",
                                 lambda model, b, s: STANDIN_FLOPS / 3)
    cost.train_flops = counted("train_flops",
                               lambda model, b, s: STANDIN_FLOPS)
    return ref, cost


def _register(monkeypatch, decay: bool = True):
    """The stand-in's modules registered for this test alone, and a copy
    of the qwen2.5 configuration that names them."""
    calls = Counter()
    ref, cost = _standin(calls, decay)
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setitem(sys.modules, cost.__name__, cost)
    full = copy.deepcopy(config("qwen2.5-14b-6l"))
    full["name"] = full["model"]["name"] = "standin"
    full["reference"] = "standin"
    full["published"] = {"hidden_size": 5120, "num_hidden_layers": 48,
                         "vocab_size": 152064, "layer_norm_epsilon": 1e-05}
    return calls, full


@pytest.fixture
def standin(monkeypatch):
    return _register(monkeypatch)


def test_a_stand_in_family_goes_through_every_lookup(standin):
    calls, full = standin
    # lm's init_leaf cannot scale the stand-in's 1-D leaf
    with pytest.raises(IndexError):
        lm.init_leaf("decay", torch.zeros(4))

    # the configuration check compares the stand-in's keys: five of lm's
    # are not published here, so lm's mapping would fail this file
    assert len(set(lm.PUBLISHED) - set(full["published"])) == 5
    check_config({"source": full["source"], "reduced": full["reduced"]},
                 full)
    assert calls["param_spec"] == 1

    # the weights: its spec and its init, the 1-D leaf included
    conf = dict(full, model=dict(full["model"],
                                 **small_model("qwen2.5-14b-6l")))
    w = make_weights(conf, 0, CPU)
    assert list(w)[-1] == "decay" and float(w["decay"].mean()) < -5.0
    assert calls["init_leaf"] == len(w)

    # the train kind's reference: its precision, steps and loss
    mix = {"kind": "train", "batch": 2, "seq": 16, "setup_steps": 2}
    out = train.Job(conf, mix, 3, CPU).reference()
    assert len(out["loss"]) == 3 and "decay" in out["grad"]
    assert calls["train_steps"] == 1 and calls["loss"] == 1
    assert calls["precision"] == 1

    # the mfu readers: its FLOP counts
    ctx = types.SimpleNamespace(conf=conf, model=conf["model"],
                                mix={"batch": 1, "seq": 4096}, units=3,
                                window_s=2.0)
    got = bench.metric_reader("mfu.train").read(ctx)
    assert got == pytest.approx(100.0 * STANDIN_FLOPS * 3 / 2.0
                                / peaks.FP32_MODEL_PEAK, rel=1e-12)
    got = bench.metric_reader("mfu.prefill").read(ctx)
    assert got == pytest.approx(100.0 * STANDIN_FLOPS / 3 * 3 / 2.0
                                / peaks.FP32_MODEL_PEAK, rel=1e-12)
    assert calls["train_flops"] == calls["prefill_flops"] == 1


def test_a_stand_in_configuration_missing_a_key_fails(standin):
    _, full = standin
    del full["published"]["layer_norm_epsilon"]
    with pytest.raises(AssertionError, match="layer_norm_epsilon"):
        check_config({"source": full["source"], "reduced": full["reduced"]},
                     full)


@pytest.mark.parametrize("key", sorted(lm.PUBLISHED))
def test_a_published_key_removed_fails_the_config_check(key):
    entry = next(c for c in B["configs"] if c["name"] == "qwen2.5-14b-6l")
    conf = copy.deepcopy(config("qwen2.5-14b-6l"))
    check_config(entry, conf)
    del conf["published"][key]
    with pytest.raises(AssertionError, match=key):
        check_config(entry, conf)


def test_the_checks_over_every_configuration_take_a_stand_in(monkeypatch,
                                                             tmp_path):
    """The stand-in (its layout lm's, so the port can load its weights)
    listed in BENCHMARK.json's configurations passes the checks that run
    over every configuration, each through its own modules."""
    calls, full = _register(monkeypatch, decay=False)
    path = tmp_path / "standin.json"
    path.write_text(json.dumps(full))
    entry = {"name": "standin", "source": full["source"], "file": str(path),
             "reduced": full["reduced"], "why": "a stand-in family"}
    monkeypatch.setitem(files.B, "configs", files.B["configs"] + [entry])
    files.test_config_files_state_their_cut()
    assert calls["param_spec"] == 1
    check_modules(full)
    check_layout(full)
    assert calls["param_spec"] == 2
    check_prefill_logits(dict(full, model=dict(
        full["model"], **small_model("qwen2.5-14b-6l"))))
    assert calls["logits"] == 2 and calls["init_leaf"] > 0


@pytest.mark.parametrize("key", sorted(lm.PUBLISHED_WHEN["n_experts"]))
def test_an_expert_key_removed_fails_the_config_check(key):
    entry = next(c for c in B["configs"] if c["name"] == "qwen2-moe-a2.7b")
    conf = copy.deepcopy(config("qwen2-moe-a2.7b"))
    check_config(entry, conf)
    del conf["published"][key]
    with pytest.raises(AssertionError, match=key):
        check_config(entry, conf)
