"""The plain reference against the port at small sizes on the CPU, from
the same weights the harness makes."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import bench, program
from perfbench.kinds import prefill, train
from perfbench.reference import lm
from perfbench.tests._small import SMALL
from perfbench.weights import make_weights

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def conf(name):
    bench.import_program()
    c = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                   .read_text())
    return dict(c, model=dict(c["model"], **SMALL[name]))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_layout_is_the_port_s(name):
    bench.import_program()
    from repro_torch.models import build_model
    full = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())
    m = build_model(program.arch_config(full["model"]),
                    dtype=torch.float32, device="meta")
    assert dict(lm.param_spec(full["model"])) == {
        n: tuple(p.shape) for n, p in m.named_parameters()}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_prefill_logits_match(name):
    c = conf(name)
    w = make_weights(c["model"], 7, CPU)
    model = program.build(c, w, CPU)
    toks = torch.randint(0, c["model"]["vocab"], (2, 48),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.forward({"tokens": toks})
    ref = lm.logits(make_weights(c["model"], 7, CPU), toks, c["model"],
                    c.get("moe_capacity", 1.25))
    g = prefill.gaps(got, ref)
    assert float(g.max()) < 1e-5
    # the reference is not the program's own output: other weights differ
    other = lm.logits(make_weights(c["model"], 8, CPU), toks, c["model"])
    assert float(prefill.gaps(got, other).median()) > 0.1


def test_moe_drops_overflow_as_the_port_does():
    c = conf("qwen2-moe-a2.7b")
    c["moe_capacity"] = 0.5                 # half the assignments dropped
    w = make_weights(c["model"], 3, CPU)
    model = program.build(c, w, CPU)
    toks = torch.randint(0, 256, (2, 48),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.forward({"tokens": toks})
    assert float(prefill.gaps(got, lm.logits(w, toks, c["model"], 0.5))
                 .max()) < 1e-5
    assert float(prefill.gaps(got, lm.logits(w, toks, c["model"], 1.25))
                 .max()) > 1e-3


def test_train_steps_match():
    c = conf("qwen2.5-14b-6l")
    mix = {"kind": "train", "batch": 2, "seq": 48, "setup_steps": 3}
    job = train.Job(c, mix, 5, CPU)
    job.setup()
    job.step(0)                      # the window's first step
    job.close_window()
    ref = job.reference()
    nums = job.numbers(job.read, ref)
    assert nums["loss_gap"] < 1e-6
    assert nums["grad_gap"] < 1e-5
    assert nums["change_gap"] < 1e-3
    assert len(ref["loss"]) == len(job.read["loss"]) == 4
    assert ref["loss"][0] > ref["loss"][2] * 0.5


def test_reference_follows_the_routing_it_is_given():
    c = conf("qwen2-moe-a2.7b")
    a, cf = c["model"], c.get("moe_capacity", 1.25)
    w = make_weights(a, 4, CPU)
    toks = torch.randint(0, 256, (2, 48),
                         generator=torch.Generator().manual_seed(3))
    own = {"own": [], "margins": [], "follow": None}
    ref = lm.logits(w, toks, a, cf, own)
    assert len(own["own"]) == len(own["margins"]) == a["n_layers"]
    # following its own choice changes nothing and parts nowhere
    same = {"own": [], "margins": [], "follow": own["own"]}
    assert torch.equal(lm.logits(w, toks, a, cf, same), ref)
    assert prefill.flip_margins(own["own"], same).numel() == 0
    # another choice is followed, and each decision that differs is read
    other = [o.clone() for o in own["own"]]
    unused = sorted(set(range(a["n_experts"]))
                    - set(other[0][0, 5].tolist()))
    other[0][0, 5, 0] = unused[0]
    moved = {"own": [], "margins": [], "follow": other}
    assert float(prefill.gaps(lm.logits(w, toks, a, cf, moved), ref)
                 .max()) > 1e-3
    assert prefill.flip_margins(other, moved).numel() >= 1
