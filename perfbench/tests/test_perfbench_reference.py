"""The plain reference against the port at small sizes on the CPU, from
the same weights the harness makes.  The checks over every configuration
reach its family's reference by the name the configuration gives; the
others name the lm family's configurations."""
import pytest
import torch

from perfbench import bench, program, reference
from perfbench.kinds import prefill, train
from perfbench.reference import lm
from perfbench.tests._small import BENCH, CONFIGS, small_model
from perfbench.weights import make_weights

CPU = torch.device("cpu")


def full_conf(name):
    """The configuration file BENCHMARK.json names `name`."""
    bench.import_program()
    return bench.config_file(BENCH, name)


def conf(name):
    c = full_conf(name)
    return dict(c, model=dict(c["model"], **small_model(name)))


def routes(c, follow=None):
    """The MoE reference's routing for configuration `c` (None without
    experts): its capacity factor, the lists it fills, what it follows."""
    if not c["model"].get("n_experts"):
        return None
    return {"capacity": c.get("moe_capacity", 1.25), "own": [],
            "margins": [], "follow": follow}


def check_layout(full):
    """The names and shapes of the weights of the configuration `full`
    (at its own size) by its reference are the port's model's."""
    bench.import_program()
    from repro_torch.models import build_model
    m = build_model(program.arch_config(full["model"]),
                    dtype=torch.float32, device="meta")
    assert dict(reference.of(full).param_spec(full["model"])) == {
        n: tuple(p.shape) for n, p in m.named_parameters()}


def check_prefill_logits(c):
    """The port's prefill logits of the configuration `c` (at a small
    size) are its reference's, from the same weights, and not another
    seed's."""
    ref = reference.of(c)
    w = make_weights(c, 7, CPU)
    model = program.build(c, w, CPU)
    toks = torch.randint(0, c["model"]["vocab"], (2, 48),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.forward({"tokens": toks})
    want = ref.logits(make_weights(c, 7, CPU), toks, c["model"], routes(c))
    g = prefill.gaps(got, want)
    assert float(g.max()) < 1e-5
    # the reference is not the program's own output: other weights differ
    other = ref.logits(make_weights(c, 8, CPU), toks, c["model"], routes(c))
    assert float(prefill.gaps(got, other).median()) > 0.1


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_is_the_port_s(name):
    check_layout(full_conf(name))


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_match(name):
    check_prefill_logits(conf(name))


def test_moe_drops_overflow_as_the_port_does():
    c = conf("qwen2-moe-a2.7b")
    c["moe_capacity"] = 0.5                 # half the assignments dropped
    w = make_weights(c, 3, CPU)
    model = program.build(c, w, CPU)
    toks = torch.randint(0, 256, (2, 48),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.forward({"tokens": toks})
    assert float(prefill.gaps(got, lm.logits(w, toks, c["model"],
                                             routes(c))).max()) < 1e-5
    assert float(prefill.gaps(got, lm.logits(
        w, toks, c["model"], routes(dict(c, moe_capacity=1.25)))).max()) \
        > 1e-3


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
    a = c["model"]
    w = make_weights(c, 4, CPU)
    toks = torch.randint(0, 256, (2, 48),
                         generator=torch.Generator().manual_seed(3))
    own = routes(c)
    ref = lm.logits(w, toks, a, own)
    assert len(own["own"]) == len(own["margins"]) == a["n_layers"]
    # following its own choice changes nothing and parts nowhere
    same = routes(c, own["own"])
    assert torch.equal(lm.logits(w, toks, a, same), ref)
    assert prefill.flip_margins(own["own"], same).numel() == 0
    # another choice is followed, and each decision that differs is read
    other = [o.clone() for o in own["own"]]
    unused = sorted(set(range(a["n_experts"]))
                    - set(other[0][0, 5].tolist()))
    other[0][0, 5, 0] = unused[0]
    moved = routes(c, other)
    assert float(prefill.gaps(lm.logits(w, toks, a, moved), ref)
                 .max()) > 1e-3
    assert prefill.flip_margins(other, moved).numel() >= 1
