"""Finch's layer (RWKV-6's published block, selected by ``ArchConfig``'s
``rwkv_mix_lora`` and ``rwkv_decay_lora``) in the port, against the plain
reference the benchmark keeps (``perfbench/reference/rwkv6.py``, plain
torch importing nothing of the port), on the CPU at the benchmark's small
size of ``rwkv6.train`` (``perfbench/tests/small/rwkv6.train.json``: head
size 16, mix LoRA rank 8 below decay LoRA rank 16), from the weights the
benchmark draws from a seed.

Tolerances, each read against the same comparison with the reference's
products in TF32 (each input rounded to 10 mantissa bits, the precision
below the configuration's), seeds 1-3: fp32 reorderings read logits
0.9e-6-1.4e-6 of the reference logits' standard deviation, gradients
6.5e-7-8.8e-7 of the larger of the leaf's and the median leaf's norm, the
loss 0-1.6e-7 of itself; the TF32 reference reads 1.4e-3, 2.8e-4-3.1e-4
and 1.6e-7-1.1e-5.  So the logits' 1e-4 and the gradients' 2e-5 sit 20x
or more above fp32 and 14x below TF32, which fails both (and bf16 the
more); the loss's 1e-6 bounds fp32 alone.
"""
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import program  # noqa: E402
from perfbench.reference import rwkv6 as ref  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.launch.shardings import param_specs  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import PROCESS_TRACER  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
CONF = json.loads((ROOT / "perfbench" / "configs"
                   / "rwkv6-finch-7b-16l.json").read_text())
SMALL = dict(CONF, model=dict(CONF["model"], **json.loads(
    (ROOT / "perfbench" / "tests" / "small" / "rwkv6.train.json")
    .read_text())["model"]))
A = SMALL["model"]
LOGIT_TOL, GRAD_TOL, LOSS_TOL = 1e-4, 2e-5, 1e-6
# the AdamW step's parameter change, per leaf over the larger of its and
# the median leaf's norm.  A first Adam step is ~lr sign(g), so an entry
# whose gradient is within rounding of 0 moves by lr either way: fp32
# reads 9.7e-5-7.8e-4 over seeds 4-7, TF32 0.052-0.24
CHANGE_TOL = 1e-2

# sha256 (first 16 hex digits) of [name, shape] of every parameter, in
# order, of each ARCHS entry and its smoke() built on the meta device,
# read before Finch's layout existed
LAYOUTS = {
    "arctic-480b": ("fe3ccb021122823f", "2e2f35071a22049f"),
    "codeqwen1.5-7b": ("d8b3d6554e92c7f0", "460c3c0eec2dd4a2"),
    "internvl2-2b": ("64a1e9223e31cac1", "46008a40b5fd19c8"),
    "jamba-1.5-large-398b": ("ba821aed97c01600", "7eed1f63dd965211"),
    "llama3.2-1b": ("bf33c38938018087", "8ffe1ec361522802"),
    "mistral-nemo-12b": ("1437f10cb6ebfd98", "46008a40b5fd19c8"),
    "qwen2-moe-a2.7b": ("45bd16257744674d", "b47e446bb23d9675"),
    "qwen2.5-14b": ("6a4ccc3948322543", "62cc4859136d2761"),
    "rwkv6-7b": ("daa3d98cb4fc03e3", "96d9057915302021"),
    "whisper-medium": ("fd3f7d50907d34d7", "6ea6d26cc55912ef"),
}


def batch(seed, b=2, s=48):
    rows = torch.randint(0, A["vocab"], (b, s + 1),
                         generator=torch.Generator().manual_seed(seed))
    return rows[:, :-1].contiguous(), rows[:, 1:].contiguous()


def port(seed):
    return program.build(SMALL, make_weights(SMALL, seed, CPU), CPU)


def leaf_gap(got, want):
    """max over leaves of |got - want| / max(|want|, median |want|), in
    vector norms."""
    norms = sorted(float(t.norm()) for t in want.values())
    med = norms[len(norms) // 2]
    return max(float((got[n] - want[n]).norm()) / max(float(want[n].norm()),
                                                      med, 1e-30)
               for n in want)


def logit_gap(got, want):
    return float((got - want).abs().max() / want.std())


def ref_grads(seed, toks, labels, mode="fp32"):
    w = make_weights(SMALL, seed, CPU)
    for t in w.values():
        t.requires_grad_(True)
    with ref.precision(mode):
        lv = ref.loss(w, toks, labels, A)
    lv.backward()
    return float(lv.detach()), {n: t.grad for n, t in w.items()}


def test_layout_is_the_reference_s():
    for a in (A, CONF["model"]):
        m = build_model(program.arch_config(a), dtype=torch.float32,
                        device="meta")
        assert {n: tuple(p.shape) for n, p in m.named_parameters()} == \
            dict(ref.param_spec(a))


def test_init_weights_fills_finch_s_layer():
    model = build_model(program.arch_config(A), dtype=torch.float32,
                        device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    with torch.no_grad():
        logits = model.forward({"tokens": batch(0, s=8)[0]})
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_logits_loss_and_gradients_match_the_reference(seed):
    toks, labels = batch(seed)
    model = port(seed)
    with torch.no_grad():
        got = model.forward({"tokens": toks})
    want = ref.logits(make_weights(SMALL, seed, CPU), toks, A)
    assert logit_gap(got, want) < LOGIT_TOL
    # not the program's own output: another seed's weights differ
    other = ref.logits(make_weights(SMALL, seed + 10, CPU), toks, A)
    assert logit_gap(got, other) > 0.1

    model.requires_grad_(True)
    lp = model.loss({"tokens": toks, "labels": labels})
    lp.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    lr, want_g = ref_grads(seed, toks, labels)
    assert abs(float(lp.detach()) - lr) / lr < LOSS_TOL
    assert all(float(g.norm()) > 0 for g in want_g.values())
    assert leaf_gap(grads, want_g) < GRAD_TOL


def test_a_tf32_reference_fails_the_tolerances():
    toks, labels = batch(1)
    model = port(1)
    with torch.no_grad():
        got = model.forward({"tokens": toks})
    with ref.precision("tf32"):
        want = ref.logits(make_weights(SMALL, 1, CPU), toks, A)
    assert logit_gap(got, want) > 10 * LOGIT_TOL
    model.requires_grad_(True)
    model.loss({"tokens": toks, "labels": labels}).backward()
    _, want_g = ref_grads(1, toks, labels, "tf32")
    assert leaf_gap({n: p.grad for n, p in model.named_parameters()},
                    want_g) > 10 * GRAD_TOL


def test_one_adamw_step_matches_the_reference():
    toks, labels = batch(4)
    opt = dict(CONF["optimizer"], warmup_steps=1)   # the full lr at step 1
    model = port(4)
    step = make_train_step(model, AdamWConfig(**opt))
    state, metrics = step(adamw_init(dict(model.named_parameters())),
                          {"tokens": toks, "labels": labels})
    w = make_weights(SMALL, 4, CPU)
    out = ref.train_steps(w, [(toks, labels)], A, opt)
    assert abs(float(metrics["loss"]) - out["loss"][0]) / out["loss"][0] \
        < LOSS_TOL
    p0 = make_weights(SMALL, 4, CPU)
    got = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
    want = {n: w[n] - p0[n] for n in w}
    assert min(float(t.norm()) for t in want.values()) > 0
    assert leaf_gap(got, want) < CHANGE_TOL
    # the first moment is (1 - b1) times the clipped gradient
    first = {n: m / (1 - opt["b1"]) for n, m in state["m"].items()}
    norms = {n: float(t.norm()) for n, t in first.items()}
    for n, v in out["leaf_grad"][0].items():
        assert abs(norms[n] - v) <= GRAD_TOL * max(v, max(norms.values()))


def test_a_carried_state_token_by_token_is_the_stateless_forward():
    toks, _ = batch(5, b=2, s=20)
    model = port(5)
    with torch.no_grad():
        whole = model.forward({"tokens": toks})
        cache = model.init_cache(2, 20)
        steps = []
        for t in range(toks.shape[1]):
            logits, cache = model.decode_step(cache, toks[:, t])
            steps.append(logits)
    assert logit_gap(torch.stack(steps, dim=1), whole) < 1e-5


def _record(model, toks):
    with torch.no_grad():
        model.forward({"tokens": toks})
    return [s for s in PROCESS_TRACER.drain() if s.name.startswith("rwkv.")]


def test_the_spans_are_recorded_while_the_tracer_is_on_only():
    toks, _ = batch(6, b=2, s=12)
    model = port(6)
    PROCESS_TRACER.drain()
    assert _record(model, toks) == []
    PROCESS_TRACER.force(True)
    try:
        got = _record(model, toks)
    finally:
        PROCESS_TRACER.force(False)
    tm = [s for s in got if s.name == "rwkv.time_mix"]
    lora = [s for s in got if s.name == "rwkv.lora"]
    assert len(tm) == len(lora) == A["n_layers"] and len(got) == 2 * len(tm)
    heads = A["d_model"] // A["rwkv_head_size"]
    for s in got:
        assert s.attrs["tokens"] == toks.numel() and s.attrs["heads"] == heads
    # each rwkv.lora lies inside a rwkv.time_mix
    ids = {s.span_id: s for s in tm}
    for s in lora:
        outer = ids[s.parent_id]
        assert outer.t_start <= s.t_start <= s.t_end <= outer.t_end
    assert _record(model, toks) == []

    # the repository's layout has a time mix and no LoRA
    cfg = ARCHS["rwkv6-7b"].smoke()
    old = build_model(cfg, dtype=torch.float32, device="cpu")
    old.init_weights(torch.Generator().manual_seed(0))
    PROCESS_TRACER.force(True)
    try:
        got = _record(old, toks % cfg.vocab)
    finally:
        PROCESS_TRACER.force(False)
    assert [s.name for s in got] == ["rwkv.time_mix"] * cfg.n_layers


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_every_arch_builds_the_layout_it_had(name):
    cfg = ARCHS[name]
    assert not cfg.rwkv_finch
    for c, want in zip((cfg, cfg.smoke()), LAYOUTS[name]):
        m = build_model(c, dtype=torch.float32, device="meta")
        rows = [[n, list(p.shape)] for n, p in m.named_parameters()]
        assert hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16] \
            == want


def test_finch_s_leaves_are_replicated_as_rwkv_s_are():
    m = build_model(program.arch_config(CONF["model"]),
                    dtype=torch.float32, device="meta")
    specs = param_specs(m, 16)
    for n, s in specs.items():
        if n not in ("embed", "lm_head.w"):
            assert all(ax is None for ax in s), (n, s)
    assert tuple(specs["embed"]) == ("model", None)


def test_one_lora_rank_alone_is_refused():
    base = dict(A)
    with pytest.raises(ValueError, match="together"):
        ArchConfig(**dict(base, rwkv_decay_lora=0))


@pytest.mark.parametrize("t", [1, 37, 70])
def test_the_reference_scan_is_autograd_s_and_the_port_s(monkeypatch, t):
    """The reference's recurrence and its hand-run backward, over 16-step
    segments and over one, against autograd through the recurrence
    written step by step and against the port's plain ``rwkv6_scan`` (B 2,
    H 3, hd 16), values and gradients."""
    g = torch.Generator().manual_seed(t)
    b, h, hd = 2, 3, 16
    r, k, v = (torch.randn(b, t, h * hd, generator=g) for _ in range(3))
    dec = torch.rand(b, t, h * hd, generator=g) * 0.5 + 0.45
    u = torch.randn(h, hd, generator=g)
    dy = torch.randn(b, t, h * hd, generator=g)
    sh = (b, t, h, hd)

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (r, k, v, dec, u)]
        y = fn(*xs)
        y.backward(dy)
        # (at T 1 the decay reaches no output: no gradient, zeros)
        return y.detach(), [torch.zeros_like(x) if x.grad is None
                            else x.grad for x in xs]

    def stepwise(r_, k_, v_, d_, u_):
        r_, k_, v_, d_ = (z.reshape(sh) for z in (r_, k_, v_, d_))
        s, ys = torch.zeros(b, h, hd, hd), []
        for i in range(t):
            kv = k_[:, i, :, :, None] * v_[:, i, :, None, :]
            ys.append(torch.einsum("bhi,bhij->bhj", r_[:, i],
                                   s + u_[None, :, :, None] * kv))
            s = d_[:, i, :, :, None] * s + kv
        return torch.stack(ys, dim=1).reshape(b, t, h * hd)

    def port_scan(r_, k_, v_, d_, u_):
        return rwkv6_scan(r_.reshape(sh), k_.reshape(sh), v_.reshape(sh),
                          d_.reshape(sh), u_).reshape(b, t, h * hd)

    want, want_g = grads(stepwise)
    port, port_g = grads(port_scan)
    whole, whole_g = grads(lambda *x: ref.wkv(*x, hd))
    monkeypatch.setattr(ref, "SEGMENT", 16)
    split, split_g = grads(lambda *x: ref.wkv(*x, hd))
    for got, got_g in ((port, port_g), (whole, whole_g), (split, split_g)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for a, e in zip(got_g, want_g):
            torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


def test_the_configuration_states_the_published_divisor():
    assert CONF["published"]["head_size_divisor"] == ref.HEAD_SIZE_DIVISOR
    from repro_torch.models import ssm
    assert ssm.FINCH_GROUP_NORM_EPS == ref.GROUP_NORM_EPS
    assert CONF["model"]["n_layers"] * 2 == \
        CONF["published"]["num_hidden_layers"]
