"""The port's sharded train step on gloo meshes of 2 and 4 CPU processes,
held to the port's unsharded step and to the reference's jitted step.

Two process groups run (``_torch_mesh_worker``; a ``FileStore`` under
``tmp_path``, spawned ranks, one thread each, a 120 s deadline), each
once per module, the first while the test process computes the
unsharded and reference runs:

* 2 ranks: smoke llama3.2-1b and rwkv6-7b on meshes (1, 2) and (2, 1),
  the smoke jamba on (1, 2) (its MoE block replicated), llama at S 2560 on
  (1, 2) (the attention's ``local_map`` site: ``chunked_attention``, the
  kernel's CPU version, on local heads), and ``train()`` under
  ``choose_mesh()``;
* 4 ranks: llama (with remat), rwkv6 and the smoke jamba (its Mamba
  blocks on their data shard's rows and model rank's channels) on (2,
  2), llama at S 2560 on (1, 4) (2 KV heads on 4 ranks: the heads are
  replicated before the attention), and a checkpoint saved on (2, 2) and
  restored onto (1, 4).

Every sharded run starts from the reference's ``init`` weights
(``params_from_jax``) and takes ``SyntheticLMDataset``'s batches (B 2;
the S 2560 runs B 1 and one step).  The jamba and S 2560 runs are held
to the port's unsharded step only (``test_torch_train.py`` holds that one
to the reference's; the reference's jitted jamba step would cost this
file 16 s more).
Held with the tolerances of ``test_torch_train.py``: loss, the three
steps' losses and grad norms at rtol 1e-5 (jamba's first: see
``_held_steps``); each gradient within
1e-4 max |g| + 1e-7; parameters and moments after the first step at rtol
1e-5 beside the gradient tolerance carried through the AdamW step
element by element (an element whose gradient is within rounding of 0
may step either way, which is also why later steps are held by their
losses: a sharded sum rounds differently, and Adam turns that rounding
into a full step of either sign at such an element).  One update from
the same gradient, under the clip, equals the unsharded update bit for
bit.  The residual stream leaves each block as ``Shard(1)`` over
``model`` where the reference's condition holds, and ZeRO-1 moments hold
1/data of each moment on each rank.

The loss: wherever ``model`` splits the vocab the sharded steps' loss is
the vocab-parallel NLL (``models.dtensor.vocab_parallel_nll``, each rank
on its own vocab shard), and ``Model.loss`` from seeded logits on (1, 2)
and (2, 2) is held to the unsharded loss and its gradient at the same
tolerances; on a mesh of one it is the plain loss bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from repro.configs import ARCHS as J_ARCHS
from repro.data import SyntheticLMDataset as JDataset
from repro.launch import steps as JST
from repro.models import build_model as j_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMDataset, make_batch_iter
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, cosine_lr

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
STEP_RTOL = 1e-5
S, LONG_S = 16, 2560
ARCHS = ("llama3.2-1b", "rwkv6-7b", "jamba-1.5-large-398b")
GROUP2 = [("llama3.2-1b", (1, 2), S), ("llama3.2-1b", (2, 1), S),
          ("rwkv6-7b", (1, 2), S), ("rwkv6-7b", (2, 1), S),
          ("jamba-1.5-large-398b", (1, 2), S),
          ("llama3.2-1b", (1, 2), LONG_S)]
GROUP4 = [("llama3.2-1b", (2, 2), S), ("rwkv6-7b", (2, 2), S),
          ("jamba-1.5-large-398b", (2, 2), S),
          ("llama3.2-1b", (1, 4), LONG_S)]
TRAIN = dict(arch="llama3.2-1b", steps=4, batch=2, seq=S)
NLL_MESHES = [(1, 2), (2, 2)]
NLL_B, NLL_V = 4, 256


def _tag(arch, mesh, seq):
    return f"{arch}_{mesh[0]}x{mesh[1]}_S{seq}"


def _size(seq):
    """(batch rows, steps) of a run: the S 2560 runs, which exercise the
    attention's local_map site, take one row and one step."""
    return (1, 1) if seq == LONG_S else (W.B, W.N_STEPS)


def _port_run(arch, params, seq):
    """The port's unsharded step: loss and gradients on batch 0, then
    the steps (the state after the first kept)."""
    cfg = get_arch(arch).smoke()
    model = build_model(cfg, dtype=torch.float32, device="cpu", remat=False)
    model.load_state_dict(params, strict=True)
    model.requires_grad_(True)
    batch, steps = _size(seq)
    ds = SyntheticLMDataset(cfg.vocab, seq, batch)
    batches = list(make_batch_iter(ds, 0, steps, device="cpu"))
    loss0, grads = loss_and_grads(model, batches[0])
    grads = {n: g.clone() for n, g in grads.items()}
    model.zero_grad(set_to_none=True)
    step = make_train_step(model, AdamWConfig(**W.OPT))
    state = adamw_init(dict(model.named_parameters()))
    out = {"loss0": float(loss0), "grads": grads, "losses": [],
           "gnorms": []}
    for b in batches:
        state, met = step(state, b)
        out["losses"].append(float(met["loss"]))
        out["gnorms"].append(float(met["grad_norm"]))
        if "step1" not in out:
            out["step1"] = {
                "params": {n: p.detach().clone()
                           for n, p in model.named_parameters()},
                "m": {n: t.clone() for n, t in state["m"].items()},
                "v": {n: t.clone() for n, t in state["v"].items()}}
    return out


def _ref_run(jm, params, seq):
    """The reference's jitted step on the same batches."""
    cfg = jm.cfg
    jds = JDataset(cfg.vocab, seq, W.B)
    hb = [{k: jnp.asarray(v) for k, v in jds.batch_at(i).items()}
          for i in range(W.N_STEPS)]
    loss0, grads = jax.jit(jax.value_and_grad(jm.loss))(params, hb[0])
    jstep = jax.jit(JST.make_train_step(jm, JAdamWConfig(**W.OPT)))
    jp, js = params, j_adamw_init(params)
    out = {"loss0": float(loss0), "grads": params_from_jax(cfg, grads),
           "losses": [], "gnorms": []}
    for b in hb:
        jp, js, met = jstep(jp, js, b)
        out["losses"].append(float(met["loss"]))
        out["gnorms"].append(float(met["grad_norm"]))
        if "step1" not in out:
            out["step1"] = {"params": params_from_jax(cfg, jp),
                            "m": params_from_jax(cfg, js["m"]),
                            "v": params_from_jax(cfg, js["v"])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both process groups, the port's unsharded runs and the reference's
    runs, each once; the 2-rank group runs while this process computes
    the unsharded and reference runs."""
    work = str(tmp_path_factory.mktemp("mesh"))
    files, models, unsharded, ref = {}, {}, {}, {}
    for arch in ARCHS:
        jm = j_build(J_ARCHS[arch].smoke(), dtype=jnp.float32, remat=False)
        params = jax.jit(jm.init)(jax.random.key(0))
        models[arch] = jm, params
        files[arch] = os.path.join(work, f"{arch}.pt")
        torch.save(params_from_jax(jm.cfg, params), files[arch])

    def steps_jobs(cases, remat_first=False):
        return [{"kind": "steps", "arch": a, "mesh": mesh, "seq": seq,
                 "params": files[a], "out": _tag(a, mesh, seq) + ".pt",
                 "remat": remat_first and i == 0,
                 "batch": _size(seq)[0], "steps": _size(seq)[1]}
                for i, (a, mesh, seq) in enumerate(cases)]

    nll_in = os.path.join(work, "nll_inputs.npz")
    np.savez(nll_in, **_nll_inputs())
    nll_jobs = {w: {"kind": "vocab_nll", "inputs": nll_in,
                    "meshes": NLL_MESHES, "out": f"vocab_nll{w}.pt"}
                for w in (2, 4)}
    group2 = W.start_group(2, steps_jobs(GROUP2) + [
        dict(kind="train", out="train.pt", **TRAIN), nll_jobs[2]], work)
    try:
        for arch, (jm, params) in models.items():
            sd = params_from_jax(jm.cfg, params)
            if not jm.cfg.n_experts:
                ref[arch] = _ref_run(jm, params, S)
            unsharded[(arch, S)] = _port_run(arch, sd, S)
            if arch == "llama3.2-1b":
                unsharded[(arch, LONG_S)] = _port_run(arch, sd, LONG_S)
    finally:
        W.join_group(group2)
    ckpt = os.path.join(work, "ckpt")
    W.join_group(W.start_group(4, steps_jobs(GROUP4, remat_first=True) + [
        {"kind": "save", "arch": "llama3.2-1b", "mesh": (2, 2), "seq": S,
         "params": files["llama3.2-1b"], "dir": ckpt, "out": "saved.pt"},
        {"kind": "restore", "arch": "llama3.2-1b", "mesh": (1, 4), "seq": S,
         "params": files["llama3.2-1b"], "dir": ckpt,
         "out": "restored.pt"}, nll_jobs[4]], work))
    load = lambda name: torch.load(os.path.join(work, name))
    return {"sharded": {(a, m, s): load(_tag(a, m, s) + ".pt")
                        for a, m, s in GROUP2 + GROUP4},
            "unsharded": unsharded, "ref": ref, "files": files,
            "train": load("train.pt"), "saved": load("saved.pt"),
            "restored": load("restored.pt"), "ckpt": ckpt,
            "nll": {**load("vocab_nll2.pt"), **load("vocab_nll4.pt")},
            "nll_inputs": nll_in}


def _nll_inputs():
    """Seeded logits (B 4, S 8, V 256, fp32) and labels, some masked."""
    rng = np.random.default_rng(7)
    logits = (3.0 * rng.standard_normal((NLL_B, S // 2, NLL_V))) \
        .astype(np.float32)
    labels = rng.integers(0, NLL_V, (NLL_B, S // 2)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.2] = -1
    return {"logits": logits, "labels": labels}


def _plain_loss(inputs):
    """The unsharded Model.loss route (log-softmax, gather, masked mean,
    plus 0.01 x the jobs' aux 0.25) and the logits' gradient."""
    lg = torch.from_numpy(inputs["logits"]).requires_grad_(True)
    labels = torch.from_numpy(inputs["labels"])
    logp = torch.log_softmax(lg.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())
    mask = (labels >= 0).float()
    loss = -(ll[..., 0] * mask).sum() / torch.clamp(mask.sum(), min=1.0) \
        + 0.01 * 0.25
    loss.backward()
    return loss.detach(), lg.grad


def _to_np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _check_grads(got, want, what):
    assert set(got) == set(want), what
    for name, g in got.items():
        w = _to_np(want[name])
        tol = GRAD_REL * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{what} {name}: max |d| {err:.3g} > {tol:.3g}"


def _check_step1(got, want, grads, gnorm, what):
    """test_torch_train's rule: parameters and moments after one step at
    rtol 1e-5 beside the gradient tolerance carried through AdamW."""
    opt = AdamWConfig(**W.OPT)
    scale = min(1.0, opt.clip_norm / (gnorm + 1e-9))
    lr = float(cosine_lr(opt, torch.tensor(1)))
    for name in want["params"]:
        g_ref = np.abs(_to_np(grads[name]))
        g, eg = g_ref * scale, (GRAD_REL * float(g_ref.max())
                                + GRAD_ATOL) * scale
        d_step = np.minimum(2.0, eg * opt.eps
                            / (np.maximum(g - eg, 0) + opt.eps) ** 2)
        for key, tol in (("params", lr * d_step),
                         ("m", (1 - opt.b1) * eg),
                         ("v", (1 - opt.b2) * (2 * g + eg) * eg)):
            w = _to_np(want[key][name])
            err = np.abs(got[key][name].numpy() - w)
            bound = STEP_RTOL * np.abs(w) + tol + 1e-7 * np.abs(w).max()
            assert (err <= bound).all(), \
                f"{what} {key} {name}: max excess {float((err - bound).max()):.3g}"


CASES = [c for c in GROUP2 + GROUP4]


def _held_steps(arch):
    """Steps whose loss is held: all three, but only the first where a
    router picks experts (after a step, a router logit within rounding of
    a tie can send a token to another expert: a discrete change, also
    between the unsharded port and the reference)."""
    return 1 if get_arch(arch).n_experts else W.N_STEPS


@pytest.mark.parametrize("case", CASES, ids=[_tag(*c) for c in CASES])
def test_sharded_steps_match_the_unsharded_step(runs, case):
    arch, mesh, seq = case
    got, want = runs["sharded"][case], runs["unsharded"][(arch, seq)]
    what = _tag(*case)
    n = _held_steps(arch)
    np.testing.assert_allclose(got["loss0"], want["loss0"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][:n], want["losses"][:n],
                               rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got["gnorms"][0], want["gnorms"][0],
                               rtol=STEP_RTOL, err_msg=what)
    _check_grads(got["grads"], want["grads"], what)
    _check_step1(got["step1"], want["step1"], want["grads"],
                 want["gnorms"][0], what)
    assert got["update_equal"], f"{what}: one update from the same " \
        f"gradient differs from the unsharded update"


REF_CASES = [c for c in CASES if c[2] == S and not get_arch(c[0]).n_experts]


@pytest.mark.parametrize("case", REF_CASES, ids=[_tag(*c) for c in REF_CASES])
def test_sharded_steps_match_the_reference(runs, case):
    arch = case[0]
    got, want = runs["sharded"][case], runs["ref"][arch]
    what = _tag(*case)
    n = _held_steps(arch)
    np.testing.assert_allclose(got["loss0"], want["loss0"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][:n], want["losses"][:n],
                               rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got["gnorms"][0], want["gnorms"][0],
                               rtol=STEP_RTOL, err_msg=what)
    _check_grads(got["grads"], want["grads"], what)
    _check_step1(got["step1"], want["step1"], want["grads"],
                 want["gnorms"][0], what)


# the smoke jamba's Mamba moments (A_log (128, 8), x_proj (128, 17)) have
# no free dim that the production data size divides: the reference puts
# the data axes on its stacked layer dim, which the port's per-layer
# parameters lack (ROADMAP.md §3), so (2, 2) jamba is held by the other
# tests only
ZERO1_CASES = [c for c in CASES if c != ("jamba-1.5-large-398b", (2, 2), S)]


@pytest.mark.parametrize("case", ZERO1_CASES,
                         ids=[_tag(*c) for c in ZERO1_CASES])
def test_zero1_moments_hold_a_data_shard(runs, case):
    """Each moment whose spec puts the data axis on a dim holds 1/data of
    it (times 1/model where the model axis splits it too) on a rank."""
    data, model = case[1]
    for name, (local, whole, placements) in \
            runs["sharded"][case]["zero1"].items():
        parts = (data if placements[0].startswith("S(") else 1) \
            * (model if placements[1].startswith("S(") else 1)
        assert local * parts == whole, (name, local, whole, placements)
        if data > 1 and whole >= 1024:
            assert placements[0].startswith("S("), \
                f"{name}: moment not split over data ({placements})"


@pytest.mark.parametrize("case", CASES, ids=[_tag(*c) for c in CASES])
def test_residual_stream_is_sequence_parallel_where_the_reference_says(
        runs, case):
    """Shard(1) over model between blocks when seq % mp == 0 and
    seq >= mp > 1 (the reference's _constrain); otherwise the placements
    the block left."""
    arch, (data, model), seq = case
    hidden = runs["sharded"][case]["hidden"]
    assert hidden, "no block's output passed _constrain"
    for pl in hidden:
        if model > 1 and seq % model == 0 and seq >= model:
            assert pl[1] == "S(1)", pl
        else:
            assert pl[1] != "S(1)", pl
        assert pl[0] == ("S(0)" if data > 1 else pl[0])


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == LONG_S],
                         ids=lambda c: _tag(*c))
def test_long_attention_runs_on_local_shards(runs, case):
    """At S 2560 the attention goes through local_map: in every layer the
    CPU version of the kernel sees plain tensors of its own batch rows and
    whole heads, split over model wherever the KV heads divide it (each
    block gathers a sequence-parallel input first, so the column-parallel
    q/k/v projections split their heads), else all of them (2 KV heads on
    4 ranks)."""
    arch, (data, model), seq = case
    cfg = get_arch(arch).smoke()
    calls = runs["sharded"][case]["chunked_calls"]
    rows = _size(seq)[0] // data
    whole = ((rows, seq, cfg.n_heads, cfg.head_dim),
             (rows, seq, cfg.n_kv_heads, cfg.head_dim))
    split = ((rows, seq, cfg.n_heads // model, cfg.head_dim),
             (rows, seq, cfg.n_kv_heads // model, cfg.head_dim))
    want = split if cfg.n_kv_heads % model == 0 else whole
    assert calls and len(calls) % cfg.n_layers == 0, calls
    for typ, q, k in calls:
        assert typ == "Tensor"
        assert (q, k) == want, (q, k)


def test_mamba_scan_runs_on_local_channels_in_the_jamba_mesh(runs):
    """The jamba cut's Mamba scan goes through local_map on each rank's
    own channels in every Mamba sub-layer: its input gathered from the
    sequence-parallel residual, the column-parallel in_proj splits them."""
    cfg = get_arch("jamba-1.5-large-398b").smoke()
    model = 2
    calls = runs["sharded"][("jamba-1.5-large-398b", (1, model), S)][
        "ssm_calls"]
    assert calls, "no Mamba scan ran"
    for typ, shape in calls:
        assert typ == "Tensor"
        assert shape == (W.B, S, 2 * cfg.d_model // model), shape


def test_moe_block_runs_replicated_in_the_jamba_mesh(runs):
    """The jamba cut's expert stacks are split over model (EP) in the
    parameters and its step matches (above); the block itself runs on
    replicated weights."""
    pl = runs["sharded"][("jamba-1.5-large-398b", (1, 2), S)][
        "param_placements"]
    moe = {n: p for n, p in pl.items() if ".moe." in n and "w_up" in n}
    assert moe and all(p[1] == "S(0)" for p in moe.values()), moe


@pytest.mark.parametrize("mesh", NLL_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_vocab_parallel_loss_matches_the_unsharded_loss(runs, mesh):
    got = runs["nll"][mesh]
    loss, grad = _plain_loss(dict(np.load(runs["nll_inputs"])))
    assert got["vocab_dims"] == (1,)
    np.testing.assert_allclose(float(got["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    _check_grads({"logits": got["grad"]}, {"logits": grad}, f"{mesh}")


@pytest.mark.parametrize("case", CASES, ids=[_tag(*c) for c in CASES])
def test_sharded_loss_is_vocab_parallel_where_model_splits_the_vocab(
        runs, case):
    """Each loss of a sharded run (loss_and_grads, then every step) takes
    the vocab-parallel route exactly where model splits the logits' vocab
    (the smoke vocab, 256, divides it), and at S 16 on model 2 it does;
    elsewhere its logits are whole over the vocab (model 1, or the
    sequence split over model), so the log-softmax is local."""
    arch, (data, model), seq = case
    got = runs["sharded"][case]
    seen, calls = got["loss_logits"], got["nll_calls"]
    assert len(seen) == 1 + _size(seq)[1], seen
    assert calls == [pl for pl in seen if pl[1] == "S(2)"], (seen, calls)
    if model > 1 and seq == S:
        assert calls == seen
    if model == 1:
        assert calls == []


def test_mesh_of_one_loss_is_the_plain_loss_bit_for_bit(runs):
    """On a (1, 1) mesh every placement is replicated, so Model.loss takes
    the plain route: loss and every gradient bit for bit the plain
    model's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf_mod
    cfg = get_arch("llama3.2-1b").smoke()
    params = torch.load(runs["files"]["llama3.2-1b"])
    batch = next(iter(make_batch_iter(SyntheticLMDataset(cfg.vocab, S, W.B),
                                      0, 1, device="cpu")))
    out = []
    for on_mesh in (False, True):
        model = build_model(cfg, dtype=torch.float32, device="cpu",
                            remat=False)
        model.load_state_dict(params, strict=True)
        b = batch
        if on_mesh:
            mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
            ST.shard_model(mesh, model, cfg, ShapeConfig("t", S, W.B,
                                                         "train"))
            b = next(iter(make_batch_iter(
                SyntheticLMDataset(cfg.vocab, S, W.B), 0, 1, mesh=mesh,
                dp_axes=("data",))))
        model.requires_grad_(True)
        calls = []
        nll = tf_mod.vocab_parallel_nll
        tf_mod.vocab_parallel_nll = lambda *a: calls.append(a) or nll(*a)
        try:
            loss, grads = loss_and_grads(model, b)
        finally:
            tf_mod.vocab_parallel_nll = nll
        assert calls == []
        out.append((W._full(loss).detach(),
                    {n: W._full(g) for n, g in grads.items()}))
    (plain_loss, plain_g), (mesh_loss, mesh_g) = out
    assert torch.equal(mesh_loss, plain_loss)
    _same(mesh_g, plain_g, "grads")


def test_train_under_choose_mesh_gives_the_one_process_losses(runs):
    got = runs["train"]
    assert got["mesh"] == (1, 2) and got["axes"] == ("data", "model")
    want = train(TRAIN["arch"], steps=TRAIN["steps"], batch=TRAIN["batch"],
                 seq=TRAIN["seq"], smoke=True, ckpt_dir=None,
                 log_every=1000, device="cpu")
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)


def _same(a, b, what):
    assert sorted(a) == sorted(b), what
    for n in a:
        assert torch.equal(a[n], b[n]), f"{what} {n}"


def test_checkpoint_saved_on_2x2_restores_onto_1x4_bit_for_bit(runs):
    saved, got = runs["saved"], runs["restored"]
    assert got["placed"], "restored moments are not in (1, 4)'s placements"
    for key in ("params", "m", "v"):
        _same(got[key], saved[key], key)
    assert got["step"] == saved["step"] == 1
    # ZeRO-1 on (1, 4): data 1, so each rank holds 1/4 of a moment the
    # model axis splits
    assert any(4 * got["local"][n] == saved["m"][n].numel()
               for n in got["local"])


def test_checkpoint_saved_on_2x2_restores_in_one_process(runs):
    saved = runs["saved"]
    model = build_model(get_arch("llama3.2-1b").smoke(), dtype=torch.float32,
                        device="cpu")
    params = dict(model.named_parameters())
    got = restore_checkpoint(runs["ckpt"], 1,
                             {"params": params, "opt": adamw_init(params)},
                             device="cpu")
    _same(got["params"], saved["params"], "params")
    _same(got["opt"]["m"], saved["m"], "m")
    _same(got["opt"]["v"], saved["v"], "v")
    assert int(got["opt"]["step"]) == 1
