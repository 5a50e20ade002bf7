"""The port's training path against the reference on the six families'
smoke configs (llama3.2-1b dense, qwen2-moe-a2.7b moe, internvl2-2b vlm on
input embeddings, whisper-medium audio with frames, rwkv6-7b ssm, jamba
hybrid), fp32, with the reference's ``init`` weights carried across by
``params_from_jax`` and inputs from numpy seeds:

* ``Model.loss`` against the reference's ``loss`` (rtol 1e-5), with some
  labels masked (-1);
* every gradient against ``jax.grad`` of it, the reference's grad tree
  mapped by ``params_from_jax``: max |d| <= 1e-4 max |g_ref| + 1e-7;
* one ``make_train_step`` against the reference's jitted one: step, grad
  norm and lr at rtol 1e-5, parameters and moments at rtol 1e-5 beside the
  gradient tolerance carried through the AdamW step element by element
  (an element whose gradient is within rounding of 0 may step either way);
* five llama steps on ``SyntheticLMDataset`` giving the reference's
  losses (rtol 1e-4); ``train(device="cpu")`` learning as the reference's
  ``test_train_step_reduces_loss_quickly`` requires; a resumed run equal
  to an uninterrupted one bit for bit; ``remat`` on and off giving equal
  gradients.

The reference runs compiled (``jax.jit``).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.optim import AdamWConfig, adamw_init

torch.set_num_threads(1)

ARCH_IDS = ["llama3.2-1b", "qwen2-moe-a2.7b", "internvl2-2b",
            "whisper-medium", "rwkv6-7b", "jamba-1.5-large-398b"]
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
STEP_RTOL = 1e-5
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def _batch(cfg, seed):
    """(reference batch, port batch): tokens, embeds (vlm) or tokens and
    frames (audio), and labels with two positions masked."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S))
    labels[0, 3] = labels[1, -1] = -1
    if cfg.family == "vlm":
        x = {"embeds": rng.standard_normal((B, S, cfg.d_model))
             .astype(np.float32)}
    else:
        x = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "audio":
        x["frames"] = rng.standard_normal(
            (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    x["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.as_tensor(v) for k, v in x.items()})


def _port(arch, params, remat=False):
    cfg = get_arch(arch).smoke()
    m = build_model(cfg, dtype=torch.float32, device="cpu", remat=remat)
    m.load_state_dict(params_from_jax(cfg, params), strict=True)
    return m


@pytest.fixture(scope="module", params=ARCH_IDS)
def family(request):
    """The reference model, its init params, its loss and grads on one
    batch, and the batches."""
    arch = request.param
    jm = j_build(J_ARCHS[arch].smoke(), dtype=jnp.float32, remat=False)
    params = jax.jit(jm.init)(jax.random.key(0))
    jb, tb = _batch(jm.cfg, seed=1)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jb)
    return {"arch": arch, "jm": jm, "params": params, "jb": jb, "tb": tb,
            "loss": float(loss), "grads": grads}


def _port_grads(m, batch):
    m.requires_grad_(True)
    return loss_and_grads(m, batch)


def test_loss_matches_reference(family):
    m = _port(family["arch"], family["params"])
    loss = m.loss(family["tb"])
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), family["loss"], rtol=LOSS_RTOL)
    # the masked labels are left out: all labels masked but one position
    tb = dict(family["tb"], labels=torch.full((B, S), -1))
    tb["labels"][1, 5] = family["tb"]["labels"][1, 5]
    logits, aux = m.forward(tb, collect_aux=True)
    want = -torch.log_softmax(logits[1, 5].detach(), -1)[tb["labels"][1, 5]] \
        + 0.01 * aux.detach()
    np.testing.assert_allclose(float(m.loss(tb)), float(want), rtol=1e-6)


def test_grads_match_reference(family):
    m = _port(family["arch"], family["params"])
    _, grads = _port_grads(m, family["tb"])
    want = params_from_jax(m.cfg, family["grads"])
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].numpy()
        tol = GRAD_REL * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{name}: max |d| {err:.3g} > {tol:.3g}"
    assert any(float(g.abs().max()) > 0 for g in grads.values())


def test_train_step_matches_reference(family):
    """One AdamW step from the same weights on the same batch."""
    jm, params = family["jm"], family["params"]
    jstep = jax.jit(JST.make_train_step(jm, JAdamWConfig(**OPT)))
    jp, js, jmet = jstep(params, j_adamw_init(params), family["jb"])
    m = _port(family["arch"], params)
    step = make_train_step(m, AdamWConfig(**OPT))
    state = adamw_init(dict(m.named_parameters()))
    state, met = step(state, family["tb"])
    assert all(p.grad is None for p in m.parameters())   # freed
    assert int(state["step"]) == int(js["step"]) == 1
    np.testing.assert_allclose(float(met["loss"]), family["loss"],
                               rtol=LOSS_RTOL)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=STEP_RTOL, err_msg=k)
    # the gradient tolerance of test_grads_match_reference carried through
    # the step, per element: m moves by (1 - b1) x it, v by (1 - b2) x
    # (2 |g| + it) x it, and the first step's g / (|g| + eps) by at most
    # it x eps / (|g| - it + eps)^2 (up to 2, a sign flip where |g| is
    # within it of 0), times lr
    cfg, opt = m.cfg, AdamWConfig(**OPT)
    scale = min(1.0, opt.clip_norm / (float(jmet["grad_norm"]) + 1e-9))
    ref_g = params_from_jax(cfg, family["grads"])
    for name, p in m.named_parameters():
        g_ref = np.abs(ref_g[name].numpy())
        g, eg = g_ref * scale, (GRAD_REL * float(g_ref.max()) + GRAD_ATOL) * scale
        d_step = np.minimum(2.0, eg * opt.eps
                            / (np.maximum(g - eg, 0) + opt.eps) ** 2)
        for what, got, want, tol in (
                ("param", p.detach(), params_from_jax(cfg, jp)[name],
                 float(jmet["lr"]) * d_step),
                ("m", state["m"][name], params_from_jax(cfg, js["m"])[name],
                 (1 - opt.b1) * eg),
                ("v", state["v"][name], params_from_jax(cfg, js["v"])[name],
                 (1 - opt.b2) * (2 * g + eg) * eg)):
            w = want.numpy()
            err = np.abs(got.numpy() - w)
            bound = STEP_RTOL * np.abs(w) + tol + 1e-7 * np.abs(w).max()
            assert (err <= bound).all(), \
                f"{what} {name}: max excess {float((err - bound).max()):.3g}"


def test_five_llama_steps_give_the_reference_losses():
    arch, batch, seq, steps = "llama3.2-1b", 8, 32, 5
    jm = j_build(J_ARCHS[arch].smoke(), dtype=jnp.float32, remat=False)
    params = jax.jit(jm.init)(jax.random.key(0))
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=steps)
    jstep = jax.jit(JST.make_train_step(jm, JAdamWConfig(**opt)))
    jds = JDataset(jm.cfg.vocab, seq, batch)
    jp, js, want = params, j_adamw_init(params), []
    for i in range(steps):
        hb = jds.batch_at(i)
        jp, js, met = jstep(jp, js, {k: jnp.asarray(v)
                                     for k, v in hb.items()})
        want.append(float(met["loss"]))
    m = _port(arch, params)
    step = make_train_step(m, AdamWConfig(**opt))
    state, got = adamw_init(dict(m.named_parameters())), []
    ds = SyntheticLMDataset(m.cfg.vocab, seq, batch)
    for b in make_batch_iter(ds, 0, steps, device="cpu"):
        state, met = step(state, b)
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_train_step_reduces_loss_quickly():
    """The reference's own check on the port's trainer: a tiny model on
    the structured synthetic stream must learn."""
    losses = train("llama3.2-1b", steps=40, batch=8, seq=32, smoke=True,
                   ckpt_dir=None, log_every=1000, device="cpu")
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_train_with_compressed_grads_learns():
    losses = train("llama3.2-1b", steps=40, batch=8, seq=32, smoke=True,
                   ckpt_dir=None, log_every=1000, device="cpu",
                   compress_grads=True)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def _same_tree(a, b, what=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same_tree(a[k], b[k], f"{what}.{k}")
    else:
        assert torch.equal(a, b), what


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """8 steps with checkpoints every 4; losing the run after step 4 (its
    later checkpoint removed) and resuming in a fresh process's model gives
    steps 4-7's losses bit for bit and the same final params and moments."""
    d = str(tmp_path)
    kw = dict(arch="llama3.2-1b", steps=8, batch=2, seq=16, smoke=True,
              ckpt_dir=d, ckpt_every=4, log_every=1000, device="cpu")
    whole = train(**kw)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000008"]
    m = build_model(get_arch("llama3.2-1b").smoke(), dtype=torch.float32,
                    device="cpu")
    like = {"params": dict(m.named_parameters()),
            "opt": adamw_init(dict(m.named_parameters()))}
    end = restore_checkpoint(d, 8, like, device="cpu")
    assert int(restore_checkpoint(d, 4, like, device="cpu")
               ["opt"]["step"]) == 4
    shutil.rmtree(os.path.join(d, "step_00000008"))
    resumed = train(**kw)
    assert resumed == whole[4:]
    _same_tree(restore_checkpoint(d, 8, like, device="cpu"), end)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gives_equal_gradients(arch):
    jm = j_build(J_ARCHS[arch].smoke(), dtype=jnp.float32, remat=False)
    params = jax.jit(jm.init)(jax.random.key(0))
    _, tb = _batch(jm.cfg, seed=2)
    out = {}
    for remat in (False, True):
        m = _port(arch, params, remat=remat)
        loss, grads = _port_grads(m, tb)
        out[remat] = (loss, grads)
    assert torch.equal(out[False][0], out[True][0])
    for name, g in out[False][1].items():
        assert torch.equal(g, out[True][1][name]), name


def test_model_defaults_to_remat_as_the_reference():
    cfg = get_arch("llama3.2-1b").smoke()
    assert build_model(cfg, device="cpu").remat is True
    assert j_build(J_ARCHS["llama3.2-1b"].smoke()).remat is True
    assert dataclasses.asdict(AdamWConfig()) == \
        dataclasses.asdict(JAdamWConfig())
