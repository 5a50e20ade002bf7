"""The port's optimizer and gradient compression against the reference's
(``repro.optim``) on the same tree, fp32, inputs from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro.optim import compress as JC
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, cosine_lr, decompress_grads,
                               ef_init)
from repro_torch.optim.adamw import global_norm

torch.set_num_threads(1)

RTOL = 1e-5
SHAPES = {"embed": (16, 8), "layers.0.attn.q.w": (8, 8), "ln": (8,),
          "moe.w_up": (3, 4, 5), "scalar": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _torch(tree):
    return {n: torch.tensor(a) for n, a in tree.items()}


def _close(got, want, what, rtol=RTOL, atol_rel=1e-6):
    """|got - want| <= rtol |want| + atol_rel max|want|: fp32 rounding of
    one operand (the clip scale, a norm summed in another order) is
    amplified where a sum cancels (a moment near 0, 1 + cos near 0)."""
    want = np.asarray(want)
    atol = atol_rel * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("cfg", [
    AdamWConfig(), AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50),
    AdamWConfig(warmup_steps=0, total_steps=1)])
def test_cosine_lr_matches_reference(cfg):
    jcfg = J.AdamWConfig(**cfg.__dict__)
    for step in (0, 1, 5, 9, 10, 11, 25, 49, 50, 51, 10_000):
        got = cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        want = np.asarray(J.cosine_lr(jcfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * cfg.lr, err_msg=f"step {step}")


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
def test_adamw_steps_match_reference(grad_scale):
    """Three updates of one tree: parameters, moments, step, grad norm and
    lr; the large gradients are clipped to norm 1."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = J.AdamWConfig(**cfg.__dict__)
    params = _tree(0)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    js = J.adamw_init(jp)
    tp = _torch(params)
    ts = adamw_init(tp)
    assert ts["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in ts["m"].values())
    upd = jax.jit(lambda g, s, p: J.adamw_update(jcfg, g, s, p))
    for t in range(3):
        grads = _tree(10 + t, grad_scale)
        jp, js, jm = upd({n: jnp.asarray(a) for n, a in grads.items()},
                         js, jp)
        ts, tm = adamw_update(cfg, _torch(grads), ts, tp)
        assert int(ts["step"]) == int(js["step"]) == t + 1
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        _close(tm["lr"], jm["lr"], "lr")
        for n in SHAPES:
            _close(tp[n], jp[n], f"param {n}, step {t}")
            _close(ts["m"][n], js["m"][n], f"m {n}, step {t}")
            _close(ts["v"][n], js["v"][n], f"v {n}, step {t}")
    if grad_scale > 1:
        assert float(tm["grad_norm"]) > cfg.clip_norm


def test_adamw_update_writes_in_place_and_takes_no_graph():
    p = {n: t.requires_grad_(True) for n, t in _torch(_tree(0)).items()}
    ptrs = {n: t.data_ptr() for n, t in p.items()}
    state = adamw_init(p)
    m_ptrs = {n: t.data_ptr() for n, t in state["m"].items()}
    state, metrics = adamw_update(AdamWConfig(), _torch(_tree(1)), state, p)
    assert {n: t.data_ptr() for n, t in p.items()} == ptrs
    assert {n: t.data_ptr() for n, t in state["m"].items()} == m_ptrs
    assert all(t.grad_fn is None for t in p.values())
    assert set(metrics) == {"grad_norm", "lr"}


def test_global_norm_matches_reference():
    tree = _tree(3)
    _close(global_norm(_torch(tree)),
           J.global_norm({n: jnp.asarray(a) for n, a in tree.items()}),
           "global norm")


def test_compress_matches_reference():
    """int8 codes equal the reference's exactly (round half to even on
    both sides), scales and error feedback to fp32 rounding; the
    reference's nested tree has a "q" leaf beside its compressed dicts."""
    grads = _tree(4)
    grads["embed"][0, :4] = [0.5, 1.5, 2.5, -2.5]      # halves at scale 1
    grads["embed"][0, 4] = 127.0
    ef = _tree(5, 0.01)
    jtree = lambda t: {"attn": {"q": jnp.asarray(t["layers.0.attn.q.w"])},
                       **{n: jnp.asarray(a) for n, a in t.items()
                          if n != "layers.0.attn.q.w"}}
    jcomp, jef = JC.compress_grads(jtree(grads), jtree(ef))
    comp, new_ef = compress_grads(_torch(grads), _torch(ef))
    for n in SHAPES:
        jc = jcomp["attn"]["q"] if n == "layers.0.attn.q.w" else jcomp[n]
        je = jef["attn"]["q"] if n == "layers.0.attn.q.w" else jef[n]
        assert comp[n]["q"].dtype == torch.int8
        np.testing.assert_array_equal(comp[n]["q"].numpy(),
                                      np.asarray(jc["q"]), err_msg=n)
        _close(comp[n]["scale"], jc["scale"], f"scale {n}", rtol=1e-6)
        np.testing.assert_allclose(new_ef[n].numpy(), np.asarray(je),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    jdec = JC.decompress_grads(jcomp, jtree(grads))
    dec = decompress_grads(comp, _torch(grads))
    _close(dec["layers.0.attn.q.w"], jdec["attn"]["q"], "decompress q")
    _close(dec["embed"], jdec["embed"], "decompress embed")


def test_decompress_takes_a_dict_with_a_q_key():
    """A parameter named "q" (an attention projection's name) is a
    gradient like any other, not a compressed leaf."""
    grads = {"q": torch.tensor([[1.0, -2.0], [0.25, 4.0]]),
             "scale": torch.tensor([3.0])}
    comp, _ = compress_grads(grads, ef_init(grads))
    dec = decompress_grads(comp, grads)
    assert set(dec) == {"q", "scale"}
    np.testing.assert_allclose(dec["q"].numpy(), grads["q"].numpy(),
                               rtol=1e-2)
    assert dec["scale"].shape == (1,)


def test_error_feedback_is_unbiased():
    """Over T steps the decompressed gradients sum to the true ones minus
    the last residual, which stays within half a quantization step, so
    the mean error falls as 1/T."""
    rng = np.random.default_rng(6)
    true = {"w": torch.tensor(rng.standard_normal((4, 64)).astype(
        np.float32))}
    ef = ef_init(true)
    total = torch.zeros_like(true["w"])
    for t in range(1, 201):
        comp, ef = compress_grads(true, ef)
        total += decompress_grads(comp, true)["w"]
        gap = (t * true["w"] - total).abs().max()
        scale = comp["w"]["scale"].max()
        assert float(gap) <= 0.5 * float(scale) * 1.01 + 1e-4 * t ** 0.5
    assert float((total / 200 - true["w"]).abs().max()) < 1e-3
