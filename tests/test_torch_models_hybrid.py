"""The port's hybrid (Jamba) family against the reference, with the
reference's weights carried across by ``params_from_jax``, in fp32:
forward logits and aux loss, decode steps (rtol 1e-4, atol 1e-5), decode
against the port's own forward with drops disabled (2e-3, as
tests/test_models.py) and the server's greedy tokens (exact).

Two configurations: jamba-1.5-large-398b's smoke config, one block of the
true period (``attn_every`` 8: attention, 7 Mamba sub-layers, 4 MoE and 4
dense FFNs), and the cut that runs at full width on the card, ``attn_every``
2 (``replace(cfg, attn_every=2).smoke()``: n_layers 2, one attention
sub-layer with an MoE FFN and one Mamba sub-layer with a dense FFN).

The reference is evaluated op by op (``jax.disable_jit``): compiled, it
rounds otherwise, and the port's smoke forward, 0.70x of the tolerance from
the op-by-op reference, is 1.02x from the compiled one
(``test_compiled_reference_hybrid_rounding``; ROADMAP section 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as j_serve_mod
from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro_torch.configs import get_arch
from repro_torch.launch.serve import greedy_generate, serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
RTOL, ATOL = 1e-4, 1e-5
VARIANTS = {"smoke": {}, "cut": {"attn_every": 2}}


def _cfgs(variant, **extra):
    """(reference cfg, port cfg): the arch with `variant`'s replacements,
    at smoke widths, then `extra`'s."""
    return tuple(dataclasses.replace(
        dataclasses.replace(c, **VARIANTS[variant]).smoke(), **extra)
        for c in (J_ARCHS[ARCH], get_arch(ARCH)))


@pytest.fixture(scope="module", params=list(VARIANTS))
def hybrid(request):
    """(reference model, reference params, port model with those params);
    the params are what the reference's server draws with seed 0."""
    jcfg, cfg = _cfgs(request.param)
    assert (cfg.n_layers, cfg.attn_every) == \
        ((8, 8) if request.param == "smoke" else (2, 2))
    jm = j_build(jcfg, dtype=jnp.float32, remat=False)
    params = jax.jit(jm.init)(jax.random.key(0))
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    m.load_state_dict(params_from_jax(cfg, params), strict=True)
    return request.param, jm, params, m


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def test_forward_matches_reference(hybrid):
    _, jm, params, m = hybrid
    toks = _tokens(2, 16, seed=1)
    with jax.disable_jit():
        want, want_aux = jm.forward(params, {"tokens": jnp.asarray(toks)},
                                    collect_aux=True)
    got, aux = make_prefill_step(m)({"tokens": torch.as_tensor(toks)}), \
        m.forward({"tokens": torch.as_tensor(toks)}, collect_aux=True)[1]
    assert got.shape == (2, 16, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("hybrid", ["smoke"], indirect=True)
def test_compiled_reference_hybrid_rounding(hybrid):
    """The rounding fact behind the op-by-op reference: on the smoke
    config the port's forward is within the tolerance of the op-by-op
    reference but not of the compiled one, which rounds otherwise
    (ROADMAP section 3)."""
    _, jm, params, m = hybrid
    toks = _tokens(2, 16, seed=1)

    def ratio(got, want):
        return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))

    got = make_prefill_step(m)({"tokens": torch.as_tensor(toks)}).numpy()
    with jax.disable_jit():
        eager = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    compiled = np.asarray(jax.jit(jm.forward)(
        params, {"tokens": jnp.asarray(toks)}))
    assert ratio(got, eager) < 1.0 < ratio(got, compiled)


def test_decode_steps_match_reference(hybrid):
    _, jm, params, m = hybrid
    b, n = 2, 8
    toks = _tokens(b, n, seed=4)
    jcache, cache = jm.init_cache(b, 16), m.init_cache(b, 16)
    step = make_serve_step(m)
    for t in range(n):
        with jax.disable_jit():
            jl, jcache = jm.decode_step(params, jcache,
                                        jnp.asarray(toks[:, t]))
        lg, cache = step(cache, torch.as_tensor(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
    assert cache["len"] == n
    for bi, states in enumerate(cache["mamba"]):
        for j, st in enumerate(states):
            for k in ("h", "conv"):
                np.testing.assert_allclose(
                    st[k].numpy(), np.asarray(jcache["mamba"][k][bi, j]),
                    rtol=RTOL, atol=ATOL, err_msg=f"mamba {bi}.{j} {k}")


def test_decode_matches_forward(hybrid):
    """Step-by-step decode logits == the forward's, the port against
    itself with drops disabled (moe_capacity = n_experts), at
    tests/test_models.py's 2e-3."""
    _, _, _, m0 = hybrid
    m = build_model(m0.cfg, dtype=torch.float32, device="cpu",
                    moe_capacity=float(m0.cfg.n_experts))
    m.load_state_dict(m0.state_dict())
    toks = torch.as_tensor(_tokens(2, 8, seed=5))
    full = make_prefill_step(m)({"tokens": toks})
    cache, step = m.init_cache(2, 8), make_serve_step(m)
    for t in range(8):
        lg, cache = step(cache, toks[:, t])
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_serve_greedy_tokens_equal_reference(hybrid, monkeypatch):
    """The reference's own server (compiled decode steps) at the same
    seed; the cut reaches it through the arch it looks up."""
    variant, _, _, m = hybrid
    monkeypatch.setattr(j_serve_mod, "get_arch", lambda name: dataclasses
                        .replace(J_ARCHS[name], **VARIANTS[variant]))
    b, prompt_len, gen, seed = 2, 8, 6, 0
    want = j_serve_mod.serve(ARCH, b, prompt_len, gen, smoke=True, seed=seed)
    prompts = np.random.default_rng(seed).integers(0, 256, (b, prompt_len))
    got = greedy_generate(m, torch.as_tensor(prompts), gen)
    assert got["tokens"].shape == (b, gen)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["ttft_s"] > 0 and got["tpot_s"] > 0


def test_serve_entry_point_builds_the_hybrid_family():
    """The CLI's function on the CPU: seeded weights, greedy tokens."""
    r = serve(ARCH, 2, 4, 3, smoke=True, seed=1, device="cpu")
    assert r["tokens"].shape == (2, 3)
    assert ((r["tokens"] >= 0) & (r["tokens"] < 256)).all()


def test_params_from_jax_lands_every_leaf_exactly_once():
    """Two blocks of the cut (n_layers 4): every element of every
    reference leaf, each given a distinct value, lands in the state dict
    exactly once, at its block and sub-layer, and loads strictly."""
    jcfg, cfg = _cfgs("cut", n_layers=4)
    shapes = jax.eval_shape(j_build(jcfg, dtype=jnp.float32,
                                    remat=False).init, jax.random.key(0))
    leaves, treedef = jax.tree.flatten(shapes)
    sizes = [int(np.prod(s.shape)) for s in leaves]
    assert sum(sizes) < 2 ** 24                  # exact in fp32
    start = np.cumsum([0] + sizes)
    tree = jax.tree.unflatten(treedef, [
        np.arange(start[i], start[i + 1], dtype=np.float32).reshape(s.shape)
        for i, s in enumerate(leaves)])
    sd = params_from_jax(cfg, tree)
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    assert set(sd) == set(m.state_dict())
    got = np.sort(np.concatenate([v.numpy().ravel() for v in sd.values()]))
    np.testing.assert_array_equal(got, np.arange(sum(sizes)))
    m.load_state_dict(sd, strict=True)
    lyr = tree["layers"]
    for key, want in {
            "layers.1.mamba.0.in_proj.w": lyr["mamba"]["in_proj"]["w"][1, 0],
            "layers.1.mamba.0.A_log": lyr["mamba"]["A_log"][1, 0],
            "layers.0.moe.0.w_down": lyr["moe"]["w_down"][0, 0],
            "layers.1.moe.0.router": lyr["moe"]["router"][1, 0],
            "layers.1.mlp.0.w_gate": lyr["mlp"]["w_gate"][1, 0],
            "layers.1.attn.q.w": lyr["attn"]["q"]["w"][1],
            "layers.1.mamba_ln": lyr["mamba_ln"][1],
            "layers.0.ffn_ln": lyr["ffn_ln"][0]}.items():
        np.testing.assert_array_equal(m.state_dict()[key].numpy(), want,
                                      err_msg=key)
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax(cfg, {**tree, "layers": jax.tree.map(
            lambda a: a[:1], lyr)})


def test_full_width_cut_parameter_counts():
    """The depth cut that runs at full width on the card (n_layers 2,
    attn_every 2) keeps every published width: 11.90 B parameters (44.3
    GiB in fp32), against 45.12 B (168 GiB fp32, 84 GiB bf16) for one true
    8-sub-layer period, which fits no 80 GB card.  Counted on the meta
    device, so nothing is allocated."""
    def count(**kw):
        m = build_model(dataclasses.replace(get_arch(ARCH), **kw),
                        device="meta")
        return sum(p.numel() for p in m.parameters())

    cut, period = count(n_layers=2, attn_every=2), count(n_layers=8)
    assert cut == 11_896_135_680 and round(cut * 4 / 2**30, 1) == 44.3
    assert period == 45_121_019_904 and period * 2 > 80e9
