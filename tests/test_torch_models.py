"""The port's LM stack against the reference on the smoke configs of
llama3.2-1b (dense) and rwkv6-7b (ssm), with the reference's weights
carried across by ``params_from_jax``: forward logits, decode steps and
the server's greedy tokens, all in fp32 at rtol 1e-4, atol 1e-5.

The reference model is evaluated op by op (``jax.disable_jit``), as its
plain jnp functions read.  Compiled, XLA CPU's fusions round differently
at two places these tests reach: RoPE's fused sin/cos at angles near 2560
rad (up to 1.8e-4 off a float64 evaluation,
``test_compiled_reference_rope_rounding``, which takes the S 2560 llama
logits to 0.97x of the tolerance) and the rwkv6 smoke model's second
decode step (compiled vs op by op: 2.5x the tolerance,
``test_compiled_reference_rwkv_decode_rounding``); the port agrees with
the op-by-op reference.  The one exception is the rwkv6 forward at
S 2560, whose 2560-step scan takes minutes op by op; it has no RoPE and
is compared with the compiled reference.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch.serve import serve as j_serve
from repro.models import build_model as j_build
from repro.models.layers import apply_rope as j_apply_rope
from repro.models.layers import rope_freqs as j_rope_freqs
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.serve import greedy_generate
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models.attention import CHUNKED_THRESHOLD
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import apply_rope

torch.set_num_threads(1)

ARCH_IDS = ["llama3.2-1b", "rwkv6-7b"]
RTOL, ATOL = 1e-4, 1e-5
LONG_S = 2560                      # above CHUNKED_THRESHOLD


def _models(arch, seed=0):
    """(reference model, reference params, port model with those params)."""
    jm = j_build(J_ARCHS[arch].smoke(), dtype=jnp.float32, remat=False)
    params = jax.jit(jm.init)(jax.random.key(seed))
    cfg = get_arch(arch).smoke()
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    m.load_state_dict(params_from_jax(cfg, params))
    return jm, params, m


@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    return _models(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


# the port's own ArchConfig fields (Finch's layer), which the reference's
# lacks: every entry of ARCHS leaves them at these defaults
PORT_ONLY = {"rwkv_mix_lora": 0, "rwkv_decay_lora": 0}


def test_configs_match_reference():
    """Every field of the reference's ArchConfig equal, for every arch and
    its smoke(); the port's own fields at their defaults."""
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name, cfg in ARCHS.items():
        for got, want in ((get_arch(name), J_ARCHS[name]),
                          (cfg.smoke(), J_ARCHS[name].smoke())):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert {k: got[k] for k in want} == want
            assert {k: v for k, v in got.items() if k not in want} == \
                PORT_ONLY


def test_forward_matches_reference(pair):
    jm, params, m = pair
    toks = _tokens(m.cfg, 2, 16, seed=1)
    with jax.disable_jit():
        want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    got = make_prefill_step(m)({"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 16, m.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_forward_above_chunked_threshold_matches_reference(pair):
    """S 2560 takes the chunked branch (llama) and a 2560-step scan
    (rwkv; compiled reference, see the module docstring)."""
    jm, params, m = pair
    assert LONG_S > CHUNKED_THRESHOLD
    toks = _tokens(m.cfg, 1, LONG_S, seed=2)
    op_by_op = m.cfg.family == "dense"
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    got = make_prefill_step(m)({"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_compiled_reference_rope_rounding():
    """The rounding fact behind the op-by-op reference above: on the same
    fp32 angles, the port's RoPE is within 1e-6 of a float64 evaluation
    at positions up to 2560, the compiled reference's is not."""
    hd, theta = 16, 5e5
    x = np.random.default_rng(3).standard_normal(
        (1, LONG_S, 4, hd)).astype(np.float32)
    pos = np.arange(LONG_S)[None]
    ang = (pos[0][:, None].astype(np.float32)
           * np.asarray(j_rope_freqs(hd, theta))).astype(np.float64)
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
    x1, x2 = x[0, ..., :hd // 2], x[0, ..., hd // 2:]
    exact = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    port = apply_rope(torch.tensor(x), torch.tensor(pos), theta).numpy()[0]
    compiled = np.asarray(jax.jit(lambda a, p: j_apply_rope(a, p, theta))(
        jnp.asarray(x), jnp.asarray(pos)))[0]
    assert np.abs(port - exact).max() < 1e-6
    assert np.abs(compiled - exact).max() > 1e-5


def test_compiled_reference_rwkv_decode_rounding():
    """The other rounding fact behind the op-by-op reference: on the rwkv6
    smoke model, the reference's compiled decode steps leave its own
    op-by-op evaluation by more than the tolerance, while the port stays
    within it at every step."""
    jm, params, m = _models("rwkv6-7b")
    toks = _tokens(m.cfg, 2, 8, seed=4)
    jc, je, cache = jm.init_cache(2, 16), jm.init_cache(2, 16), \
        m.init_cache(2, 16)
    step = make_serve_step(m)

    def ratio(got, want):
        return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))

    compiled, port = [], []
    for t in range(toks.shape[1]):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
        with jax.disable_jit():
            el, je = jm.decode_step(params, je, jnp.asarray(toks[:, t]))
        lg, cache = step(cache, torch.as_tensor(toks[:, t]))
        compiled.append(ratio(np.asarray(jl), np.asarray(el)))
        port.append(ratio(lg.numpy(), np.asarray(el)))
    assert max(compiled) > 1.0
    assert max(port) < 1.0


def _deep_rwkv(dtype, n_layers=32, d_model=512, head=64):
    """rwkv6-7b's family at full depth and head size, narrower, with the
    seeded init of ``init_weights`` drawn in fp64 and cast to `dtype`."""
    cfg = dataclasses.replace(
        get_arch("rwkv6-7b").smoke(), n_layers=n_layers, d_model=d_model,
        n_heads=d_model // head, n_kv_heads=d_model // head, head_dim=head,
        rwkv_head_size=head, d_ff=d_model * 7 // 2)
    m64 = build_model(cfg, dtype=torch.float64, device="cpu")
    m64.init_weights(torch.Generator().manual_seed(0))
    if dtype == torch.float64:
        return m64
    m = build_model(cfg, dtype=dtype, device="cpu")
    m.load_state_dict(m64.state_dict())
    return m


def _forward_and_decode(m, toks):
    full = make_prefill_step(m)({"tokens": toks})
    cache, step, out = m.init_cache(toks.shape[0], toks.shape[1]), \
        make_serve_step(m), []
    for t in range(toks.shape[1]):
        lg, cache = step(cache, toks[:, t])
        out.append(lg)
    return full.double(), torch.stack(out, dim=1).double()


def test_rwkv_decode_gap_at_depth_is_rounding():
    """Why full-width rwkv6-7b decode leaves its prefill by O(1) on the card
    (ROADMAP section 3): at full depth (32 layers, head 64, d 512) and the
    same init, decode_step and forward agree to 1e-8 in fp64, so no fault
    needs depth to show; in fp32 they part by more than the 2e-3 of
    test_decode_matches_forward, and the fp32 forward is as far from the
    fp64 one.  Two layers of the same fp32 model stay within 1e-4."""
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (1, 32)))
    f64, d64 = _forward_and_decode(_deep_rwkv(torch.float64), toks)
    f32, d32 = _forward_and_decode(_deep_rwkv(torch.float32), toks)
    assert float((d64 - f64).abs().max()) < 1e-8
    assert float((d32 - f32).abs().max()) > 2e-3
    assert float((f32 - f64).abs().max()) > 2e-3
    f2, d2 = _forward_and_decode(_deep_rwkv(torch.float32, n_layers=2), toks)
    assert float((d2 - f2).abs().max()) < 1e-4


def test_decode_steps_match_reference(pair):
    jm, params, m = pair
    b, n = 2, 8
    toks = _tokens(m.cfg, b, n, seed=4)
    jcache = jm.init_cache(b, 16)
    cache = m.init_cache(b, 16)
    step = make_serve_step(m)
    for t in range(n):
        with jax.disable_jit():
            jl, jcache = jm.decode_step(params, jcache,
                                        jnp.asarray(toks[:, t]))
        lg, cache = step(cache, torch.as_tensor(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
    assert cache["len"] == n


def test_decode_matches_forward(pair):
    """Step-by-step decode logits == the forward's (the port against
    itself, at tests/test_models.py's 2e-3)."""
    _, _, m = pair
    toks = torch.as_tensor(_tokens(m.cfg, 2, 8, seed=5))
    full = make_prefill_step(m)({"tokens": toks})
    cache = m.init_cache(2, 8)
    step = make_serve_step(m)
    for t in range(8):
        lg, cache = step(cache, toks[:, t])
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_greedy_tokens_equal_reference(arch):
    b, prompt_len, gen, seed = 2, 8, 6, 0
    want = j_serve(arch, b, prompt_len, gen, smoke=True, seed=seed)
    _, _, m = _models(arch, seed=seed)
    prompts = np.random.default_rng(seed).integers(0, m.cfg.vocab,
                                                   (b, prompt_len))
    got = greedy_generate(m, torch.as_tensor(prompts), gen)
    assert got["tokens"].shape == (b, gen)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["ttft_s"] > 0 and got["tpot_s"] > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_builds_and_round_trips(arch):
    """Every family builds from its smoke config, and the reference's
    parameters carried across by ``params_from_jax`` load strictly and
    come back out of the port's state dict unchanged."""
    cfg = get_arch(arch).smoke()
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    params = jax.jit(j_build(J_ARCHS[arch].smoke(), dtype=jnp.float32,
                             remat=False).init)(jax.random.key(0))
    sd = params_from_jax(cfg, params)
    m.load_state_dict(sd, strict=True)
    got = m.state_dict()
    assert set(got) == set(sd)
    for key, want in sd.items():
        assert torch.equal(got[key], want), key
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in m.parameters()) == n


def test_unknown_family_raises():
    cfg = dataclasses.replace(get_arch("llama3.2-1b").smoke(),
                              family="diffusion")
    with pytest.raises(ValueError, match="diffusion"):
        build_model(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="diffusion"):
        params_from_jax(cfg, {})


def test_seeded_init_is_deterministic():
    cfg = get_arch("rwkv6-7b").smoke()
    a, b = (build_model(cfg, dtype=torch.float32, device="cpu")
            for _ in range(2))
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.all(a.layers[0].rwkv.w_bias == -6.0)


@pytest.mark.parametrize("gated", [True, False])
def test_layers_match_reference(gated):
    """rms_norm, layer_norm, RoPE and both MLP kinds against the
    reference's functions, on the same numpy inputs (fp32)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w, b = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    jx, tx = jnp.asarray(x), torch.tensor(x)
    np.testing.assert_allclose(
        TL.rms_norm(torch.tensor(w), tx).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(w), jx)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TL.layer_norm(torch.tensor(w), torch.tensor(b), tx).numpy(),
        np.asarray(JL.layer_norm(jnp.asarray(w), jnp.asarray(b), jx)),
        rtol=RTOL, atol=ATOL)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    pos = np.arange(3, 8)[None]
    np.testing.assert_allclose(
        TL.apply_rope(torch.tensor(q), torch.tensor(pos), 1e4).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        rtol=RTOL, atol=ATOL)
    jp = JL.init_mlp(jax.random.key(1), 32, 48, gated=gated, bias=not gated,
                     dtype=jnp.float32)
    p = TL.MLP(32, 48, gated, bias=not gated)
    p.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in jp.items()})
    np.testing.assert_allclose(TL.mlp(p, tx).numpy(),
                               np.asarray(JL.mlp(jp, jx, gated=gated)),
                               rtol=RTOL, atol=ATOL)


def test_params_from_jax_carries_bf16_exactly():
    """A bf16 reference pytree lands in a bf16 port model bit for bit, with
    every parameter of the model filled."""
    jm = j_build(J_ARCHS["llama3.2-1b"].smoke(), dtype=jnp.bfloat16,
                 remat=False)
    params = jm.init(jax.random.key(2))
    cfg = get_arch("llama3.2-1b").smoke()
    m = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    sd = params_from_jax(cfg, params)
    assert set(sd) == set(m.state_dict())
    m.load_state_dict(sd)
    want = np.asarray(params["layers"]["attn"]["q"]["w"][1], np.float32)
    got = m.layers[1].attn.q.w.float().numpy()
    assert m.layers[1].attn.q.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want)


def test_dtype_defaults_match_the_reference():
    """Code that omits `dtype` gets the reference's dtype on the port too:
    bf16 for ``Model`` / ``build_model``, fp32 for ``serve``."""
    import inspect

    from repro.models.transformer import Model as JModel
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model

    def name(dt) -> str:
        return str(dt).removeprefix("torch.") if isinstance(
            dt, torch.dtype) else jnp.dtype(dt).name

    def default(fn):
        return inspect.signature(fn).parameters["dtype"].default

    j_model = {f.name: f.default for f in dataclasses.fields(JModel)}["dtype"]
    pairs = [(Model.__init__, j_model), (build_model, default(j_build)),
             (serve, default(j_serve))]
    assert [name(default(fn)) for fn, _ in pairs] == \
        [name(want) for _, want in pairs] == \
        ["bfloat16", "bfloat16", "float32"]
