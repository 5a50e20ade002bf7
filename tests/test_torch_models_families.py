"""The port's moe (qwen2-moe-a2.7b: shared experts; arctic-480b: the dense
residual beside the MoE), vlm (internvl2-2b: precomputed input embeddings)
and audio (whisper-medium: encoder-decoder with cross-attention) families
against the reference, on each arch's smoke config in fp32, with the
reference's weights carried across by ``params_from_jax``: forward logits
and the MoE aux loss, the vlm forward on embeddings, the audio encoder
alone, decode steps (with cross-attention and with the reference's
encoder-less cache), all at rtol 1e-4, atol 1e-5; decode against the
port's own forward with drops disabled (2e-3, as tests/test_models.py);
and the server's greedy tokens (exact), with capacity drops at decode.

The reference is evaluated op by op (``jax.disable_jit``), as
tests/test_torch_models.py and tests/test_torch_models_hybrid.py do;
the server comparisons run the reference's own (compiled) server.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch.serve import serve as j_serve
from repro.models import attention as JA
from repro.models import build_model as j_build
from repro_torch.configs import get_arch
from repro_torch.launch.serve import greedy_generate, serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models.attention import CHUNKED_THRESHOLD
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ARCH_IDS = ["qwen2-moe-a2.7b", "arctic-480b", "internvl2-2b",
            "whisper-medium"]
RTOL, ATOL = 1e-4, 1e-5
LONG_S = 2560                      # above CHUNKED_THRESHOLD


def _models(arch, seed=0, **extra):
    """(reference model, reference params, port model with those params):
    the params are what the reference's server draws with `seed`."""
    jcfg, cfg = (dataclasses.replace(c.smoke(), **extra)
                 for c in (J_ARCHS[arch], get_arch(arch)))
    jm = j_build(jcfg, dtype=jnp.float32, remat=False)
    params = jax.jit(jm.init)(jax.random.key(seed))
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    m.load_state_dict(params_from_jax(cfg, params), strict=True)
    return jm, params, m


@pytest.fixture(scope="module", params=ARCH_IDS)
def family(request):
    return _models(request.param)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_ctx, cfg.d_model)).astype(np.float32)


def _batches(cfg, b, s, seed):
    """(reference batch, port batch) of tokens, with frames for audio."""
    toks = _tokens(b, s, seed)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if cfg.family == "audio":
        fr = _frames(cfg, b, seed + 100)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.tensor(fr)
    return jb, tb


def test_forward_and_aux_match_reference(family):
    jm, params, m = family
    jb, tb = _batches(m.cfg, 2, 16, seed=1)
    with jax.disable_jit():
        want, want_aux = jm.forward(params, jb, collect_aux=True)
    got = make_prefill_step(m)(tb)
    aux = m.forward(tb, collect_aux=True)[1]
    assert got.shape == (2, 16, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert (float(aux) > 0) == bool(m.cfg.n_experts)


@pytest.mark.parametrize("family", ["internvl2-2b"], indirect=True)
def test_vlm_forward_on_embeddings(family):
    """Stub patch embeddings at the embedding's scale followed by prompt
    token embeddings (the internvl2 input), against the reference; and
    the embeddings of tokens give the tokens' forward bit for bit."""
    jm, params, m = family
    toks = _tokens(2, 16, seed=2)
    patches = (np.random.default_rng(3).standard_normal((2, 8, 64))
               * 0.02).astype(np.float32)
    emb = np.concatenate([patches, m.embed.detach().numpy()[toks[:, 8:]]],
                         axis=1)
    with jax.disable_jit():
        want = jm.forward(params, {"embeds": jnp.asarray(emb)})
    got = make_prefill_step(m)({"embeds": torch.tensor(emb)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    t = torch.as_tensor(toks)
    assert torch.equal(make_prefill_step(m)({"embeds": m.embed[t]}),
                       make_prefill_step(m)({"tokens": t}))


@pytest.mark.parametrize("family", ["whisper-medium"], indirect=True)
def test_encoder_matches_reference(family):
    jm, params, m = family
    fr = _frames(m.cfg, 2, seed=4)
    with jax.disable_jit():
        want = jm._encoder_stack(params, jnp.asarray(fr))
    got = m.encode(torch.tensor(fr))
    assert got.shape == (2, m.cfg.enc_ctx, m.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _decode_both(jm, params, m, toks, fr=None):
    """Per-step logits of the reference (op by op) and of the port over
    `toks`, from caches holding the encoder output of `fr` if given."""
    b, n = toks.shape
    jenc = enc = None
    if fr is not None:
        with jax.disable_jit():
            jenc = jm._encoder_stack(params, jnp.asarray(fr))
        enc = m.encode(torch.tensor(fr))
    jcache, cache = jm.init_cache(b, 16, enc_out=jenc), \
        m.init_cache(b, 16, enc_out=enc)
    step, want, got = make_serve_step(m), [], []
    for t in range(n):
        with jax.disable_jit():
            jl, jcache = jm.decode_step(params, jcache,
                                        jnp.asarray(toks[:, t]))
        lg, cache = step(cache, torch.as_tensor(toks[:, t]))
        want.append(np.asarray(jl))
        got.append(lg.numpy())
    assert cache["len"] == n
    return np.stack(want, 1), np.stack(got, 1)


def test_decode_steps_match_reference(family):
    jm, params, m = family
    toks = _tokens(2, 8, seed=4)
    fr = _frames(m.cfg, 2, seed=5) if m.cfg.family == "audio" else None
    want, got = _decode_both(jm, params, m, toks, fr)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["whisper-medium"], indirect=True)
def test_encoderless_audio_cache_skips_cross_attention(family):
    """The reference's ``init_cache`` without ``enc_out`` decodes with no
    cross-attention at all; the port keeps that, and it is not the
    decode with an encoder output."""
    jm, params, m = family
    toks = _tokens(2, 4, seed=6)
    want, got = _decode_both(jm, params, m, toks)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert m.init_cache(2, 16)["enc"] is None
    _, with_enc = _decode_both(jm, params, m, toks, _frames(m.cfg, 2, 7))
    assert np.abs(with_enc - got).max() > 1e-2


def test_decode_matches_forward(family):
    """Step-by-step decode logits == the forward's, the port against
    itself with drops disabled (moe_capacity = n_experts), at
    tests/test_models.py's 2e-3; audio decodes from the encoder output of
    the forward's frames."""
    _, _, m0 = family
    m = build_model(m0.cfg, dtype=torch.float32, device="cpu",
                    moe_capacity=float(max(m0.cfg.n_experts, 1)))
    m.load_state_dict(m0.state_dict())
    _, tb = _batches(m.cfg, 2, 8, seed=5)
    full = make_prefill_step(m)(tb)
    enc = m.encode(tb["frames"]) if "frames" in tb else None
    cache, step = m.init_cache(2, 8, enc_out=enc), make_serve_step(m)
    for t in range(8):
        lg, cache = step(cache, tb["tokens"][:, t])
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_greedy_tokens_equal_reference(arch):
    """The reference's own server at batch 4, prompt 8, gen 4 (at decode
    batch 4 the MoE capacity is 3 slots an expert, so colliding
    assignments drop, in both).  Whisper's smoke server repeats one
    token, so its decode logits over the served sequence are held too."""
    b, prompt_len, gen, seed = 4, 8, 4, 0
    want = j_serve(arch, b, prompt_len, gen, smoke=True, seed=seed)
    jm, params, m = _models(arch, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, m.cfg.vocab, (b, prompt_len))
    fr = None
    enc = None
    if m.cfg.family == "audio":
        fr = rng.standard_normal((b, m.cfg.enc_ctx, m.cfg.d_model)) \
            .astype(np.float32)
        enc = m.encode(torch.tensor(fr))
    got = greedy_generate(m, torch.as_tensor(prompts), gen, enc_out=enc)
    assert got["tokens"].shape == (b, gen)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["ttft_s"] > 0 and got["tpot_s"] > 0
    if fr is not None:
        seq = np.concatenate([prompts, want["tokens"]], axis=1)
        jl, tl = _decode_both(jm, params, m, seq[:, :-1], fr)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_entry_point_builds_the_family(arch):
    """The CLI's function on the CPU: seeded weights, the audio family's
    frames encoded once, greedy tokens."""
    r = serve(arch, 2, 4, 3, smoke=True, seed=1, device="cpu")
    assert r["tokens"].shape == (2, 3)
    assert ((r["tokens"] >= 0) & (r["tokens"] < 256)).all()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-2b"])
def test_forward_above_chunked_threshold_matches_reference(arch):
    """S 2560 takes the chunked attention branch; the MoE routes 5,120
    assignments at capacity 1,600 an expert; the vlm reads embeddings."""
    jm, params, m = _models(arch, n_layers=1)
    assert LONG_S > CHUNKED_THRESHOLD
    toks = _tokens(1, LONG_S, seed=8)
    if m.cfg.family == "vlm":
        emb = m.embed.detach().numpy()[toks] + (np.random.default_rng(9)
                                                .standard_normal(
                                                    (1, LONG_S, 64))
                                                * 0.02).astype(np.float32)
        jb, tb = {"embeds": jnp.asarray(emb)}, {"embeds": torch.tensor(emb)}
    else:
        jb, tb = {"tokens": jnp.asarray(toks)}, \
            {"tokens": torch.as_tensor(toks)}
    with jax.disable_jit():
        want, want_aux = jm.forward(params, jb, collect_aux=True)
    got, aux = m.forward(tb, collect_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("sq,sk,causal,cross", [
    (8, 12, False, True), (12, 12, False, False), (12, 12, True, False),
    (LONG_S, LONG_S, False, False)])
def test_attention_block_cross_and_noncausal_routes(sq, sk, causal, cross):
    """attention_block's cross-attention (kv=) and non-causal routes, the
    encoder's and the decoder's, against the reference's (GQA 4/2, qkv
    bias, no RoPE); a non-causal S above the threshold stays on
    full_attention in both."""
    jp = JA.init_attention(jax.random.key(1), 64, 4, 2, 16, True,
                           dtype=jnp.float32)
    p = TA.Attention(64, 4, 2, 16, True, device="cpu")
    p.load_state_dict({f"{n}.{k}": torch.tensor(np.asarray(v))
                       for n, sub in jp.items() for k, v in sub.items()},
                      strict=True)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, sq, 64)).astype(np.float32)
    kv = rng.standard_normal((1, sk, 64)).astype(np.float32) if cross \
        else None
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=None,
              causal=causal)
    with jax.disable_jit():
        want = JA.attention_block(
            jp, jnp.asarray(x), kv=None if kv is None else jnp.asarray(kv),
            **kw)
    got = TA.attention_block(p, torch.tensor(x),
                             kv=None if kv is None else torch.tensor(kv),
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_from_jax_lands_every_leaf_exactly_once(arch):
    """Three layers (and three encoder layers): every element of every
    reference leaf, each given a distinct value, lands in the state dict
    exactly once, at its layer, and loads strictly; ``moe.shared``,
    Arctic's ``mlp`` beside its ``moe``, ``ln_x``/``xattn`` and
    ``enc_layers.<i>`` among them."""
    extra = {"n_layers": 3, "enc_layers": 3 if arch == "whisper-medium"
             else 0}
    jcfg, cfg = (dataclasses.replace(c.smoke(), **extra)
                 for c in (J_ARCHS[arch], get_arch(arch)))
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
    want = {"layers.2.attn.q.w": lyr["attn"]["q"]["w"][2]}
    if cfg.n_experts:
        want["layers.1.moe.w_down"] = lyr["moe"]["w_down"][1]
        want["layers.2.moe.router"] = lyr["moe"]["router"][2]
    if cfg.n_shared_experts:
        want["layers.1.moe.shared.w_gate"] = \
            lyr["moe"]["shared"]["w_gate"][1]
    if not cfg.n_experts or cfg.dense_residual:
        want["layers.1.mlp.w_up"] = lyr["mlp"]["w_up"][1]
    if cfg.family == "audio":
        enc = tree["enc_layers"]
        want.update({"layers.1.xattn.k.b": lyr["xattn"]["k"]["b"][1],
                     "layers.2.ln_x": lyr["ln_x"][2],
                     "enc_layers.1.attn.v.w": enc["attn"]["v"]["w"][1],
                     "enc_layers.2.mlp.w_down": enc["mlp"]["w_down"][2],
                     "enc_norm": tree["enc_norm"]})
        with pytest.raises(ValueError, match="enc_layers"):
            params_from_jax(cfg, {**tree, "enc_layers": jax.tree.map(
                lambda a: a[:2], enc)})
    for key, w in want.items():
        np.testing.assert_array_equal(m.state_dict()[key].numpy(), w,
                                      err_msg=key)


@pytest.mark.parametrize("arch,extra,n", [
    ("qwen2-moe-a2.7b", {}, 15_146_207_232),
    ("internvl2-2b", {}, 1_889_146_880),
    ("whisper-medium", {}, 811_208_704),
    ("arctic-480b", {}, 476_850_275_328),
    ("arctic-480b", {"n_layers": 1}, 14_069_945_344)])
def test_full_width_parameter_counts(arch, extra, n):
    """Full-width counts on the meta device (nothing allocated) equal the
    reference's (``jax.eval_shape`` of its init): qwen2-moe 56.4 GiB in
    fp32, arctic cut to one layer 52.4 GiB, both within one 80 GB card;
    arctic at full depth fits on none."""
    cfg = dataclasses.replace(get_arch(arch), **extra)
    m = build_model(cfg, device="meta")
    got = sum(p.numel() for p in m.parameters())
    shapes = jax.eval_shape(j_build(dataclasses.replace(J_ARCHS[arch],
                                                        **extra)).init,
                            jax.random.key(0))
    assert got == n == sum(int(np.prod(s.shape))
                           for s in jax.tree.leaves(shapes))
