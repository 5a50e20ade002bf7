"""flash_attention's gradient on the CPU against the reference.

The reference has no backward kernel: its gradient is ``jax.grad`` of
the plain oracle ``src/repro/kernels/flash_attention/ref.py:attention_ref``
(heads repeated for grouped-query attention, (BH, S, hd) layout).  The
port's plain FA2 backward (:func:`flash_attention_bwd_plain`, from the
forward's log-sum-exp) and autograd through ``flash_attention()`` on CPU
tensors (:class:`FlashAttentionFn` with the plain forward and backward)
are held to it at 1e-5, causal and not, MHA and GQA, ragged S, and
Sq != Sk without the mask.  The CUDA kernel is held to the plain version
on the card (``test_torch_flash_attention_bwd_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_cost,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cost)
from repro_torch.kernels.flash_attention.ops import (PLAIN_BLOCK_K,
                                                     _plain_forward)

torch.set_num_threads(1)

TOL = 1e-5

# (B, Sq, Sk, H, KVH, hd, causal): MHA and GQA; S across the plain
# version's 256-key tile (ragged: 300, 513); Sq != Sk without the mask
SHAPES = [
    (2, 16, 16, 4, 4, 16, True), (1, 37, 37, 4, 2, 16, True),
    (2, 300, 300, 4, 1, 32, True), (1, 513, 513, 2, 2, 16, True),
    (1, 64, 64, 6, 2, 64, False), (2, 24, 40, 4, 2, 16, False),
    (1, 300, 260, 2, 1, 32, False), (1, 33, 33, 2, 2, 128, True),
]


def _inputs(b, sq, sk, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    return q, k, v, do


def _to_ref(x, rep):
    """(B, S, KVH, hd) -> the reference's (B*H, S, hd), heads repeated."""
    b, s, n, d = x.shape
    x = np.repeat(x, rep, axis=2)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * n * rep, s, d))


def _from_ref(g, b, h, kvh):
    """The reference's (B*H, S, hd) gradient -> (B, S, KVH, hd), summed
    over each KV head's group."""
    g = np.asarray(g)
    _, s, d = g.shape
    g = g.reshape(b, kvh, h // kvh, s, d).sum(2)
    return g.transpose(0, 2, 1, 3)


def _reference(q, k, v, do, causal):
    """(out, dq, dk, dv, lse) of the reference's oracle, by jax.vjp."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    jq, jk, jv = _to_ref(q, 1), _to_ref(k, rep), _to_ref(v, rep)
    out, vjp = jax.vjp(lambda a, c, e: attention_ref(a, c, e, causal),
                       jq, jk, jv)
    gq, gk, gv = vjp(_to_ref(do, 1))
    s = jnp.einsum("bqd,bkd->bqk", jq, jk) / np.sqrt(hd)
    if causal:
        mask = jnp.arange(k.shape[1])[None, :] <= jnp.arange(sq)[:, None]
        s = jnp.where(mask[None], s, -1e30)
    lse = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(b, h, sq)
    out = np.asarray(out).reshape(b, h, sq, hd).transpose(0, 2, 1, 3)
    return (out, _from_ref(gq, b, h, h), _from_ref(gk, b, h, kvh),
            _from_ref(gv, b, h, kvh), lse)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("b,sq,sk,h,kvh,hd,causal", SHAPES)
def test_plain_backward_matches_reference(b, sq, sk, h, kvh, hd, causal):
    q, k, v, do = _inputs(b, sq, sk, h, kvh, hd, seed=sq + hd)
    out, dq, dk, dv, lse = _reference(q, k, v, do, causal)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    o, tl = _plain_forward(tq, tk, tv, causal)
    _close(o, out, "forward")
    _close(tl, lse, "lse")
    got = flash_attention_bwd_plain(tq, tk, tv, o, torch.tensor(do), tl,
                                    causal=causal)
    for g, want, what in zip(got, (dq, dk, dv), ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        _close(g, want, what)


@pytest.mark.parametrize("b,sq,sk,h,kvh,hd,causal", SHAPES)
def test_autograd_through_flash_attention_matches_reference(
        b, sq, sk, h, kvh, hd, causal):
    q, k, v, do = _inputs(b, sq, sk, h, kvh, hd, seed=7 * sq + hd)
    out, dq, dk, dv, _ = _reference(q, k, v, do, causal)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    _close(o, out, "forward")
    o.backward(torch.tensor(do))
    for t, want, what in ((tq, dq, "dq"), (tk, dk, "dk"), (tv, dv, "dv")):
        _close(t.grad, want, what)


def test_float64_plain_backward_is_the_exact_gradient():
    """In float64, from the float64 lse, the plain backward equals
    autograd through float64 attention to rounding: the oracle the card's
    checks use.  The fp32 forward's lse is the float64 one to 1e-5."""
    q, k, v, do = (torch.tensor(x, dtype=torch.float64)
                   for x in _inputs(1, 300, 300, 4, 2, 32, seed=3))
    mask = torch.ones(300, 300, dtype=torch.bool).tril()

    def attention64(q, k, v):
        kr, vr = (x.repeat_interleave(2, dim=2) for x in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / 32 ** 0.5
        s = torch.where(mask, s, -torch.inf)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr), \
            torch.logsumexp(s, dim=-1)

    o64, lse64 = attention64(q, k, v)
    got = flash_attention_bwd_plain(q, k, v, o64, do, lse64, causal=True)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    attention64(qq, kk, vv)[0].backward(do)
    for g, t in zip(got, (qq, kk, vv)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-10,
                                   atol=1e-10)
    _, lse = _plain_forward(q.float(), k.float(), v.float(), True)
    np.testing.assert_allclose(lse.numpy(), lse64.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_no_grad_call_keeps_the_plain_forward():
    """Without a gradient to take, flash_attention is the plain forward
    bit for bit and keeps no graph; with one, the same values."""
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 40, 40, 4, 2, 16, 0))
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert torch.equal(flash_attention(q.requires_grad_(True), k, v),
                           plain)
    graph = flash_attention(q, k, v)
    assert type(graph.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(graph.detach(), plain)


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do = (torch.tensor(x) for x in _inputs(1, 8, 8, 2, 1, 16, 0))
    o, lse = _plain_forward(q, k, v, True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, do, lse[:, :, :4].contiguous())
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, o, do, lse.double())
    got = flash_attention_bwd(q, k, v, o, do, lse)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_backward_cost_counts_five_products():
    ops, nbytes = flash_attention_bwd_cost(2, 4096, 4096, 32, 8, 64, True, 4)
    fwd_ops, _ = flash_attention_cost(2, 4096, 4096, 32, 8, 64, True, 4)
    assert ops == 2.5 * fwd_ops == 343_681_269_760
    assert nbytes == (4 * 2 * 4096 * 32 * 64 + 4 * 2 * 4096 * 8 * 64) * 4 \
        + 4 * 2 * 32 * 4096
    assert PLAIN_BLOCK_K == 256
