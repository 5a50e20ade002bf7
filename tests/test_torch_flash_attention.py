"""flash_attention's plain PyTorch version against the reference kernel
(interpret mode) and its oracle, at the reference's own kernel tolerances
(2e-5 fp32, 2e-2 bf16, tests/test_kernels.py); and the port's
chunked/full attention against the reference's."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cost,
                                                 flash_attention_plain)
from repro_torch.models import attention as TA

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# tests/test_kernels.py::test_flash_attention's shapes
SHAPES = [(2, 128, 2, 64, 64, 64, True), (1, 256, 4, 128, 128, 64, True),
          (2, 64, 2, 32, 32, 32, False), (1, 128, 1, 64, 128, 128, True)]


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,hd,bq,bk,causal", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(b, s, h, hd, bq, bk,
                                                   causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs((b, s, h, hd), seed=s + hd)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    kern = j_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                   interpret=True)

    def fl(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)

    ref = attention_ref(fl(jq), fl(jk), fl(jv), causal=causal) \
        .reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.tensor(x).to(tdt) for x in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=causal)
    assert out.dtype == tdt and out.shape == (b, s, h, hd)
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=tol, atol=tol)
    # the wrapper on a CPU tensor is the plain version, and counts nothing
    before = flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, causal=causal), out)
    assert flash_attention.launches == before


@pytest.mark.parametrize("s", [100, 300])
def test_plain_gqa_and_ragged_match_the_oracle(s):
    """KV heads read as h // n_rep equal the repeated-KV oracle; a length
    that no tile divides is masked, not asserted."""
    b, h, kvh, hd = 2, 8, 2, 64
    q, = _inputs((b, s, h, hd), seed=1, n=1)
    k, v = _inputs((b, s, kvh, hd), seed=2, n=2)
    out = flash_attention_plain(*(torch.tensor(x) for x in (q, k, v)))
    kr, vr = (np.repeat(x, h // kvh, axis=2) for x in (k, v))

    def fl(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd))

    ref = np.asarray(attention_ref(fl(q), fl(kr), fl(vr), causal=True)) \
        .reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_and_full_attention_match_reference(causal):
    q, k, v = _inputs((2, 128, 4, 32), seed=3)
    jx, tx = [jnp.asarray(x) for x in (q, k, v)], [torch.tensor(x)
                                                   for x in (q, k, v)]
    full = TA.full_attention(*tx, causal=causal).numpy()
    np.testing.assert_allclose(
        full, np.asarray(JA.full_attention(*jx, causal=causal)),
        rtol=2e-5, atol=2e-5)
    ch = TA.chunked_attention(*tx, causal=causal, q_chunk=32,
                              k_chunk=64).numpy()
    np.testing.assert_allclose(
        ch, np.asarray(JA.chunked_attention(*jx, causal=causal, q_chunk=32,
                                            k_chunk=64)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ch, full, rtol=2e-5, atol=2e-5)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
              for _ in range(2))
    got = TA.gqa_decode_attention(torch.tensor(q), torch.tensor(kc),
                                  torch.tensor(vc), 7).numpy()
    want = JA.gqa_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(7))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    rep = [np.repeat(x, 4, axis=2) for x in (kc, vc)]
    got = TA.decode_attention(torch.tensor(q), *map(torch.tensor, rep),
                              7).numpy()
    want = JA.decode_attention(jnp.asarray(q), *map(jnp.asarray, rep),
                               jnp.asarray(7))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        k[..., :48].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros((1, 8, 3, 64)),
                        torch.zeros((1, 8, 3, 64)))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)


def test_cost_counts_the_kept_pairs():
    ops, nbytes = flash_attention_cost(2, 4096, 4096, 32, 8, 64, True, 4)
    assert ops == 4 * 2 * 32 * 64 * (4096 * 4097 // 2)       # ~137 GFLOP
    assert nbytes == (2 * 2 * 4096 * 32 * 64 + 2 * 2 * 4096 * 8 * 64) * 4
    ops_nc, _ = flash_attention_cost(1, 8, 8, 1, 1, 32, False, 2)
    assert ops_nc == 4 * 32 * 64


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> nearest TF32 (10-bit mantissa, ties away from zero), as
    cvt.rna.tf32.f32 and the kernel's integer split round: add half of
    the 13 dropped bits to the magnitude, then clear them."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000) \
        .view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, split: bool):
    """a @ b as the kernel's fp32 route computes it on the tensor cores:
    products of TF32 values (exact in fp32), sums in fp32.  split: three
    products of big = rna(x) and small = trunc(x - big), small terms
    first; else one product of the rounded operands."""
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    if not split:
        return ab @ bb
    asm, bsm = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


@pytest.mark.parametrize("split", [True, False], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("hd,s", [(64, 512), (128, 256)])
def test_tf32_split_keeps_the_fp32_tolerance(hd, s, split):
    """The arithmetic of the kernel's fp32 route, emulated on the CPU: the
    3xTF32 split of both products of causal attention stays within the
    fp32 tolerance (2e-5) of flash_attention_plain, while one TF32 product
    per matmul misses it, which is why the kernel splits."""
    b, h = 1, 4
    q, k, v = (torch.tensor(x) for x in _inputs((b, s, h, hd), seed=hd))
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    scores = _tf32_matmul(qh, kh.transpose(-1, -2), split) / math.sqrt(hd)
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    scores = torch.where(keep, scores, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = _tf32_matmul(p, vh, split) / p.sum(dim=-1, keepdim=True)
    got = out.permute(0, 2, 1, 3).numpy()
    want = flash_attention_plain(q, k, v, causal=True).numpy()
    if split:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert np.max(np.abs(got - want)) > 2e-5
