"""``flash_attention``: attention with online softmax and its gradient,
CUDA kernels + plain versions.

:func:`flash_attention` is the wrapper the model's attention layer calls
for long causal self-attention.  On a CUDA tensor it launches the
hand-written kernel in ``flash_attention.cu`` (built with nvcc at first
use) on the current stream and counts the launch in
``flash_attention.launches``; on a CPU tensor it runs
:func:`flash_attention_plain`, the same tiled online-softmax in torch ops.
When a gradient is wanted (grad mode on and an input that requires grad)
the call goes through :class:`FlashAttentionFn`: its forward also keeps
each row's log-sum-exp, and its backward is :func:`flash_attention_bwd`,
the FA2 backward kernel of the same source on a CUDA tensor (counted in
``flash_attention_bwd.launches``) and :func:`flash_attention_bwd_plain`
on a CPU tensor.  There is no fallback between kernel and plain version:
a CUDA tensor either launches the kernel or raises.

Layout is the model's: q (B, Sq, H, hd), k and v (B, Sk, KVH, hd) with H a
multiple of KVH (grouped-query attention reads KV head ``h // (H // KVH)``;
the reference's ``flash_attention`` takes the heads already repeated,
which is the case KVH == H).

Replaces the TPU Pallas kernel ``_fa_kernel`` / ``flash_attention_fwd`` in
``src/repro/kernels/flash_attention/kernel.py``.  The function is bound by
operations on an H100, so the kernel runs both products on the tensor
cores with warp-level ``mma.sync``: one bf16 m16n8k16 product in bf16, and
in fp32 three TF32 m16n8k8 products per product (each operand split into
a TF32 ``big`` and a TF32 ``small`` remainder), which keeps fp32's 2e-5
tolerance where one TF32 product misses it.  The note at the top of
``flash_attention.cu`` gives the tiling and the fragment orders.
``torch.backends.cuda.matmul.allow_tf32`` plays no part: the split is the
kernel's own.  The reference has no backward kernel (it differentiates
its chunked attention with JAX); the backward here is FA2 on the same
``mma.sync`` routes (a dk/dv pass and a dq pass, no atomics), see the note
above it in the source.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._build import TOLERANCE_FLAGS, load_library

SOURCE = Path(__file__).with_name("flash_attention.cu")
FLAGS = TOLERANCE_FLAGS
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30
PLAIN_BLOCK_K = 256     # key tile of the plain version


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtypes=tuple(DTYPES)) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q (B, Sq, H, hd) and k, v "
                         f"(B, Sk, KVH, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[1] < 1 or sq < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{list(dtypes)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KVH, hd) -> (B, Sq, H, hd) in q's dtype.

    A CUDA tensor launches the kernel (counted in
    ``flash_attention.launches``); a CPU tensor runs
    :func:`flash_attention_plain`.  With grad mode on and an input that
    requires grad, the call is differentiable through
    :class:`FlashAttentionFn`.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]


flash_attention.launches = 0


def _forward(q, k, v, causal: bool, with_lse: bool):
    """(out, lse or None): the kernel on a CUDA tensor, the plain version
    on a CPU tensor.  lse is (B, H, Sq) fp32, each row's log-sum-exp."""
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid")
    lib = _library()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, sk, h, kvh, hd,
            DTYPES[q.dtype], 1.0 / math.sqrt(hd), int(causal), stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention with a gradient: the forward keeps (q, k, v, out,
    lse); the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal: bool = True):
    """(dq, dk, dv) of flash_attention, in q's dtype, from the forward's
    output `o` and log-sum-exp `lse` (B, H, Sq) fp32 and the output's
    gradient `dout` (q's shape).  A CUDA tensor launches the backward
    kernel (counted in ``flash_attention_bwd.launches``); a CPU tensor
    runs :func:`flash_attention_bwd_plain`."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    if o.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError(f"flash_attention_bwd: o and dout must be "
                         f"{tuple(q.shape)} and lse {(b, h, sq)}; got "
                         f"{tuple(o.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if o.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: o and dout must be {q.dtype} "
                        f"and lse float32; got {o.dtype}, {dout.dtype}, "
                        f"{lse.dtype}")
    if not (o.is_contiguous() and dout.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: o, dout, lse must be "
                         "contiguous")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, dout, lse,
                                         causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    sk, kvh = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"flash_attention_bwd: B*H = {b * h} exceeds the "
                         f"grid")
    lib = _library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kvh, hd,
            DTYPES[q.dtype], 1.0 / math.sqrt(hd), int(causal), stream)
    if err:
        raise RuntimeError("flash_attention backward launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE, FLAGS)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
            ctypes.c_float, i, p]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = i
        lib.flash_attention_bwd_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_bwd_smem_bytes.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel at (hd, dtype), as
    the built library states it (builds the library if needed)."""
    return int(_library().flash_attention_smem_bytes(hd, DTYPES[dtype]))


def bwd_smem_bytes(hd: int, dtype: torch.dtype) -> dict:
    """Dynamic shared memory of one block of each backward pass at (hd,
    dtype), {"dkdv": bytes, "dq": bytes}, as the built library states it
    (builds the library if needed)."""
    lib = _library()
    return {name: int(lib.flash_attention_bwd_smem_bytes(hd, DTYPES[dtype],
                                                         which))
            for which, name in enumerate(("dkdv", "dq"))}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's function in torch ops, on any device: fp32 scores and
    online softmax over key tiles of :data:`PLAIN_BLOCK_K`, all queries at
    once, NEG_INF masking and ``acc / max(l, 1e-30)``; output in q's dtype.
    """
    _check(q, k, v)
    return _plain_forward(q, k, v, causal)[0]


def _plain_forward(q, k, v, causal: bool):
    """(out, lse): :func:`flash_attention_plain` and each row's
    log-sum-exp m + log(l), (B, H, Sq) fp32."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, hd)
    kf = k.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    k_end = min(sk, sq) if causal else sk
    for k0 in range(0, k_end, PLAIN_BLOCK_K):
        kt = kf[:, :, k0:k0 + PLAIN_BLOCK_K]
        vt = vf[:, :, k0:k0 + PLAIN_BLOCK_K]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None]
            s = torch.where(kpos <= qpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vt)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    out = acc / den
    lse = (m + torch.log(den))[..., 0]
    return out.permute(0, 2, 1, 3).contiguous().to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, dout, lse, *, causal: bool = True):
    """The backward kernel's function in torch ops, on any device: the FA2
    backward over key tiles of :data:`PLAIN_BLOCK_K` with P recomputed
    from `lse`, D = rowsum(dout * o), dS = P (dP - D); dk and dv summed
    over each KV head's group.  Computes in float64 for float64 inputs,
    else in fp32; returns (dq, dk, dv) in q's dtype."""
    _check(q, k, v, dtypes=(*DTYPES, torch.float64))
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(ct).permute(0, 2, 1, 3)                        # (B, H, Sq, hd)
    kf = k.to(ct).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vf = v.to(ct).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    dof = dout.to(ct).permute(0, 2, 1, 3)
    lsef = lse.to(ct)[..., None]                            # (B, H, Sq, 1)
    delta = (dof * o.to(ct).permute(0, 2, 1, 3)).sum(-1, keepdim=True)
    qpos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    k_end = min(sk, sq) if causal else sk
    for k0 in range(0, k_end, PLAIN_BLOCK_K):
        kt = kf[:, :, k0:k0 + PLAIN_BLOCK_K]
        vt = vf[:, :, k0:k0 + PLAIN_BLOCK_K]
        p = torch.exp(torch.matmul(qf, kt.transpose(-1, -2)) * scale - lsef)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None]
            p = torch.where(kpos <= qpos, p, 0.0)
        dv[:, :, k0:k0 + PLAIN_BLOCK_K] = torch.matmul(p.transpose(-1, -2),
                                                       dof)
        ds = p * (torch.matmul(dof, vt.transpose(-1, -2)) - delta)
        dq += torch.matmul(ds, kt) * scale
        dk[:, :, k0:k0 + PLAIN_BLOCK_K] = torch.matmul(ds.transpose(-1, -2),
                                                       qf) * scale

    def heads_to_kv(x):                   # (B, H, Sk, hd) -> (B, Sk, KVH, hd)
        x = x.reshape(b, kvh, rep, sk, hd).sum(2)
        return x.permute(0, 2, 1, 3).contiguous().to(q.dtype)

    return (dq.permute(0, 2, 1, 3).contiguous().to(q.dtype), heads_to_kv(dk),
            heads_to_kv(dv))


def flash_attention_cost(b: int, sq: int, sk: int, h: int, kvh: int, hd: int,
                         causal: bool, itemsize: int):
    """(operations, bytes) the function needs: two multiply-adds per head
    dim for each (query, key) pair it keeps (q.k and p.v; causal keeps the
    pairs with key <= query), and q, k, v read once and o written once."""
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    ops = 4 * b * h * hd * pairs
    nbytes = (2 * b * sq * h * hd + 2 * b * sk * kvh * hd) * itemsize
    return ops, nbytes


def flash_attention_bwd_cost(b: int, sq: int, sk: int, h: int, kvh: int,
                             hd: int, causal: bool, itemsize: int):
    """(operations, bytes) the backward needs: five products (q.k, dO.v
    and the three gradients: P^T dO, dS K, dS^T Q) of two operations per
    head dim for each (query, key) pair kept; q, k, v, o, dO and lse read
    once, dq, dk, dv written once."""
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    ops = 10 * b * h * hd * pairs
    q_like = b * sq * h * hd              # q, o, dO, dq
    kv_like = b * sk * kvh * hd           # k, v, dk, dv
    nbytes = (4 * q_like + 4 * kv_like) * itemsize + 4 * b * h * sq
    return ops, nbytes
