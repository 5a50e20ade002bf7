"""``flash_attention``: attention forward with online softmax, CUDA kernel
+ plain version.

:func:`flash_attention` is the wrapper the model's attention layer calls
for long causal self-attention.  On a CUDA tensor it launches the
hand-written kernel in ``flash_attention.cu`` (built with nvcc at first
use) on the current stream and counts the launch in
``flash_attention.launches``; on a CPU tensor it runs
:func:`flash_attention_plain`, the same tiled online-softmax in torch ops.
There is no fallback between the two: a CUDA tensor either launches the
kernel or raises.

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
kernel's own.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import TOLERANCE_FLAGS, load_library

SOURCE = Path(__file__).with_name("flash_attention.cu")
FLAGS = TOLERANCE_FLAGS
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30
PLAIN_BLOCK_K = 256     # key tile of the plain version


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{list(DTYPES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KVH, hd) -> (B, Sq, H, hd) in q's dtype.

    A CUDA tensor launches the kernel (counted in
    ``flash_attention.launches``); a CPU tensor runs
    :func:`flash_attention_plain`.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
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
    with torch.cuda.device(q.device):     # the launch uses the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, kvh, hd, DTYPES[q.dtype], 1.0 / math.sqrt(hd),
            int(causal), stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE, FLAGS)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel at (hd, dtype), as
    the built library states it (builds the library if needed)."""
    return int(_library().flash_attention_smem_bytes(hd, DTYPES[dtype]))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's function in torch ops, on any device: fp32 scores and
    online softmax over key tiles of :data:`PLAIN_BLOCK_K`, all queries at
    once, NEG_INF masking and ``acc / max(l, 1e-30)``; output in q's dtype.
    """
    _check(q, k, v)
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
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).contiguous().to(q.dtype)


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
