"""Kernels written by hand for Hopper (sm_90a), one package each.

Each kernel package has:
  <name>.cu — the CUDA C++ source, with a plain C launch function; built by
              nvcc into a shared library at first use (``_build.py``)
  ops.py    — the wrapper (checks, allocation, launch on the current stream,
              a launch counter) and the plain PyTorch version of the same
              function, which the wrapper runs for CPU tensors

Kernels:
  ppa_eval        — batched design-point PPA evaluation (the DSE
                    substrate's hot loop; replaces the Pallas ``ppa_eval``
                    TPU kernel)
  flash_attention — attention with online softmax, forward and backward
                    (the LM stack's long causal self-attention; replaces
                    the Pallas ``flash_attention`` TPU kernel)
  ssm_scan        — the Mamba selective scan from a zero state, forward
                    and backward (the Mamba block; replaces the Pallas
                    ``ssm_scan`` TPU kernel)
  rwkv6_scan      — the RWKV6 WKV recurrence from a zero state, forward
                    and backward (the RWKV time-mix; replaces the Pallas
                    ``rwkv6_scan`` TPU kernel)
  pareto_reduce   — the exact Pareto entrants of a sweep chunk's filter
                    survivors against the host archive (replaces no TPU
                    kernel: the JAX package screens them on the host)

As in the reference's ``repro.kernels``, the package re-exports the four
wrappers, so ``repro_torch.kernels.flash_attention`` is the function; the
subpackages stay importable by their full names (``from
repro_torch.kernels.flash_attention import ops``).  Nothing is built at
import.
"""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ppa_eval.ops import ppa_eval

__all__ = ["flash_attention", "rwkv6_scan", "ssm_scan", "ppa_eval"]
