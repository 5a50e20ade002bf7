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
  flash_attention — attention forward with online softmax (the LM stack's
                    long causal self-attention; replaces the Pallas
                    ``flash_attention`` TPU kernel)
  ssm_scan        — the Mamba selective scan from a zero state (the
                    Mamba block in a forward pass; replaces the Pallas
                    ``ssm_scan`` TPU kernel)
  rwkv6_scan      — the RWKV6 WKV recurrence from a zero state (the RWKV
                    time-mix in a forward pass; replaces the Pallas
                    ``rwkv6_scan`` TPU kernel)
"""
