"""Kernels written by hand for Hopper (sm_90a), one package each.

Each kernel package has:
  <name>.cu — the CUDA C++ source, with a plain C launch function; built by
              nvcc into a shared library at first use (``_build.py``)
  ops.py    — the wrapper (checks, allocation, launch on the current stream,
              a launch counter) and the plain PyTorch version of the same
              function, which the wrapper runs for CPU tensors

Kernels:
  ppa_eval — batched design-point PPA evaluation (the DSE substrate's hot
             loop; replaces the Pallas ``ppa_eval`` TPU kernel)
"""
