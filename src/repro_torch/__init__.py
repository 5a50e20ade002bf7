"""PyTorch/CUDA port of the LUMINA reproduction (the ``repro`` package).

The JAX package :mod:`repro` is the reference; this package mirrors its
module layout (``repro_torch.perfmodel.roofline`` is the counterpart of
``repro.perfmodel.roofline``) and imports ``torch`` and numpy only — never
``jax`` and nothing under ``repro.``.

Ported so far (the DSE main path):

* :mod:`repro_torch.perfmodel` — design space, derived hardware, workloads,
  roofline/compass op terms, stall attribution, the fused
  :class:`~repro_torch.perfmodel.evaluator.ModelEvaluator` and the
  single-process full-space :class:`~repro_torch.perfmodel.sweep.SweepEngine`;
* :mod:`repro_torch.kernels.ppa_eval` — the batched design-point PPA kernel,
  hand-written in CUDA C++ for Hopper (``sm_90a``);
* :mod:`repro_torch.core` — the LUMINA DSE loop (numpy).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of falling back.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
