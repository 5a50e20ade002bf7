"""PyTorch/CUDA port of the LUMINA reproduction (the ``repro`` package).

The JAX package :mod:`repro` is the reference; this package mirrors its
module layout (``repro_torch.perfmodel.roofline`` is the counterpart of
``repro.perfmodel.roofline``) and imports ``torch`` and numpy only — never
``jax`` and nothing under ``repro.``.

Ported so far:

* :mod:`repro_torch.perfmodel` — design space, derived hardware, workloads,
  roofline/compass op terms, stall attribution, the fused
  :class:`~repro_torch.perfmodel.evaluator.ModelEvaluator` and the
  single-process full-space :class:`~repro_torch.perfmodel.sweep.SweepEngine`;
* :mod:`repro_torch.kernels.ppa_eval` — the batched design-point PPA kernel,
  hand-written in CUDA C++ for Hopper (``sm_90a``);
* :mod:`repro_torch.core` — the LUMINA DSE loop, the sweep-seeded
  multi-campaign runner, the five black-box baselines and the DSE
  Benchmark (numpy on the host; the evaluations are device work);
* :mod:`repro_torch.obs` — the metrics registry and tracer;
* :mod:`repro_torch.analysis` — the influence graph extracted from the
  port's perfmodel source, and the invariant linter;
* :mod:`repro_torch.configs`, :mod:`repro_torch.models`,
  :mod:`repro_torch.launch` — the LM serving path, with the
  ``flash_attention``, ``rwkv6_scan`` and ``ssm_scan`` CUDA kernels.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of falling back.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
