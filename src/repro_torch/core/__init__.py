"""Lumina core: LLM-guided DSE framework (the paper's primary contribution).

Components (paper Figure 2):
  QualE  — :mod:`repro_torch.core.quale`   influence-map acquisition
  QuanE  — :mod:`repro_torch.core.quane`   sensitivity quantification
  SE     — :mod:`repro_torch.core.strategy` bottleneck-mitigation strategy
  EE     — :mod:`repro_torch.core.explore`  simulator integration layer
  TM     — :mod:`repro_torch.core.memory`   trajectory memory + reflection
  Refine — :mod:`repro_torch.core.refine`   AHK recalibration loop
  Loop   — :mod:`repro_torch.core.loop`     the orchestrated DSE campaign
                                            (stepwise :class:`~repro_torch.
                                            core.loop.Campaign` + closed
                                            ``run``)
plus the multi-campaign orchestration layer (:mod:`repro_torch.core.
campaign` — sweep-seeded parallel campaigns sharing one budget, one merged
archive and ONE fused batched dispatch per round, with per-step regret
telemetry), the DSE Benchmark (:mod:`repro_torch.core.bench`), the LLM
backends (:mod:`repro_torch.core.llm`), Pareto/PHV metrics
(:mod:`repro_torch.core.pareto`) and the black-box baselines
(:mod:`repro_torch.core.baselines`).  All numpy: the device work happens
behind the evaluator.
"""

from repro_torch.core.loop import LuminaDSE, DSEResult, Campaign
from repro_torch.core.campaign import (CampaignRunner, CampaignSetResult,
                                       StepRecord)
from repro_torch.core.llm import RuleOracle, DegradedOracle, MCQuery
from repro_torch.core.pareto import (hypervolume, pareto_front, pareto_mask,
                                     sample_efficiency, dominates_ref,
                                     ParetoArchive)

__all__ = ["LuminaDSE", "DSEResult", "Campaign", "CampaignRunner",
           "CampaignSetResult", "StepRecord", "RuleOracle",
           "DegradedOracle", "MCQuery", "hypervolume", "pareto_front",
           "pareto_mask", "sample_efficiency", "dominates_ref",
           "ParetoArchive"]
