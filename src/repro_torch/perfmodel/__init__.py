"""Analytical accelerator PPA models behind ONE service boundary, in torch.

* :mod:`~repro_torch.perfmodel.designspace` — the 4.7M-point design space;
* :mod:`~repro_torch.perfmodel.hardware`    — design point -> derived
  hardware spec (throughputs, bandwidths, area);
* :mod:`~repro_torch.perfmodel.workload`    — operator graphs (numpy);
* :mod:`~repro_torch.perfmodel.roofline` / :mod:`~repro_torch.perfmodel.
  compass` — the op-term models of the proxy and target tiers;
* :mod:`~repro_torch.perfmodel.critical_path` — stall attribution reports;
* :mod:`~repro_torch.perfmodel.evaluator`   — the tiered Evaluator API
  (``get_evaluator``) with the ``roofline | compass | cuda`` backends;
* :mod:`~repro_torch.perfmodel.sweep`       — the streaming full-space
  sweep engine (the oracle tier's substrate).
"""

from repro_torch.perfmodel.designspace import DesignSpace, A100_REFERENCE
from repro_torch.perfmodel.hardware import derive_hardware, area_mm2
from repro_torch.perfmodel.workload import (Workload, Op, WorkloadStack,
                                            Scenario, gpt3_layer_prefill,
                                            gpt3_layer_decode, from_arch,
                                            paper_suite, zoo_suite,
                                            workload_from_arrays)
from repro_torch.perfmodel.roofline import (RooflineModel,
                                            stacked_workload_batches)
from repro_torch.perfmodel.compass import CompassModel
from repro_torch.perfmodel.critical_path import (attribute_stalls,
                                                 STALL_CLASSES)
from repro_torch.perfmodel.evaluator import (Evaluator, EvalRequest,
                                             PPAReport, ModelEvaluator,
                                             OracleEvaluator, RowCache,
                                             get_evaluator, make_evaluator,
                                             as_evaluator, pair_view,
                                             register_backend, backend_names,
                                             TIERS, DETAILS, SUITES)
from repro_torch.perfmodel.sweep import SweepEngine, SweepResult

__all__ = [
    "DesignSpace", "A100_REFERENCE", "derive_hardware", "area_mm2",
    "Workload", "Op", "WorkloadStack", "Scenario",
    "gpt3_layer_prefill", "gpt3_layer_decode", "from_arch", "paper_suite",
    "zoo_suite", "workload_from_arrays",
    "RooflineModel", "CompassModel", "stacked_workload_batches",
    "attribute_stalls", "STALL_CLASSES",
    "Evaluator", "EvalRequest", "PPAReport", "ModelEvaluator",
    "OracleEvaluator", "RowCache", "get_evaluator", "make_evaluator",
    "as_evaluator", "pair_view", "register_backend", "backend_names",
    "TIERS", "DETAILS", "SUITES",
    "SweepEngine", "SweepResult",
]
