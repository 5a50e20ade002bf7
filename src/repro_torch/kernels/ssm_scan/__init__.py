"""Mamba selective scan from a zero state and its gradient (CUDA kernels +
plain torch versions)."""
from repro_torch.kernels.ssm_scan.ops import (SsmScanFn, ssm_scan,
                                              ssm_scan_bwd, ssm_scan_bwd_cost,
                                              ssm_scan_bwd_plain,
                                              ssm_scan_cost, ssm_scan_counted,
                                              ssm_scan_plain)

__all__ = ["SsmScanFn", "ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_cost",
           "ssm_scan_bwd_plain", "ssm_scan_cost", "ssm_scan_counted",
           "ssm_scan_plain"]
