"""Mamba selective scan from a zero state (CUDA kernel + plain torch
version)."""
from repro_torch.kernels.ssm_scan.ops import (ssm_scan, ssm_scan_cost,
                                              ssm_scan_plain)

__all__ = ["ssm_scan", "ssm_scan_cost", "ssm_scan_plain"]
