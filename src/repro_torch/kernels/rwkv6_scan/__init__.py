"""RWKV6 WKV recurrence from a zero state (CUDA kernel + plain torch
version)."""
from repro_torch.kernels.rwkv6_scan.ops import (rwkv6_scan, rwkv6_scan_cost,
                                                rwkv6_scan_plain)

__all__ = ["rwkv6_scan", "rwkv6_scan_cost", "rwkv6_scan_plain"]
