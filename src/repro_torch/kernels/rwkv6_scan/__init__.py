"""RWKV6 WKV recurrence from a zero state and its gradient (CUDA kernels +
plain torch versions)."""
from repro_torch.kernels.rwkv6_scan.ops import (Rwkv6ScanFn, rwkv6_scan,
                                                rwkv6_scan_bwd,
                                                rwkv6_scan_bwd_cost,
                                                rwkv6_scan_bwd_plain,
                                                rwkv6_scan_cost,
                                                rwkv6_scan_counted,
                                                rwkv6_scan_plain)

__all__ = ["Rwkv6ScanFn", "rwkv6_scan", "rwkv6_scan_bwd",
           "rwkv6_scan_bwd_cost", "rwkv6_scan_bwd_plain", "rwkv6_scan_cost",
           "rwkv6_scan_counted", "rwkv6_scan_plain"]
