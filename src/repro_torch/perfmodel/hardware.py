"""Design point -> derived hardware spec (throughputs, bandwidths, area).

Calibrated against the NVIDIA A100 reference of Table 4:

* tensor FP16 throughput:  cores * sublanes * sa_dim^2 MACs * 2 FLOP * clock
  A100 (108, 4, 16x16, 1.41 GHz) -> 311.9 TFLOP/s  (spec: 312 TFLOP/s)
* HBM bandwidth:           channels * 311 GB/s -> 1555 GB/s for 5 channels
* interconnect:            links * 25 GB/s/dir -> 300 GB/s/dir for 12 links
* die area model sums component areas, calibrated to ~826 mm^2 for A100.

Every function takes dicts of fp32 tensors (the output of
``DesignSpace.decode``) of any common broadcast shape.  The arithmetic order
is part of the contract: the CUDA ``ppa_eval`` kernel evaluates the same
expressions in the same order, so its results equal this module's bit for
bit (see ``kernels/ppa_eval/ppa_eval.cu``).
"""
from __future__ import annotations

from typing import Dict

import torch

# ----------------------------------------------------------------- constants
CLOCK_HZ = 1.41e9              # core clock
BW_PER_CHANNEL = 311.0e9       # bytes/s per HBM channel (A100: 5ch -> 1555 GB/s)
BW_PER_LINK = 25.0e9           # bytes/s per interconnect link, unidirectional
LINK_LATENCY_S = 1.0e-6        # per-hop collective latency

# Area model (mm^2), calibrated against Table 4 (A100 ~824 mm^2, Design A at
# 0.772x, Design B at 0.96x).
AREA_BASE = 140.0              # misc: command processors, PCIe, video, pads
AREA_PER_MAC = 1.826e-4        # fp16 MAC in the systolic array
AREA_PER_VLANE = 0.008         # fp32-capable vector lane
AREA_PER_SRAM_KB = 0.0081      # per-core SRAM
AREA_CORE_BASE = 2.924         # per-core control/dispatch/regfile overhead
AREA_PER_GBUF_MB = 0.72        # global buffer SRAM macro
AREA_PER_CHANNEL = 15.0        # HBM PHY + controller per channel
AREA_PER_LINK = 1.8            # interconnect SerDes per link

BYTES_FP16 = 2


def derive_hardware(v: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Map decoded design values -> derived spec. Batched over leading dims."""
    cores = v["core_count"]
    sub = v["sublane_count"]
    sa = v["sa_dim"]
    vw = v["vector_width"]

    tensor_flops = cores * sub * sa * sa * 2.0 * CLOCK_HZ     # FLOP/s, fp16
    vector_flops = cores * sub * vw * 2.0 * CLOCK_HZ          # FLOP/s
    mem_bw = v["mem_channels"] * BW_PER_CHANNEL               # bytes/s
    ici_bw = v["link_count"] * BW_PER_LINK                    # bytes/s/dir

    return {
        "tensor_flops": tensor_flops,
        "vector_flops": vector_flops,
        "mem_bw": mem_bw,
        "ici_bw": ici_bw,
        "sram_kb": v["sram_kb"],
        "gbuf_bytes": v["gbuf_mb"] * 2.0**20,
        "sa_dim": sa,
        "sublane_count": sub,
        "core_count": cores,
        "vector_width": vw,
        "area_mm2": area_mm2(v),
    }


def area_mm2(v: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Analytical die-area model (the 'area model source code' the
    Perf/Area-prediction benchmark hands to the LLM)."""
    macs_per_core = v["sublane_count"] * v["sa_dim"] * v["sa_dim"]
    vlanes_per_core = v["sublane_count"] * v["vector_width"]
    core_area = (
        AREA_CORE_BASE
        + AREA_PER_MAC * macs_per_core
        + AREA_PER_VLANE * vlanes_per_core
        + AREA_PER_SRAM_KB * v["sram_kb"]
    )
    return (
        AREA_BASE
        + v["core_count"] * core_area
        + AREA_PER_GBUF_MB * v["gbuf_mb"]
        + AREA_PER_CHANNEL * v["mem_channels"]
        + AREA_PER_LINK * v["link_count"]
    )


# Source string handed to the perf/area-prediction benchmark task (the paper
# gives the LLM "the source code of the area model").
AREA_MODEL_SOURCE = r"""
def area_mm2(design):
    macs_per_core  = design.sublane_count * design.sa_dim ** 2
    vlanes_per_core = design.sublane_count * design.vector_width
    core = 2.924 + 1.826e-4 * macs_per_core + 0.008 * vlanes_per_core \
           + 0.0081 * design.sram_kb
    return 140.0 + design.core_count * core + 0.72 * design.gbuf_mb \
           + 15.0 * design.mem_channels + 1.8 * design.link_count
"""
