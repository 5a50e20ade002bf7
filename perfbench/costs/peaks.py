"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit)."""

TF32_FLOPS = 495e12        # fp32 inputs on the tensor cores: the fastest
                           # rate at which any route can multiply fp32
BF16_FLOPS = 989e12
FP32_SIMT_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# the peak against which a step's fp32 model FLOPs (mfu) are read
FP32_MODEL_PEAK = TF32_FLOPS


def bound_s(flops: float, nbytes: float, peak_flops: float = TF32_FLOPS
            ) -> float:
    """The least time the chip could take: the larger of the operations at
    the peak rate and the bytes at the HBM rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
