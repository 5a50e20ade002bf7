// An empty kernel, for timing what a launch costs when it does nothing.
//
// ppa_eval's timings (bench.py, chip_smoke.py phase 6) set beside each
// kernel time this kernel's time at the same grid and block size, launched
// the same way (ctypes, the current stream): the part of a launch that no
// design of the kernel can remove.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launches `blocks` blocks of `threads` threads of a kernel that does
// nothing on `stream`; returns the cudaError_t of the launch.
int launch_floor(long long blocks, int threads, void* stream) {
  if (blocks <= 0) return 0;
  empty_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
