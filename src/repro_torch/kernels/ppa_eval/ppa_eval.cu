// Batched design-point PPA evaluation on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_ppa_kernel` / `ppa_eval_fwd` in
// src/repro/kernels/ppa_eval/kernel.py.  For each design (one row of
// decoded parameter values, PARAM_NAMES order) and one workload's op table
// it computes, per op, the six-factor matmul utilization, the
// global-buffer-blocked HBM bytes and the compute, memory, all-reduce and
// p2p times; t_op = max(...) * count is summed into the latency and, by the
// dominant-class tie rules, into one of four stall sums.  It also computes
// the design's die area.  Output row: [latency, s0, s1, s2, s3, area, 0, 0].
//
// Arithmetic contract: every expression below is the one the port's torch
// path evaluates (repro_torch/perfmodel/hardware.py and roofline.py), in
// the same order, in fp32, and the ops are added left to right in op order
// as roofline._seq_sum does.  Built with -fmad=false (no a*b+c contraction
// that the torch ops do not do) and without fast math (IEEE '/', sqrtf,
// ceilf), the kernel's results equal the torch path's bit for bit, so a
// sweep through this kernel and a sweep through the torch ops find the same
// front.  Constants are double literals cast to float, the rounding torch
// and JAX apply to a Python float multiplied into an fp32 tensor.
//
// What bounds it on an H100: per design and workload it moves 64 bytes
// (a 32-byte design row in, a 32-byte result row out) and does ~330-360
// fp32 operations for the 13-op GPT-3 tables (ppa_eval_op_count in ops.py
// counts the operations written below, one IEEE operation each).  So
// counted, bytes bound it: 64 B at 3.35 TB/s takes longer than ~360 ops at
// 67 TFLOP/s.  That bound is not what limits it in practice: each IEEE
// division is a multi-instruction sequence (reciprocal, Newton steps, a
// range check), and a matmul op has eleven of them, so the issued
// instruction stream, not memory traffic, is the likelier cause of the
// measured gap above the byte bound.  The design keeps everything that is
// not a design row or a result row on chip: the op table (<= a few hundred
// rows x 32 bytes) is staged once per block into shared memory and read
// there by every thread (a broadcast: all threads read the same op), the
// per-design terms that do not depend on the op (throughputs, sqrt of the
// global buffer, SRAM factors) are hoisted out of the op loop, the latency
// and the four stall sums live in registers, and each thread does one
// 32-byte load and one 32-byte store as two float4s, so a warp touches 1 KB
// contiguous.  The op kind is the same for every thread at a given loop
// step, so the per-kind branches do not diverge.  One thread per design;
// the ragged last block is masked, so any batch size is accepted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kCols = 8;

// op-table columns (ops.py: op_table)
constexpr int OP_KIND = 0, OP_FLOPS = 1, OP_BYTES = 2, OP_M = 3, OP_N = 4,
              OP_K = 5, OP_COMM = 6, OP_COUNT = 7;
// op kinds (perfmodel/workload.py)
constexpr int MATMUL = 0, VECTOR = 1, ALLREDUCE = 3, P2P = 4;

// perfmodel/hardware.py and roofline.py constants, rounded to fp32 from
// their double values
#define F32(x) static_cast<float>(x)
constexpr float kClockHz = F32(1.41e9);
constexpr float kBwPerChannel = F32(311.0e9);
constexpr float kBwPerLink = F32(25.0e9);
constexpr float kLinkLatency = F32(1.0e-6);
constexpr float kSramFeed = F32(0.625);
constexpr float kAreaBase = F32(140.0);
constexpr float kAreaPerMac = F32(1.826e-4);
constexpr float kAreaPerVlane = F32(0.008);
constexpr float kAreaPerSramKb = F32(0.0081);
constexpr float kAreaCoreBase = F32(2.924);
constexpr float kAreaPerGbufMb = F32(0.72);
constexpr float kAreaPerChannel = F32(15.0);
constexpr float kAreaPerLink = F32(1.8);

__device__ __forceinline__ float ceil_div(float a, float b) {
  return ceilf(a / b);
}

__global__ void __launch_bounds__(kBlock)
ppa_eval_kernel(const float4* __restrict__ dv, const float* __restrict__ ops,
                int n_ops, float tp, float4* __restrict__ out,
                int64_t batch) {
  extern __shared__ float s_ops[];
  for (int i = threadIdx.x; i < n_ops * kCols; i += blockDim.x) {
    s_ops[i] = ops[i];
  }
  __syncthreads();
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;

  const float4 lo = dv[2 * b];
  const float4 hi = dv[2 * b + 1];
  const float links = lo.x, cores = lo.y, sub = lo.z, sa = lo.w;
  const float vw = hi.x, sram = hi.y, gbuf_mb = hi.z, chan = hi.w;

  // derive_hardware
  const float tensor = cores * sub * sa * sa * 2.0f * kClockHz;
  const float vector = cores * sub * vw * 2.0f * kClockHz;
  const float mem_bw = chan * kBwPerChannel;
  const float ici_bw = links * kBwPerLink;
  const float gbuf_bytes = gbuf_mb * 1048576.0f;  // * 2.0**20
  // op-independent factors of matmul_hbm_bytes / matmul_utilization
  const float sqrt_f = sqrtf(fmaxf(gbuf_bytes / 2.0f, 1.0f));
  const float sram_need = 6.0f * sa * sa * 2.0f / 1024.0f;
  const float u_sram = fminf(sram / sram_need, 1.0f);
  const float u_feed = fminf(kSramFeed * sram / (sa * sub), 1.0f);
  const float par = cores * sub;

  float lat = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int j = 0; j < n_ops; ++j) {
    const float* op = s_ops + j * kCols;
    const int kind = static_cast<int>(op[OP_KIND]);
    const float flops = op[OP_FLOPS], m = op[OP_M], n = op[OP_N], k = op[OP_K];
    const float comm = op[OP_COMM], count = op[OP_COUNT];
    float bytes_eff = op[OP_BYTES];
    float t_c = 0.0f, t_x = 0.0f;
    if (kind == MATMUL) {
      const float u_k = k / (ceil_div(k, sa) * sa);
      const float u_n = n / (ceil_div(n, sa) * sa);
      const float u_pipe = m / (m + sa);
      const float n_tiles = ceil_div(m, sa) * ceil_div(n, sa);
      const float u_par = fminf(n_tiles / par, 1.0f);
      const float util = u_k * u_n * u_pipe * u_par * u_sram * u_feed;
      const float bound = 2.0f * m * n * k / sqrt_f * 2.0f;
      bytes_eff = fmaxf(bytes_eff, bound);
      t_c = flops / (tensor * util);
    } else if (kind == VECTOR) {
      t_c = flops / vector;
    } else if (kind == ALLREDUCE) {
      const float steps = 2.0f * (tp - 1.0f);
      t_x = steps / tp * comm / ici_bw + steps * kLinkLatency;
    } else if (kind == P2P) {
      t_x = (tp - 1.0f) / tp * comm / ici_bw + (tp - 1.0f) * kLinkLatency;
    }
    // memcpy: t_c = t_x = 0, so the memory term wins below
    const float t_m = bytes_eff / mem_bw;
    const float t_op = fmaxf(fmaxf(t_c, t_m), t_x) * count;
    const bool dom_comm = (t_x >= t_c) && (t_x >= t_m);
    const bool dom_compute = (t_c > t_m) && !dom_comm;
    lat += t_op;
    if (dom_comm) {
      s3 += t_op;
    } else if (dom_compute) {
      if (kind == MATMUL) s0 += t_op; else s1 += t_op;
    } else {
      s2 += t_op;
    }
  }

  // area_mm2
  const float macs = sub * sa * sa;
  const float vlanes = sub * vw;
  const float core_area = kAreaCoreBase + kAreaPerMac * macs
                          + kAreaPerVlane * vlanes + kAreaPerSramKb * sram;
  const float area = kAreaBase + cores * core_area + kAreaPerGbufMb * gbuf_mb
                     + kAreaPerChannel * chan + kAreaPerLink * links;

  out[2 * b] = make_float4(lat, s0, s1, s2);
  out[2 * b + 1] = make_float4(s3, area, 0.0f, 0.0f);
}

}  // namespace

extern "C" {

// Launches on `stream`, which must belong to the calling thread's current
// device (the caller selects it; this function leaves it unchanged), and
// returns the cudaError_t of the launch (0 on success).  dv: (batch, 8)
// fp32, 16-byte aligned; ops: (n_ops, 8) fp32; out: (batch, 8) fp32,
// 16-byte aligned.  Does not synchronise.
int ppa_eval_launch(const float* dv, const float* ops, int n_ops, float tp,
                    float* out, long long batch, void* stream) {
  if (batch <= 0) return 0;
  const long long grid = (batch + kBlock - 1) / kBlock;
  const size_t smem = static_cast<size_t>(n_ops) * kCols * sizeof(float);
  ppa_eval_kernel<<<static_cast<unsigned int>(grid), kBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(dv), ops, n_ops, tp,
      reinterpret_cast<float4*>(out), static_cast<int64_t>(batch));
  return static_cast<int>(cudaGetLastError());
}

const char* ppa_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
