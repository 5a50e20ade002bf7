// Batched design-point PPA evaluation on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_ppa_kernel` / `ppa_eval_fwd` in
// src/repro/kernels/ppa_eval/kernel.py.  For each design (one row of
// decoded parameter values, PARAM_NAMES order) and each workload's op table
// it computes, per op, the six-factor matmul utilization, the
// global-buffer-blocked HBM bytes and the compute, memory, all-reduce and
// p2p times; t_op = max(...) * count is summed into the latency and, by the
// dominant-class tie rules, into one of four stall sums.  It also computes
// the design's die area.  It writes one row [latency, s0, s1, s2, s3, area,
// 0, 0] per (workload, design), the workloads' rows one block after
// another.  The reference calls ppa_eval_fwd once per workload on the same
// designs; one launch here takes all of a call's workloads, and each row
// equals the row a launch with that workload alone writes.
//
// Arithmetic contract: every expression below is the one the port's torch
// path evaluates (repro_torch/perfmodel/hardware.py and roofline.py), in
// the same order, in fp32, and the ops are added left to right in op order
// as roofline._seq_sum does.  Built with -fmad=false (no a*b+c contraction
// that the torch ops do not do) and without fast math (IEEE '/', sqrtf,
// ceilf), the kernel's results equal the torch path's bit for bit, so a
// sweep through this kernel and a sweep through the torch ops find the same
// front.  Constants are double literals cast to float, the rounding torch
// and JAX apply to a Python float multiplied into an fp32 tensor.  Where a
// term is computed (once per block, once per op or once per design) does
// not change how: the same operands, the same operations, the same order.
//
// What bounds it on an H100: per design it reads one 32-byte row and writes
// one 32-byte row per workload (96 B for the GPT-3 pair), and the function
// counts ~330-360 fp32 operations per workload (ppa_eval_op_count in ops.py
// counts the operations written below, one IEEE operation each), so bytes
// bound it.  What limits it in practice is the divisions: each IEEE
// division is a multi-instruction sequence (reciprocal, Newton steps, a
// range check) that ends its basic block with the branch to its slow path,
// so a thread's divisions run one after another, and a matmul op has
// eleven of them.  The design cuts the divisions a design pays for:
//  - One launch for all workloads.  A thread reads its design row once,
//    derives the per-design terms (throughputs, sqrt of the global buffer,
//    SRAM factors) and the area once, then walks each workload's op table
//    in turn, keeping the latency and the four stall sums in registers, and
//    writes that workload's row (two float4s; a warp stores 1 KB
//    contiguous) when its table ends.
//  - Per-(op, sa_dim) terms once per block.  Six of a matmul op's eleven
//    divisions (k/sa, k/(ceil(k/sa) sa), n/sa, n/(ceil(n/sa) sa), m/(m+sa),
//    m/sa) depend only on the op and sa_dim, which takes six values in the
//    design space.  The block finds its designs' distinct sa values (a warp
//    match, then a shared set of kMaxSa slots), computes u_k * u_n * u_pipe
//    and the tile count for each (op, slot) in parallel, and every thread
//    looks its own up.  A design whose sa found no free slot (a block of
//    off-grid rows) computes the same two terms itself.  Designs in any
//    order work: a block of randomly sampled ids holds at most six values.
//  - Per-op terms once per block.  The op tables are staged into shared
//    memory (every thread reads the same op: a broadcast) with the terms
//    that depend only on the op and its workload's tp already formed:
//    2 m n k, and the all-reduce / p2p bytes numerator and latency term.
//  The op kind is the same for every thread at a given loop step, so the
//  per-kind branches do not diverge.  The ragged last block is masked, so
//  any batch size is accepted.  Measured on an H100 (bench.py; PERF.md):
//  two designs a thread, 128 threads a block and reading each op one op
//  ahead were slower at the sweep's chunk; 512 threads a block was 3%
//  faster there and 14% slower at 4,096 designs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads per block, a design each
constexpr int kCols = 8;                // op-table and design-row columns
constexpr int kMaxSa = 8;               // distinct sa_dim values a block holds
constexpr int kMaxWorkloads = 64;       // workloads one launch takes
constexpr unsigned long long kNoKey = ~0ull;   // an empty sa slot

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

// The workloads of one launch: their op tables lie one after another in
// `ops`; workload w owns rows [end[w-1], end[w]) (end[-1] = 0).
struct Workloads {
  int n;
  int end[kMaxWorkloads];
  float tp[kMaxWorkloads];
};

// An op as the op loop reads it from shared memory.
//   lo: kind (int bits), flops, bytes, count
//   hi: matmul: m, n, k, 2 m n k; all-reduce and p2p: the numerator of the
//       bytes term and the latency term of t_x; otherwise unused
struct StagedOp {
  float4 lo, hi;
};

// The terms a design's op loop needs that do not depend on the op.
struct Design {
  float sa, tensor, vector, mem_bw, ici_bw, sqrt_f, u_sram, u_feed, par,
      area;
};

__device__ __forceinline__ float ceil_div(float a, float b) {
  return ceilf(a / b);
}

__device__ StagedOp stage_op(const float* op, float tp) {
  const int kind = static_cast<int>(op[OP_KIND]);
  const float m = op[OP_M], n = op[OP_N], k = op[OP_K];
  const float comm = op[OP_COMM];
  StagedOp s;
  s.lo = make_float4(__int_as_float(kind), op[OP_FLOPS], op[OP_BYTES],
                     op[OP_COUNT]);
  s.hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kind == MATMUL) {
    s.hi = make_float4(m, n, k, 2.0f * m * n * k);
  } else if (kind == ALLREDUCE) {
    // t_x = steps / tp * comm / ici_bw + steps * kLinkLatency
    const float steps = 2.0f * (tp - 1.0f);
    s.hi.x = steps / tp * comm;
    s.hi.y = steps * kLinkLatency;
  } else if (kind == P2P) {
    // t_x = (tp - 1) / tp * comm / ici_bw + (tp - 1) * kLinkLatency
    s.hi.x = (tp - 1.0f) / tp * comm;
    s.hi.y = (tp - 1.0f) * kLinkLatency;
  }
  return s;
}

// A matmul op's terms that depend only on the op and sa: u_k * u_n *
// u_pipe (the first three factors of the utilization, multiplied in its
// order) and the tile count.
__device__ __forceinline__ float2 sa_terms(float m, float n, float k,
                                           float sa) {
  const float u_k = k / (ceil_div(k, sa) * sa);
  const float u_n = n / (ceil_div(n, sa) * sa);
  const float u_pipe = m / (m + sa);
  const float n_tiles = ceil_div(m, sa) * ceil_div(n, sa);
  return make_float2(u_k * u_n * u_pipe, n_tiles);
}

// Matmul op j's sa_terms for a design: the block's entry for its slot, or,
// for a design without one, computed here.
__device__ __forceinline__ float2 lookup_sa_terms(const float2* s_tab, int j,
                                                  int slot, float4 op_hi,
                                                  float sa) {
  if (slot >= 0) return s_tab[j * kMaxSa + slot];
  return sa_terms(op_hi.x, op_hi.y, op_hi.z, sa);
}

__device__ __forceinline__ Design derive(float4 lo, float4 hi) {
  const float links = lo.x, cores = lo.y, sub = lo.z, sa = lo.w;
  const float vw = hi.x, sram = hi.y, gbuf_mb = hi.z, chan = hi.w;
  Design d;
  d.sa = sa;
  // derive_hardware
  d.tensor = cores * sub * sa * sa * 2.0f * kClockHz;
  d.vector = cores * sub * vw * 2.0f * kClockHz;
  d.mem_bw = chan * kBwPerChannel;
  d.ici_bw = links * kBwPerLink;
  const float gbuf_bytes = gbuf_mb * 1048576.0f;  // * 2.0**20
  // op-independent factors of matmul_hbm_bytes / matmul_utilization
  d.sqrt_f = sqrtf(fmaxf(gbuf_bytes / 2.0f, 1.0f));
  const float sram_need = 6.0f * sa * sa * 2.0f / 1024.0f;
  d.u_sram = fminf(sram / sram_need, 1.0f);
  d.u_feed = fminf(kSramFeed * sram / (sa * sub), 1.0f);
  d.par = cores * sub;
  // area_mm2
  const float macs = sub * sa * sa;
  const float vlanes = sub * vw;
  const float core_area = kAreaCoreBase + kAreaPerMac * macs
                          + kAreaPerVlane * vlanes + kAreaPerSramKb * sram;
  d.area = kAreaBase + cores * core_area + kAreaPerGbufMb * gbuf_mb
           + kAreaPerChannel * chan + kAreaPerLink * links;
  return d;
}

// A design's latency and four stall sums over one workload's ops so far.
struct Sums {
  float lat, s0, s1, s2, s3;
};

// Adds op j (kind, lo, hi as staged) to a design's sums.
__device__ __forceinline__ void add_op(Sums& acc, const Design& d, int slot,
                                       int j, int kind, float4 olo,
                                       float4 ohi, const float2* s_tab) {
  const float flops = olo.y, count = olo.w;
  float bytes_eff = olo.z;
  float t_c = 0.0f, t_x = 0.0f;
  if (kind == MATMUL) {
    const float2 e = lookup_sa_terms(s_tab, j, slot, ohi, d.sa);
    const float u_par = fminf(e.y / d.par, 1.0f);
    const float util = e.x * u_par * d.u_sram * d.u_feed;
    const float bound = ohi.w / d.sqrt_f * 2.0f;
    bytes_eff = fmaxf(bytes_eff, bound);
    t_c = flops / (d.tensor * util);
  } else if (kind == VECTOR) {
    t_c = flops / d.vector;
  } else if (kind == ALLREDUCE || kind == P2P) {
    t_x = ohi.x / d.ici_bw + ohi.y;
  }
  // memcpy: t_c = t_x = 0, so the memory term wins below
  const float t_m = bytes_eff / d.mem_bw;
  const float t_op = fmaxf(fmaxf(t_c, t_m), t_x) * count;
  const bool dom_comm = (t_x >= t_c) && (t_x >= t_m);
  const bool dom_compute = (t_c > t_m) && !dom_comm;
  acc.lat += t_op;
  if (dom_comm) {
    acc.s3 += t_op;
  } else if (dom_compute) {
    if (kind == MATMUL) acc.s0 += t_op; else acc.s1 += t_op;
  } else {
    acc.s2 += t_op;
  }
}

// Claims a slot of `keys` for `key` (or finds the slot holding it); leaves
// the set unchanged when every slot holds another key.
__device__ __forceinline__ void insert_key(unsigned long long* keys,
                                           unsigned long long key) {
  for (int s = 0; s < kMaxSa; ++s) {
    const unsigned long long old = atomicCAS(keys + s, kNoKey, key);
    if (old == kNoKey || old == key) return;
  }
}

__global__ void __launch_bounds__(kThreads)
ppa_eval_kernel(const float4* __restrict__ dv, const float* __restrict__ ops,
                const __grid_constant__ Workloads wl,
                float4* __restrict__ out, int64_t batch) {
  extern __shared__ float4 s_mem[];
  __shared__ unsigned long long s_key[kMaxSa];   // sa bits per slot
  const int n_ops = wl.end[wl.n - 1];
  StagedOp* s_ops = reinterpret_cast<StagedOp*>(s_mem);
  float2* s_tab = reinterpret_cast<float2*>(s_ops + n_ops);  // [op][slot]
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid < kMaxSa) s_key[tid] = kNoKey;
  for (int j = tid; j < n_ops; j += kThreads) {
    int w = 0;
    while (j >= wl.end[w]) ++w;
    s_ops[j] = stage_op(ops + j * kCols, wl.tp[w]);
  }
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const bool valid = b < batch;
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
  if (valid) {
    lo = dv[2 * b];
    hi = dv[2 * b + 1];
  }
  __syncthreads();

  // the block's distinct sa values, one leader a value a warp inserting
  // it; lanes past the batch carry keys no design can have
  const unsigned long long key =
      valid ? __float_as_uint(lo.w) : (1ull << 32) + lane;
  const unsigned mates = __match_any_sync(0xffffffffu, key);
  if (valid && lane == __ffs(mates) - 1) insert_key(s_key, key);
  __syncthreads();

  for (int t = tid; t < n_ops * kMaxSa; t += kThreads) {
    const unsigned long long k_s = s_key[t % kMaxSa];
    const StagedOp& op = s_ops[t / kMaxSa];
    if (k_s != kNoKey && __float_as_int(op.lo.x) == MATMUL) {
      s_tab[t] = sa_terms(op.hi.x, op.hi.y, op.hi.z,
                          __uint_as_float(static_cast<unsigned>(k_s)));
    }
  }
  __syncthreads();
  if (!valid) return;                   // past the batch: nothing to write

  int slot = -1;                        // -1: the design computes them
#pragma unroll
  for (int s = 0; s < kMaxSa; ++s) {
    if (s_key[s] == key) slot = s;
  }
  const Design d = derive(lo, hi);
  int begin = 0;
  for (int w = 0; w < wl.n; ++w) {
    const int end = wl.end[w];
    Sums acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = begin; j < end; ++j) {
      const float4 olo = s_ops[j].lo, ohi = s_ops[j].hi;
      add_op(acc, d, slot, j, __float_as_int(olo.x), olo, ohi, s_tab);
    }
    const int64_t row = static_cast<int64_t>(w) * batch + b;
    out[2 * row] = make_float4(acc.lat, acc.s0, acc.s1, acc.s2);
    out[2 * row + 1] = make_float4(acc.s3, d.area, 0.0f, 0.0f);
    begin = end;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, which must belong to the calling thread's current
// device (the caller selects it; this function leaves it unchanged), and
// returns the cudaError_t of the launch (0 on success).  dv: (batch, 8)
// fp32, 16-byte aligned; ops: the n_workloads op tables, (ends[n - 1], 8)
// fp32, workload w's rows ending at ends[w] (strictly increasing, ends[0]
// > 0); tps: each workload's TP degree; out: (n_workloads, batch, 8) fp32,
// 16-byte aligned.  Does not synchronise.
int ppa_eval_tables_launch(const float* dv, const float* ops,
                           int n_workloads, const int* ends, const float* tps,
                           float* out, long long batch, void* stream) {
  if (n_workloads < 1 || n_workloads > kMaxWorkloads || ends[0] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Workloads wl;
  wl.n = n_workloads;
  for (int w = 0; w < kMaxWorkloads; ++w) {
    const int i = w < n_workloads ? w : n_workloads - 1;
    if (w > 0 && w < n_workloads && ends[w] <= ends[w - 1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    wl.end[w] = ends[i];
    wl.tp[w] = tps[i];
  }
  if (batch <= 0) return 0;
  const int n_ops = ends[n_workloads - 1];
  const size_t smem = static_cast<size_t>(n_ops)
                      * (sizeof(StagedOp) + kMaxSa * sizeof(float2));
  if (smem > 48 * 1024) {               // above the default cap: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        ppa_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (batch + kThreads - 1) / kThreads;
  ppa_eval_kernel<<<static_cast<unsigned int>(grid), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(dv), ops, wl,
      reinterpret_cast<float4*>(out), static_cast<int64_t>(batch));
  return static_cast<int>(cudaGetLastError());
}

const char* ppa_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
