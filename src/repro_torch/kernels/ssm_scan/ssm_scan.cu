// Mamba selective scan on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_ssm_kernel` / `ssm_scan_fwd` in
// src/repro/kernels/ssm_scan/kernel.py.  Same function: per (batch,
// channel d), from a zero fp32 state h of length N,
//
//     h_t = exp(dt_t A_d) (.) h_{t-1} + dt_t B_t u_t      (length N)
//     y_t = C_t . h_t
//
// for t = 0..T-1, in fp32 whatever the input type (fp32 or bf16); y is
// written in the input type.  No D term and no skip path: the model adds
// D * u.  Layout is the model's: u, dt, y are (B, T, D) contiguous, A is
// (D, N) fp32, B and C are (B, T, N).  Ragged T and D are masked; N is
// one of 4, 8, 16, 32, 64.
//
// What bounds it on an H100: at the jamba-1.5-large prefill shape (B 1,
// T 4096, D 16384, N 16, fp32) it moves 806.9 MB (u, dt and y: 805.3 MB;
// A, B, C: 1.6 MB), 0.241 ms at 3.35 TB/s, and needs 6.5 GFLOP (six per
// state element per step: dt*A, exp's product with h, B*(dt*u), the add,
// C*h and its sum; and dt*u per channel), 0.097 ms at 67 TFLOP/s.
// Beside them, the 1.07 G exps: on the SFU (16 per clock per SM) about
// 0.26 ms at 1.98 GHz, the largest term.  The recurrence is a chain of T dependent steps per
// channel, so the time is also T times the latency of one step.
//
// Design, right and simple first: time is a loop inside the block; the N
// states of a channel are split over G = N / 4 adjacent lanes, each lane
// keeping 4 states and their 4 A values in registers, and y_t is summed
// over the G lanes with warp shuffles.  A 128-thread block owns 128 / G
// channels of one batch row (grid: D / (128 / G) x B).  Chunks of 16 steps
// of B_t and C_t (shared by all channels) and of the block's u and dt
// columns are staged in shared memory; the next chunk's global loads are
// issued into registers before the current chunk's steps run.  u and dt
// are read coalesced (adjacent threads, adjacent d); y is gathered in
// shared memory per chunk and written back coalesced.  What holds it back:
// at B*D = 16,384 channels and N 16 the grid is 512 blocks, about four
// 4-warp blocks per SM, so each step's exp and shuffle latencies are only
// partly hidden; exp is the accurate expf (no fast math).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 128;      // threads per block
constexpr int TC = 16;       // time steps per chunk
constexpr int SPT = 4;       // states per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int N> struct Shape {
  static constexpr int G = N / SPT;           // lanes per channel
  static constexpr int CB = NT / G;           // channels per block
  static constexpr int EU = TC * CB / NT;     // u (and dt) loads per thread
  static constexpr int EB = TC * N / NT;      // B (and C) loads per thread
  static_assert(N % SPT == 0 && G <= 32 && EU >= 1, "unsupported N");
};

template <typename T, int N>
__global__ void __launch_bounds__(NT)
ssm_fwd(const T* __restrict__ u, const T* __restrict__ dt,
        const float* __restrict__ a, const T* __restrict__ bm,
        const T* __restrict__ cm, T* __restrict__ y, int t_len, int d) {
  using S = Shape<N>;
  constexpr int EBL = S::EB > 0 ? S::EB : 1;
  __shared__ __align__(16) float bs[TC][N];     // read as float4
  __shared__ __align__(16) float cs[TC][N];
  __shared__ float us[TC][S::CB], dts[TC][S::CB], ys[TC][S::CB];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * S::CB;
  const int tid = threadIdx.x;
  const int cl = tid / S::G, g = tid % S::G;  // channel in block, lane in it
  const bool live = d0 + cl < d;

  float h[SPT], av[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    h[j] = 0.f;
    av[j] = live ? a[static_cast<size_t>(d0 + cl) * N + g * SPT + j] : 0.f;
  }

  const size_t ud_base = static_cast<size_t>(b) * t_len * d + d0;
  const size_t bc_base = static_cast<size_t>(b) * t_len * N;
  float nu[S::EU], ndt[S::EU], nb[EBL], nc[EBL];  // the next chunk
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < S::EU; ++e) {
      const int idx = tid + e * NT;
      const int tt = idx / S::CB, c = idx % S::CB;
      const bool in = t0 + tt < t_len && d0 + c < d;
      const size_t off = ud_base + static_cast<size_t>(t0 + tt) * d + c;
      nu[e] = in ? to_f32(u[off]) : 0.f;
      ndt[e] = in ? to_f32(dt[off]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < EBL; ++e) {
      const int idx = tid + e * NT;
      const bool in = idx < TC * N && t0 + idx / N < t_len;
      const size_t off = bc_base + static_cast<size_t>(t0) * N + idx;
      nb[e] = in ? to_f32(bm[off]) : 0.f;
      nc[e] = in ? to_f32(cm[off]) : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < t_len; t0 += TC) {
    const int n = min(TC, t_len - t0);
    __syncthreads();                      // the previous chunk is consumed
#pragma unroll
    for (int e = 0; e < S::EU; ++e) {
      const int idx = tid + e * NT;
      us[idx / S::CB][idx % S::CB] = nu[e];
      dts[idx / S::CB][idx % S::CB] = ndt[e];
    }
#pragma unroll
    for (int e = 0; e < EBL; ++e) {
      const int idx = tid + e * NT;
      if (idx < TC * N) {
        bs[idx / N][idx % N] = nb[e];
        cs[idx / N][idx % N] = nc[e];
      }
    }
    __syncthreads();
    if (t0 + TC < t_len) fetch(t0 + TC);  // in flight meanwhile

    for (int tt = 0; tt < n; ++tt) {
      const float dtv = dts[tt][cl];
      const float du = dtv * us[tt][cl];
      const float4 bq = *reinterpret_cast<const float4*>(&bs[tt][g * SPT]);
      const float4 cq = *reinterpret_cast<const float4*>(&cs[tt][g * SPT]);
      const float bv[SPT] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[SPT] = {cq.x, cq.y, cq.z, cq.w};
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(expf(dtv * av[j]), h[j], bv[j] * du);
        part = fmaf(cv[j], h[j], part);
      }
#pragma unroll
      for (int off = 1; off < S::G; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (g == 0) ys[tt][cl] = part;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < S::EU; ++e) {
      const int idx = tid + e * NT;
      const int tt = idx / S::CB, c = idx % S::CB;
      if (tt < n && d0 + c < d)
        from_f32(y + ud_base + static_cast<size_t>(t0 + tt) * d + c,
                 ys[tt][c]);
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* u, const void* dt, const float* a,
                   const void* bm, const void* cm, void* y, int b, int t_len,
                   int d, cudaStream_t stream) {
  const dim3 grid((d + Shape<N>::CB - 1) / Shape<N>::CB, b);
  ssm_fwd<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), t_len, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int n, const void* u, const void* dt, const float* a,
                     const void* bm, const void* cm, void* y, int b,
                     int t_len, int d, cudaStream_t s) {
  switch (n) {
    case 4: return launch<T, 4>(u, dt, a, bm, cm, y, b, t_len, d, s);
    case 8: return launch<T, 8>(u, dt, a, bm, cm, y, b, t_len, d, s);
    case 16: return launch<T, 16>(u, dt, a, bm, cm, y, b, t_len, d, s);
    case 32: return launch<T, 32>(u, dt, a, bm, cm, y, b, t_len, d, s);
    case 64: return launch<T, 64>(u, dt, a, bm, cm, y, b, t_len, d, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success).  dtype: 0 fp32, 1 bf16.
// u, dt, y: (b, t_len, d) contiguous in that dtype; a: (d, n) fp32;
// bm, cm: (b, t_len, n) in that dtype; n in {4, 8, 16, 32, 64}.
int ssm_scan_launch(const void* u, const void* dt, const void* a,
                    const void* bm, const void* cm, void* y, int b,
                    int t_len, int d, int n, int dtype, void* stream) {
  if (b <= 0 || t_len <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  switch (dtype) {
    case 0: return static_cast<int>(launch_n<float>(
        n, u, dt, af, bm, cm, y, b, t_len, d, s));
    case 1: return static_cast<int>(launch_n<__nv_bfloat16>(
        n, u, dt, af, bm, cm, y, b, t_len, d, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
