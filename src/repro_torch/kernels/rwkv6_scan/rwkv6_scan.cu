// RWKV6 ("Finch") WKV recurrence on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_wkv6_kernel` / `rwkv6_scan_fwd` in
// src/repro/kernels/rwkv6_scan/kernel.py.  Same function: per (batch,
// head), from a zero (hd, hd) fp32 state S,
//
//     y_t = r_t . (S + u (x) (k_t^T v_t))        (a row vector, length hd)
//     S   = diag(w_t) S + k_t^T v_t
//
// for t = 0..T-1, in fp32 whatever the input type (fp32 or bf16); y is
// written in the input type.  Layout is the model's: r, k, v, w, y are
// (B, T, H, hd) contiguous, u is (H, hd) fp32.  Ragged T is masked.
//
// What bounds it on an H100: at the rwkv6-7b prefill shape (B 1, T 4096,
// H 64, hd 64) it moves ~0.34 GB (five (B, T, H, hd) fp32 arrays), 0.100 ms
// at 3.35 TB/s, and needs ~5.45 GFLOP (five operations per state element
// per step, factored as y = r.S + v (r.(u*k)); S = w*S + k v^T), 0.081 ms
// at 67 TFLOP/s.  Neither is what holds it: the recurrence is a chain of T
// dependent steps, so the time is T times the latency of one step.  The
// design puts that chain on as many SMs as the data allows and keeps each
// step short: column j of S evolves independently (it needs only v_t[j]),
// so a block owns 32 columns of one head (grid: hd/32 x B*H), and each
// thread owns one column and 16 of its rows in registers; a step is 16
// independent row updates per thread (one float4 shared load of r, k, w
// each), a partial y[j] in two interleaved sums, and a sum across the
// hd/16 threads of the column with warp shuffles (adjacent lanes).  The
// state never leaves registers.  Chunks of 8 * threads / hd steps of r,
// k, w (packed as float4) and of the block's v columns are staged in
// shared memory; the next chunk's global loads are issued into registers
// before the current chunk's steps run, so their latency is hidden.  The
// chunk's y columns are gathered in shared memory and written back
// coalesced.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD> struct Shape {
  static constexpr int JB = HD < 32 ? HD : 32;    // columns per block
  static constexpr int RG = HD / 16;              // threads per column
  static constexpr int RPT = HD / RG;             // rows per thread (16)
  static constexpr int NT = JB * RG;              // threads per block
  static constexpr int TC = 8 * NT / HD;          // steps per chunk
  static constexpr int E = TC * HD / NT;          // r/k/w loads per thread
  static constexpr int EV = TC * JB / NT;         // v loads per thread
};

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::NT)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ w,
         const float* __restrict__ u, T* __restrict__ y, int t_len, int h) {
  using S = Shape<HD>;
  __shared__ float4 rkw[S::TC][HD];               // (r, k, w, -)
  __shared__ float vs[S::TC][S::JB], ys[S::TC][S::JB];

  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int col0 = blockIdx.x * S::JB;
  const int tid = threadIdx.x;
  const int jl = tid / S::RG, g = tid % S::RG;    // column, row group

  // rows i = m * RG + g: the RG threads of a column read adjacent words
  float st[S::RPT], uu[S::RPT];
#pragma unroll
  for (int m = 0; m < S::RPT; ++m) {
    st[m] = 0.f;
    uu[m] = u[hh * HD + m * S::RG + g];
  }

  const size_t t_stride = static_cast<size_t>(h) * HD;
  const size_t base = static_cast<size_t>(b) * t_len * t_stride + hh * HD;
  float4 nx[S::E];                                // the next chunk
  float nv[S::EV];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < S::E; ++e) {
      const int idx = tid + e * S::NT;
      const int tt = idx / HD, c = idx % HD;
      nx[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + tt < t_len) {
        const size_t off = base + (t0 + tt) * t_stride + c;
        nx[e] = make_float4(to_f32(r[off]), to_f32(k[off]), to_f32(w[off]),
                            0.f);
      }
    }
#pragma unroll
    for (int e = 0; e < S::EV; ++e) {
      const int idx = tid + e * S::NT;
      const int tt = idx / S::JB, c = idx % S::JB;
      nv[e] = t0 + tt < t_len
          ? to_f32(v[base + (t0 + tt) * t_stride + col0 + c]) : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < t_len; t0 += S::TC) {
    const int n = min(S::TC, t_len - t0);
    __syncthreads();                    // the previous chunk is consumed
#pragma unroll
    for (int e = 0; e < S::E; ++e) {
      const int idx = tid + e * S::NT;
      rkw[idx / HD][idx % HD] = nx[e];
    }
#pragma unroll
    for (int e = 0; e < S::EV; ++e) {
      const int idx = tid + e * S::NT;
      vs[idx / S::JB][idx % S::JB] = nv[e];
    }
    __syncthreads();
    if (t0 + S::TC < t_len) fetch(t0 + S::TC);    // in flight meanwhile

    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][jl];
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int m = 0; m < S::RPT; ++m) {
        const float4 x = rkw[tt][m * S::RG + g];  // r, k, w of row i
        const float a = x.y * vj;
        const float t = x.x * fmaf(uu[m], a, st[m]);
        if (m % 2) p1 += t; else p0 += t;
        st[m] = fmaf(x.z, st[m], a);
      }
      float part = p0 + p1;
#pragma unroll
      for (int off = 1; off < S::RG; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (g == 0) ys[tt][jl] = part;
    }
    __syncthreads();
    for (int idx = tid; idx < S::TC * S::JB; idx += S::NT) {
      const int tt = idx / S::JB, c = idx % S::JB;
      if (tt < n)
        from_f32(y + base + (t0 + tt) * t_stride + col0 + c, ys[tt][c]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, void* y, int b, int t_len,
                   int h, cudaStream_t stream) {
  const dim3 grid(HD / Shape<HD>::JB, b * h);
  wkv6_fwd<T, HD><<<grid, Shape<HD>::NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(y), t_len, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* r, const void* k, const void* v,
                      const void* w, const float* u, void* y, int b,
                      int t_len, int h, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, b, t_len, h, s);
    case 32: return launch<T, 32>(r, k, v, w, u, y, b, t_len, h, s);
    case 64: return launch<T, 64>(r, k, v, w, u, y, b, t_len, h, s);
    case 128: return launch<T, 128>(r, k, v, w, u, y, b, t_len, h, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success).  dtype: 0 fp32, 1 bf16.
// r, k, v, w, y: (b, t_len, h, hd) contiguous in that dtype; u: (h, hd)
// fp32; hd in {16, 32, 64, 128}.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* w, const void* u, void* y, int b,
                      int t_len, int h, int hd, int dtype, void* stream) {
  if (b <= 0 || t_len <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  switch (dtype) {
    case 0: return static_cast<int>(launch_hd<float>(
        hd, r, k, v, w, uf, y, b, t_len, h, s));
    case 1: return static_cast<int>(launch_hd<__nv_bfloat16>(
        hd, r, k, v, w, uf, y, b, t_len, h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
