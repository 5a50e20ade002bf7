// Flash-attention forward (online softmax) on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_fa_kernel` / `flash_attention_fwd` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: for each
// (batch, head) and query row, o = softmax(q k^T * scale [causal mask]) v,
// computed tile by tile with a running max m, running sum l and an fp32
// accumulator, masked scores set to NEG_INF = -1e30 and the result divided
// by max(l, 1e-30).  Inputs fp32 or bf16, head dim 16, 32, 64 or 128; all
// arithmetic is fp32 (plain FMA, no tensor cores: TF32's 10-bit mantissa
// would miss the fp32 tolerance), the output is written in the input type.
//
// Layout: q, o are (B, Sq, H, hd) and k, v are (B, Sk, KVH, hd), contiguous,
// as the model's projections leave them: the kernel computes its own
// offsets, so no transpose to (BH, S, hd) is needed, and for grouped-query
// attention query head h reads KV head h / (H / KVH) in place of the
// repeated tensor the reference builds.  Ragged Sq and Sk are masked.
//
// What bounds it on an H100: at the llama3.2-1b prefill shape (B 2, S 4096,
// H 32, hd 64, causal) it does ~137 GFLOP against ~170 MB of traffic, so
// it is bound by operations; without tensor cores that is the 67 TFLOP/s
// fp32 rate (~2 ms).  The design keeps the S x S scores out of device
// memory and feeds the FMA units from shared memory with as few loads as
// it can: one block of 256 threads per (64-query tile, batch x head); the
// Q tile (transposed) and each 64-key K tile (transposed) and V tile are
// staged in shared memory as fp32.  Each thread owns a 4 x 4 tile of the
// scores (4 query rows x 4 keys): per head-dim step two float4 loads feed
// 16 FMAs.  The row max is reduced over the 16 threads of a row with four
// shuffles per tile; each thread keeps its own partial row sums, rescaled
// with the row's max, and sums them once at the end.  The probabilities go
// through shared memory to the P.V product, where each thread owns 4 rows
// x hd/16 output columns in registers (four broadcast loads of P and
// hd/64 float4s of V per 4 x hd/16 FMAs).  Causal blocks stop at the diagonal, and the
// grid is walked from the last query tile down so that the longest blocks
// start first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr int kThreads = 256;             // 16 x 16 threads
constexpr int kPS = kBK + 4;              // P row stride (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Output column n (0 <= n < hd/16) of thread column tx: 4-wide groups of
// adjacent columns, 64 apart, for hd >= 64; adjacent columns below.
template <int HD>
__device__ __forceinline__ int out_col(int tx, int n) {
  constexpr int NC = HD / 16;
  if constexpr (NC >= 4) return (n / 4) * 64 + tx * 4 + (n % 4);
  else return tx * NC + n;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * HD * kBQ + kBQ * kPS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int h,
       int kvh, float scale, int causal) {
  constexpr int NC = HD / 16;             // output columns per thread
  constexpr int C4 = HD / 4;              // float4 chunks per row
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [HD][kBQ]
  float* kt = qt + HD * kBQ;                     // [HD][kBK]
  float* vs = kt + HD * kBK;                     // [kBK][HD]
  float* ps = vs + kBK * HD;                     // [kBQ][kPS]

  const int qt_idx = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int q0 = qt_idx * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int kh = hh / (h / kvh);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const T* qb = q + static_cast<size_t>(b) * sq * q_stride + hh * HD;
  const T* kb = k + static_cast<size_t>(b) * sk * kv_stride + kh * HD;
  const T* vb = v + static_cast<size_t>(b) * sk * kv_stride + kh * HD;

  // Q tile, transposed: lanes walk rows, so the scattered stores do not
  // collide in a bank
  for (int idx = tid; idx < kBQ * C4; idx += kThreads) {
    const int r = idx % kBQ, c = idx / kBQ;
    const float4 x = q0 + r < sq
        ? load4(qb + static_cast<size_t>(q0 + r) * q_stride + 4 * c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    qt[(4 * c + 0) * kBQ + r] = x.x;
    qt[(4 * c + 1) * kBQ + r] = x.y;
    qt[(4 * c + 2) * kBQ + r] = x.z;
    qt[(4 * c + 3) * kBQ + r] = x.w;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                      // the previous tile is consumed
    for (int idx = tid; idx < kBK * C4; idx += kThreads) {
      const int j = idx % kBK, c = idx / kBK;       // K: transposed
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < sk)
        x = load4(kb + static_cast<size_t>(k0 + j) * kv_stride + 4 * c);
      kt[(4 * c + 0) * kBK + j] = x.x;
      kt[(4 * c + 1) * kBK + j] = x.y;
      kt[(4 * c + 2) * kBK + j] = x.z;
      kt[(4 * c + 3) * kBK + j] = x.w;
      const int jv = idx / C4, cv = idx % C4;       // V: row-major
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + jv < sk)
        y = load4(vb + static_cast<size_t>(k0 + jv) * kv_stride + 4 * cv);
      reinterpret_cast<float4*>(vs)[jv * C4 + cv] = y;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kBK + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(get(a, i), get(c, j), s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool keep = kpos < sk && (!causal || kpos <= qpos);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr;
      m[i] = m_new;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPS + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, columns out_col(tx, n)
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPS + j];
      const float* vrow = vs + j * HD;
      if constexpr (NC >= 4) {
#pragma unroll
        for (int g = 0; g < NC / 4; ++g) {
          const float4 x =
              *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
          vv[4 * g] = x.x; vv[4 * g + 1] = x.y;
          vv[4 * g + 2] = x.z; vv[4 * g + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int n = 0; n < NC; ++n) vv[n] = vrow[tx * NC + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(p[i], vv[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qpos = q0 + ty * 4 + i;
    if (qpos < sq) {
      const float den = fmaxf(lt, 1e-30f);
      T* orow = o + (static_cast<size_t>(b) * sq + qpos) * q_stride + hh * HD;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        store1(orow + out_col<HD>(tx, n), acc[i][n] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int h, int kvh, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  fa_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kvh, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int b, int sq, int sk, int h, int kvh,
                      float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, sk, h, kvh, scale,
                                  causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, sk, h, kvh, scale,
                                  causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, sk, h, kvh, scale,
                                  causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, sk, h, kvh, scale,
                                    causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success).  dtype: 0 fp32, 1 bf16.
// q, o: (b, sq, h, hd); k, v: (b, sk, kvh, hd); contiguous, 16-byte
// aligned; h a multiple of kvh; hd in {16, 32, 64, 128}.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int sq, int sk, int h, int kvh,
                           int hd, int dtype, float scale, int causal,
                           void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_hd<float>(
        hd, q, k, v, o, b, sq, sk, h, kvh, scale, causal, s));
    case 1: return static_cast<int>(launch_hd<__nv_bfloat16>(
        hd, q, k, v, o, b, sq, sk, h, kvh, scale, causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
