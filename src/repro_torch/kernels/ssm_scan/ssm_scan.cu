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
// The floors at the jamba-1.5-large prefill shape (B 1, T 4096, D 16384,
// N 16) on an H100 (132 SMs, 1.98 GHz, 3.35 TB/s):
//
//   bytes        806.9 MB fp32 / 404.0 MB bf16 (u, dt, y; A, B, C 1.6 MB)
//                  0.241 / 0.121 ms
//   operations   6.5 GFLOP (6 per state element per step, dt*u per
//                channel) at 67 TFLOP/s: 0.097 ms
//   exps         1.074 G on the SFU at 16 per clock per SM: 0.257 ms
//
// and the one that bounds a kernel keeping the accurate expf, issue slots:
// per state and step dt*A (1), expf (8: five FP32 ops, a shift, one
// MUFU.EX2, the scaling product), B*(dt*u) (1), the h FFMA (1) and the
// C*h FFMA (1) are 12 warp instructions per 32 state-steps, 1.074 G / 32
// x 12 = 403 M warp instructions over 528 schedulers at 1.98 GHz: 0.385
// ms at one instruction a clock.  Each step also loads dt, u, B_t and C_t,
// forms dt*u and (G > 1) shuffles y_t, about one more per state-step.
//
// Why sequential in time and not chunked as rwkv6_scan is: rwkv6's decay
// is per head and channel, so a chunk's outputs become dot products of
// rows.  Here the decay exp(dt_t A_dn) differs for every (t, d, n): inside
// a chunk the contribution of step s to step t needs its own exp per (t,
// s, d, n), which is no dense product, and a two-pass chunk scan (chunk
// states, then chunk outputs) takes every step's exp twice (0.51 ms on the
// SFU, twice what a sequential kernel needs).  Parallelism across time is
// not what is missing either: B * D = 16,384 independent channels fill
// the card.  So the kernel walks time and cuts per-step overhead and
// exposed latency instead:
//
// * A thread keeps SPT = 8 states of one channel and their A values in
//   registers, G = N / 8 lanes per channel (N 16: two lanes, joined by one
//   xor shuffle; N 4 and 8: one lane), so dt, u and dt*u are loaded and
//   formed once per 8 states and B_t, C_t are broadcast 16-byte shared
//   loads.  y_t is summed in state order, one FFMA chain per lane, then
//   across the G lanes by xor shuffles.  16 states a lane (one lane a
//   channel at N 16, no shuffle, 16 independent chains a thread) leaves
//   one warp per scheduler at the jamba shape and was slower on the card
//   (PERF.md, section 6).
// * Time goes in chunks of TC steps: 64, or 32 where a block's staging at
//   64 would not let two blocks share an SM's shared memory (fp32 and bf16
//   at N 4 and 8, 128 channels a block).  Within a chunk the step loop is
//   unrolled UNROLL = 16 steps at a time (a ragged last chunk runs a plain
//   loop), so one step's dt*A, exps and loads issue while earlier steps'
//   FFMAs retire.  The 16 steps' y stay in registers and are stored
//   together: a shared store between steps would order the later steps'
//   shared loads after it.
// * A 128-thread block owns 128 / G channels of one batch row (grid: D /
//   channels x B; at the jamba shape 256 blocks, two an SM).  Each chunk's
//   u and dt columns and B_t, C_t rows are double-buffered in shared
//   memory.  u and dt stay in the input type: fp32 and bf16 both by
//   16-byte cp.async (4-byte cp.async or element copies where D or a
//   pointer does not allow pieces); bf16 is widened where a step reads it.
//   B and C are stored widened to fp32: fp32 by cp.async, bf16 held raw in
//   registers from the load and widened only at the shared-memory store,
//   after the current chunk's steps, so no load's latency is waited on
//   early.  y is gathered in shared memory per chunk and written back one
//   chunk later, coalesced (16-byte pieces, packed bf16).
// * exp is the accurate expf, the function torch.exp computes on the card,
//   so the kernel and the plain version agree on every decay and differ
//   only in the rounding of the sums.
//
// What holds it: neither bytes nor the SFU.  The time is ~1.6x the
// issue-slot floor above (PERF.md, section 6).  The likeliest cause, not
// yet measured stall by stall, is latency that two warps per scheduler do
// not hide: expf's chain of dependent FP32 ops, the MUFU latency and the
// y chain.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int NT = 128;              // threads per block
constexpr int SPT_MAX = 8;           // states a lane at most
constexpr int BWD_C = 64;            // steps between the backward's checkpoints
constexpr int UNROLL = 16;           // steps unrolled together
constexpr int SM_SMEM = 228 * 1024;  // shared memory of one SM
constexpr int BLOCK_SMEM = 1024;     // reserved per resident block

template <typename T, int N> struct Shape {
  static constexpr int SPT = N < SPT_MAX ? N : SPT_MAX;  // states a lane
  static constexpr int G = N / SPT;                      // lanes a channel
  static constexpr int CB = NT / G;                      // channels a block
  // one stage of tc steps: u, dt as they come (T), B, C widened (fp32);
  // a block holds two stages, then two fp32 y tiles
  static constexpr int stage_bytes(int tc) {
    return 2 * tc * CB * static_cast<int>(sizeof(T)) + 2 * tc * N * 4;
  }
  static constexpr int smem_bytes(int tc) {
    return 2 * stage_bytes(tc) + 2 * tc * CB * 4;
  }
  // time steps per chunk: 64 if two blocks then fit an SM, else 32
  static constexpr int TC =
      2 * (smem_bytes(64) + BLOCK_SMEM) <= SM_SMEM ? 64 : 32;
  static constexpr int UD = TC * CB;         // elements of a u or dt tile
  static constexpr int BC = TC * N;          // elements of a B or C tile
  static constexpr int STAGE_BYTES = stage_bytes(TC);
  static constexpr int SMEM_BYTES = smem_bytes(TC);
  static_assert(SPT % 4 == 0 && N % SPT == 0 && G <= 32 && CB % 8 == 0,
                "unsupported N");
  static_assert(TC % UNROLL == 0 && 2 * (SMEM_BYTES + BLOCK_SMEM) <= SM_SMEM,
                "two blocks must fit an SM");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies of 16 and 4 bytes; zero-fill when `ok` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// Rows [0, TC) x columns [0, W) of a row-major array (`src` at the tile's
// first element, rows `ld` apart) into shared memory; rows at or past
// `rows` and columns at or past `cols` are zero.  vec: 16-byte pieces (the
// caller has checked alignment, so `cols` is a multiple of a piece), else
// single elements.  load() starts the copy of the next chunk, store()
// finishes it once the current chunk is stepped; the caller then waits
// (cp_async_wait_all) and syncs before reading `dst`.
//
// Raw keeps the elements as they come (u and dt: bf16 is widened where a
// step reads it): pieces go by cp.async, and so do fp32 elements; bf16
// elements (a D or pointer that pieces do not fit, off the model's path)
// are copied one by one in store().
template <typename T, int W, int TC> struct Raw {
  static constexpr int E = 16 / sizeof(T);               // elements a piece
  static constexpr int NV = TC * W / E, KV = (NV + NT - 1) / NT;
  static constexpr int NS = TC * W;
  static_assert(W % E == 0, "a row is whole pieces");
  const T* src_;
  size_t ld_;
  int rows_, cols_;
  __device__ __forceinline__ void load(const T* src, size_t ld, int rows,
                                       int cols, bool vec, T* dst) {
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll
      for (int e = 0; e < KV; ++e) {
        const int i = tid + e * NT;
        if (NV % NT == 0 || i < NV) {
          const int r = i / (W / E), c = i % (W / E) * E;
          const bool ok = r < rows && c < cols;
          cp_async16(dst + r * W + c, ok ? src + r * ld + c : src, ok);
        }
      }
    } else if constexpr (sizeof(T) == 4) {
      for (int i = tid; i < NS; i += NT) {
        const int r = i / W, c = i % W;
        const bool ok = r < rows && c < cols;
        cp_async4(dst + i, ok ? src + r * ld + c : src, ok);
      }
    } else {
      src_ = src;
      ld_ = ld;
      rows_ = rows;
      cols_ = cols;
    }
  }
  __device__ __forceinline__ void store(T* dst, bool vec) const {
    if constexpr (sizeof(T) == 2) {
      if (!vec) {
        const unsigned short* raw =
            reinterpret_cast<const unsigned short*>(src_);
        unsigned short* out = reinterpret_cast<unsigned short*>(dst);
        for (int i = threadIdx.x; i < NS; i += NT) {
          const int r = i / W, c = i % W;
          out[i] = r < rows_ && c < cols_ ? raw[r * ld_ + c] : 0;
        }
      }
    }
  }
};

// Wide widens to fp32 (B and C, read four at a time by every step): fp32
// is Raw; bf16 pieces are held raw in registers by load() and widened
// into `dst` by store(), bf16 elements (N 4, or a pointer that pieces do
// not fit) are read and widened one by one in store().
template <typename T, int W, int TC> struct Wide : Raw<T, W, TC> {};

template <int W, int TC> struct Wide<__nv_bfloat16, W, TC> {
  static constexpr int PW = W % 8 == 0 ? W / 8 : 0;   // pieces a row
  static constexpr int NV = TC * PW, KV = (NV + NT - 1) / NT + (NV == 0);
  static constexpr int NS = TC * W;
  uint4 v[KV];                 // vec: 8 raw values each
  const unsigned short* src_;
  size_t ld_;
  int rows_, cols_;
  __device__ __forceinline__ void load(const __nv_bfloat16* src, size_t ld,
                                       int rows, int cols, bool vec,
                                       float*) {
    if (PW > 0 && vec) {
#pragma unroll
      for (int e = 0; e < KV; ++e) {
        const int i = threadIdx.x + e * NT;
        const int r = i / PW, c = i % PW * 8;
        v[e] = make_uint4(0u, 0u, 0u, 0u);
        if ((NV % NT == 0 || i < NV) && r < rows && c < cols)
          v[e] = *reinterpret_cast<const uint4*>(src + r * ld + c);
      }
    } else {
      src_ = reinterpret_cast<const unsigned short*>(src);
      ld_ = ld;
      rows_ = rows;
      cols_ = cols;
    }
  }
  __device__ __forceinline__ void store(float* dst, bool vec) const {
    if (PW > 0 && vec) {
#pragma unroll
      for (int e = 0; e < KV; ++e) {
        const int i = threadIdx.x + e * NT;
        if (NV % NT == 0 || i < NV) {
          const uint32_t wd[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
          float f[8];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            f[2 * m] = __uint_as_float(wd[m] << 16);
            f[2 * m + 1] = __uint_as_float(wd[m] & 0xffff0000u);
          }
          float4* d = reinterpret_cast<float4*>(dst + i * 8);
          d[0] = make_float4(f[0], f[1], f[2], f[3]);
          d[1] = make_float4(f[4], f[5], f[6], f[7]);
        }
      }
    } else {
      for (int i = threadIdx.x; i < NS; i += NT) {
        const int r = i / W, c = i % W;
        dst[i] = r < rows_ && c < cols_ ? widen(src_[r * ld_ + c]) : 0.f;
      }
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return widen(__bfloat16_as_ushort(x));
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Writes rows [0, rows) x columns [0, cols) of the shared fp32 tile `ys`
// (TC x CB) to `dst` (rows `ld` apart) in T, 16-byte pieces if vec.
template <typename T, int CB, int TC>
__device__ __forceinline__ void write_y(T* dst, const float* ys, size_t ld,
                                        int rows, int cols, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T), NV = TC * CB / E;
#pragma unroll
    for (int k = 0; k < (NV + NT - 1) / NT; ++k) {
      const int i = tid + k * NT;
      const int r = i / (CB / E), c = i % (CB / E) * E;
      if ((NV % NT == 0 || i < NV) && r < rows && c < cols) {
        const float4* src = reinterpret_cast<const float4*>(ys + i * E);
        uint4 out;
        if constexpr (sizeof(T) == 4) {
          const float4 f = src[0];
          out = make_uint4(__float_as_uint(f.x), __float_as_uint(f.y),
                           __float_as_uint(f.z), __float_as_uint(f.w));
        } else {
          const float4 f0 = src[0], f1 = src[1];
          const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
          uint32_t wd[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * m],
                                                           f[2 * m + 1]);
            wd[m] = *reinterpret_cast<const uint32_t*>(&p);
          }
          out = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
        *reinterpret_cast<uint4*>(dst + r * ld + c) = out;
      }
    }
  } else {
    for (int i = tid; i < TC * CB; i += NT) {
      const int r = i / CB, c = i % CB;
      if (r < rows && c < cols) put(dst + r * ld + c, ys[i]);
    }
  }
}

// SAVE (fp32, a forward whose gradient is wanted): also writes h after
// every BWD_C steps but the last into hs (B, ceil(T / BWD_C) - 1, D, N),
// the backward's checkpoints; the no-grad instantiation has no such code.
template <typename T, int N, bool SAVE>
__global__ void __launch_bounds__(NT, 1)
ssm_fwd(const T* __restrict__ u, const T* __restrict__ dt,
        const float* __restrict__ a, const T* __restrict__ bm,
        const T* __restrict__ cm, T* __restrict__ y,
        float* __restrict__ hs, int t_len, int d, bool vec_ud,
        bool vec_bc) {
  using S = Shape<T, N>;
  constexpr int SPT = S::SPT, G = S::G, CB = S::CB, TC = S::TC,
                UD = S::UD, BC = S::BC;
  static_assert(!SAVE || BWD_C % TC == 0, "checkpoints fall on chunk ends");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  // stage p: u, dt (TC x CB, T), B, C (TC x N, fp32); then two y tiles
  auto su = [&](int p) {
    return reinterpret_cast<T*>(smem + p * S::STAGE_BYTES);
  };
  auto sb = [&](int p) {
    return reinterpret_cast<float*>(su(p) + 2 * UD);
  };
  auto ytile = [&](int p) {
    return reinterpret_cast<float*>(smem + 2 * S::STAGE_BYTES) + p * UD;
  };

  const int d0 = blockIdx.x * CB;
  const int cl = threadIdx.x / G, g = threadIdx.x % G;  // channel, lane
  const int cols = min(CB, d - d0);

  float h[SPT], av[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    h[j] = 0.f;
    av[j] = cl < cols ? a[static_cast<size_t>(d0 + cl) * N + g * SPT + j]
                      : 0.f;
  }

  const size_t row0 = static_cast<size_t>(blockIdx.y) * t_len;
  const T* ug = u + row0 * d + d0;
  const T* dtg = dt + row0 * d + d0;
  T* yg = y + row0 * d + d0;
  const T* bg = bm + row0 * N;
  const T* cg = cm + row0 * N;
  Raw<T, CB, TC> tu, tdt;
  Wide<T, N, TC> tb, tc;
  auto issue = [&](int t0, int p) {          // chunk at t0 into stage p
    const int rows = min(TC, t_len - t0);
    const size_t ud = static_cast<size_t>(t0) * d;
    tu.load(ug + ud, d, rows, cols, vec_ud, su(p));
    tdt.load(dtg + ud, d, rows, cols, vec_ud, su(p) + UD);
    tb.load(bg + static_cast<size_t>(t0) * N, N, rows, N, vec_bc, sb(p));
    tc.load(cg + static_cast<size_t>(t0) * N, N, rows, N, vec_bc,
            sb(p) + BC);
    cp_async_commit();
  };

  // one step; returns y_t (every lane of the channel holds it)
  auto step = [&](int p, int tt) {
    const float dtv = to_f32(su(p)[UD + tt * CB + cl]);
    const float du = dtv * to_f32(su(p)[tt * CB + cl]);
    const float4* bq = reinterpret_cast<const float4*>(
        sb(p) + tt * N + g * SPT);
    const float4* cq = reinterpret_cast<const float4*>(
        sb(p) + BC + tt * N + g * SPT);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < SPT / 4; ++q) {
      const float4 b4 = bq[q], c4 = cq[q];
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        h[k] = fmaf(expf(dtv * av[k]), h[k], bv[j] * du);
        acc = fmaf(cv[j], h[k], acc);
      }
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
  };

  const int n_chunks = (t_len + TC - 1) / TC;
  issue(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int p = c & 1, t0 = c * TC;
    // finish staging chunk c (the stage was last read two chunks ago):
    // bf16 B, C are widened from registers, odd-shaped bf16 u, dt copied
    tu.store(su(p), vec_ud);
    tdt.store(su(p) + UD, vec_ud);
    tb.store(sb(p), vec_bc);
    tc.store(sb(p) + BC, vec_bc);
    cp_async_wait_all();
    __syncthreads();         // chunk c staged; chunk c - 1 fully stepped
    if (c > 0)
      write_y<T, CB, TC>(yg + static_cast<size_t>(t0 - TC) * d,
                         ytile(p ^ 1), d, TC, cols, vec_ud);
    if (c + 1 < n_chunks) issue(t0 + TC, p ^ 1);
    float* ys = ytile(p);
    if (t_len - t0 >= TC) {
#pragma unroll 1
      for (int t1 = 0; t1 < TC; t1 += UNROLL) {
        // y stays in registers for UNROLL steps: a shared store between
        // steps would order every later step's shared loads after it (the
        // compiler cannot tell the y tile from the stage apart)
        float yv[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) yv[k] = step(p, t1 + k);
        if (g == 0) {
#pragma unroll
          for (int k = 0; k < UNROLL; ++k) ys[(t1 + k) * CB + cl] = yv[k];
        }
      }
    } else {
#pragma unroll 1
      for (int tt = 0; tt < t_len - t0; ++tt) {
        const float yt = step(p, tt);
        if (g == 0) ys[tt * CB + cl] = yt;
      }
    }
    if constexpr (SAVE) {
      const int t_end = t0 + TC;          // h is the state after t_end steps
      if (t_end % BWD_C == 0 && t_end < t_len && cl < cols) {
        const int n_ck = (t_len + BWD_C - 1) / BWD_C - 1;
        float4* out = reinterpret_cast<float4*>(
            hs + ((static_cast<size_t>(blockIdx.y) * n_ck + t_end / BWD_C - 1)
                  * d + d0 + cl) * N + g * SPT);
#pragma unroll
        for (int q = 0; q < SPT / 4; ++q)
          out[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                               h[4 * q + 3]);
      }
    }
  }
  __syncthreads();
  const int t_last = (n_chunks - 1) * TC;
  write_y<T, CB, TC>(yg + static_cast<size_t>(t_last) * d,
                     ytile((n_chunks - 1) & 1), d, t_len - t_last, cols,
                     vec_ud);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int N, bool SAVE>
cudaError_t launch(const void* u, const void* dt, const float* a,
                   const void* bm, const void* cm, void* y, float* hs, int b,
                   int t_len, int d, cudaStream_t stream) {
  using S = Shape<T, N>;
  constexpr int E = 16 / sizeof(T);           // elements a 16-byte piece
  const int bytes = S::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_fwd<T, N, SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const bool vec_ud = d % E == 0 && aligned16(u) && aligned16(dt)
                      && aligned16(y);
  const bool vec_bc = N % E == 0 && aligned16(bm) && aligned16(cm);
  const dim3 grid((d + S::CB - 1) / S::CB, b);
  ssm_fwd<T, N, SAVE><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), hs, t_len, d, vec_ud, vec_bc);
  return cudaGetLastError();
}

template <typename T, bool SAVE = false>
cudaError_t launch_n(int n, const void* u, const void* dt, const float* a,
                     const void* bm, const void* cm, void* y, float* hs,
                     int b, int t_len, int d, cudaStream_t s) {
  switch (n) {
    case 4: return launch<T, 4, SAVE>(u, dt, a, bm, cm, y, hs, b, t_len, d, s);
    case 8: return launch<T, 8, SAVE>(u, dt, a, bm, cm, y, hs, b, t_len, d, s);
    case 16:
      return launch<T, 16, SAVE>(u, dt, a, bm, cm, y, hs, b, t_len, d, s);
    case 32:
      return launch<T, 32, SAVE>(u, dt, a, bm, cm, y, hs, b, t_len, d, s);
    case 64:
      return launch<T, 64, SAVE>(u, dt, a, bm, cm, y, hs, b, t_len, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T> int smem_bytes(int n) {
  switch (n) {
    case 4: return Shape<T, 4>::SMEM_BYTES;
    case 8: return Shape<T, 8>::SMEM_BYTES;
    case 16: return Shape<T, 16>::SMEM_BYTES;
    case 32: return Shape<T, 32>::SMEM_BYTES;
    case 64: return Shape<T, 64>::SMEM_BYTES;
    default: return -1;
  }
}

// ---------------------------------------------------------------- backward
//
// (du, ddt, dA, dB, dC) of the function above for an output gradient dy,
// fp32 in and out.  Per lane (b, d), walking t = T-1 down to 0 with G =
// dL/dh_t and e_t = exp(dt_t A_d) (the accurate expf, as the forward):
//
//     G    += dy_t C_t
//     dC_t += dy_t h_t                 (summed over d)
//     dB_t += G dt_t u_t               (summed over d)
//     du_t  = dt_t G . B_t
//     ddt_t = sum_n A e_t h_{t-1} G + u_t G . B_t
//     dA   += G dt_t e_t h_{t-1}       (summed over b and t)
//     G     = e_t G
//
// Two launches.  The checkpoints, h after every BWD_C = 64 steps ((B,
// ceil(T/64) - 1, D, N), 67 MB at the jamba shape), come from the forward:
// its fp32 launch for a gradient (ssm_fwd<float, N, true>) stores them,
// bit for bit the states this walk would step to, since it steps h the
// same way.  `ssm_bwd` walks each lane's chunks from the last.  From the
// chunk's checkpoint it steps forward once, keeping each sub-chunk's first
// state (8 sub-chunks of BWD_SB = 8 steps) in shared memory; then per
// sub-chunk (last first) it recomputes the sub-chunk's 8 states and decays
// e_t into registers and walks them back, so each e_t is taken 1.875
// times (7 of 8 in the stepping, once in the history).  h_{t-1} is never
// recovered by dividing by e_t (e_t is near 0 or near 1 in the model's and
// the long-memory regimes).  `ssm_bwd_reduce` sums the blocks' dB and dC
// partials and the batch rows' dA in a fixed order.  No atomics: two calls
// agree bit for bit.
//
// Layout.  A thread keeps BWD_SPT = 4 states of one channel (G = N / 4
// lanes a channel, channel-major in the warp); a block of BwdShape::NT
// threads owns CB channels of one batch row (128 at N 4-16: at the jamba
// shape 128 blocks of 512 threads, one an SM and 16 warps on each of 128
// SMs, the grid one wave as every thread walks all of T).  A chunk's
// inputs are staged in shared memory by cp.async in two halves of 32
// steps (u, dt, dy columns, B and C rows), and the halves of the next
// chunk load while this one is walked: its first half while this chunk's
// first half is walked back, its second half while its own first half is
// stepped.  The next checkpoint loads with the first half.
//
// Sums.  du and ddt over a channel's lanes: one xor shuffle that keeps
// one of the two per lane, then xor shuffles.  dB and dC over a warp's
// channels: a reduce-scatter of each lane's 8 terms by xor shuffles
// (16, 8, 4: each level keeps half the values, the sum of the lane's and
// its partner's), so each lane holds one sum over the warp's 8 channels
// (N 16); then the sub-chunk's warps are summed in order out of shared
// memory, four sums a thread, into one partial per block by the first
// 64 threads (N 16) while the others go on (with every thread summing, or a
// halving tree over the warps, the walk took 0.19 ms more at the jamba
// shape): 128 (B, T, N) planes at the jamba shape, 67 MB for
// ssm_bwd_reduce to read.  dA is summed over t in registers into one
// partial per batch row.
//
// What bounds it: at the jamba shape (B 1, T 4096, D 16384, N 16) the
// function moves 1.345 GB (0.402 ms at 3.35 TB/s) and needs 23.8 GFLOP and
// 1.07 G exps; the walk is bound by issue slots (PERF.md §6).  A step of
// a lane's 4 states takes ~52 warp instructions in the stepping and again
// in the history recompute (the accurate expf is 8 a state) and ~100 in
// the reverse step (a third of them the shuffles, selects and adds of the
// sums): ~50 an element-step, of which 16 warps an SM keep ~80% of the
// issue slots busy.
constexpr int BWD_SPT = 4;           // states a lane
constexpr int BWD_SB = 8;            // steps a sub-chunk
constexpr int BWD_HS = 32;           // steps a staged half-chunk
constexpr int BWD_NSB = BWD_C / BWD_SB;
// threads a block at N = 4, 8, 16, 32, 64 (128 channels a block at N 4-16)
constexpr int BWD_THREADS[] = {128, 256, 512, 512, 256};
static_assert(BWD_C == 2 * BWD_HS && BWD_HS % BWD_SB == 0, "chunk halves");

constexpr int bwd_threads(int n) {
  return BWD_THREADS[n == 4 ? 0 : n == 8 ? 1 : n == 16 ? 2 : n == 32 ? 3 : 4];
}
constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

template <int N> struct BwdShape {
  static constexpr int NT = bwd_threads(N);  // threads a block
  static constexpr int G = N / BWD_SPT;      // lanes a channel
  static constexpr int CB = NT / G;          // channels a block
  static constexpr int W = NT / 32;          // warps a block
  static constexpr int CW = 32 / G;          // channels a warp
  static constexpr int NV = 2 * BWD_SPT;     // dB, dC terms a lane a step
  // reduce-scatter levels (each halves a lane's terms), then the xor
  // levels that finish the sum over the warp's channels
  static constexpr int RS = log2i(CW) < 3 ? log2i(CW) : 3;
  static constexpr int AR = log2i(CW) - RS;
  static constexpr int KEEP = NV >> RS;      // sums a lane holds after
  static constexpr int PW = 2 * N;           // distinct sums a warp a step
  static constexpr int UD = BWD_HS * CB;     // floats of a u, dt, dy half
  static constexpr int BC = BWD_HS * N;      // floats of a B, C half
  static constexpr int STAGE = 3 * UD + 2 * BC;
  static constexpr int TERMS = BWD_SB * W * PW;
  // two halves, the sub-chunk starts (BWD_NSB x NT x 4), the next
  // checkpoint (NT x 4), two term tiles
  static constexpr int SMEM_FLOATS =
      2 * STAGE + (BWD_NSB + 1) * NT * BWD_SPT + 2 * TERMS;
  static_assert(N % BWD_SPT == 0 && G <= 16 && NT % 32 == 0 && CB % 4 == 0,
                "unsupported N");
  static_assert(SMEM_FLOATS * 4 <= 232448, "a block's shared memory");
};

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [0, BWD_HS) x columns [0, W) of a row-major fp32 array (`src` at
// the tile's first element, rows `ld` apart) into shared memory by
// cp.async; rows at or past `rows` and columns at or past `cols` are
// zero.  vec: 16-byte pieces (`cols` and `ld` multiples of 4, `src`
// 16-byte aligned), else 4-byte elements.  `safe`: any readable address.
template <int W, int NTH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t ld, int rows, int cols,
                                           bool vec, const float* safe) {
  if (vec) {
    constexpr int NV = BWD_HS * W / 4;
#pragma unroll
    for (int e = 0; e < (NV + NTH - 1) / NTH; ++e) {
      const int i = threadIdx.x + e * NTH;
      if (NV % NTH == 0 || i < NV) {
        const int r = i / (W / 4), c = i % (W / 4) * 4;
        const bool ok = r < rows && c < cols;
        cp_async16(dst + r * W + c, ok ? src + r * ld + c : safe, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < BWD_HS * W; i += NTH) {
      const int r = i / W, c = i % W;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + i, ok ? src + r * ld + c : safe, ok);
    }
  }
}

// Levels K0 .. RS - 1 of a reduce-scatter over the lanes xor 16, 8, ..
// apart (level k: lanes 16 >> k apart), on the NV >> K0 values v holds
// after level K0 - 1: at each level a lane keeps the half of its values
// its lane bit names and adds its partner's copy of that half.  After
// level RS - 1 the lane's v[i] is the sum of the original v[base + i],
// base the sum of NV >> (k + 1) over the levels k whose bit the lane has.
template <int NV, int RS, int K0, int NK>
__device__ __forceinline__ void reduce_scatter(float (&v)[NK], int lane) {
#pragma unroll
  for (int k = K0; k < RS; ++k) {
    const int m = 16 >> k, c = NV >> (k + 1);
    const bool hi = lane & m;
#pragma unroll
    for (int i = 0; i < c; ++i) {
      const float send = hi ? v[i] : v[i + c];
      const float keep = hi ? v[i + c] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
}

// Phase clocks for kernels/ssm_scan/bench.py --bwd --stamps, in a build
// with -DSSM_BWD_STAMPS only: thread 0 of each block of batch row 0 (the
// first BWD_STAMP_BLOCKS) adds clock64() deltas per phase (BWD_STAMP_NAMES)
// and writes them to bwd_stamps[block * 8 + phase], and its SM and first
// and last %globaltimer (ns) to bwd_blocks[3 * block].
#define BWD_STAMP_NAMES                                                    \
  "waiting on the staged halves,stepping to the sub-chunk starts,history " \
  "recompute (h and e),reverse steps with the lane and warp sums,"         \
  "sub-chunk barrier,block sums over warps and partial stores"
#ifdef SSM_BWD_STAMPS
constexpr int BWD_PHASES = 6;
constexpr int BWD_STAMP_BLOCKS = 1024;
__device__ long long bwd_stamps[BWD_STAMP_BLOCKS * 8];
__device__ unsigned long long bwd_blocks[3 * BWD_STAMP_BLOCKS];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define BWD_PHASE(k)                                                      \
  do {                                                                    \
    const long long now = clock64();                                      \
    phase_clk[k] += now - clk;                                            \
    clk = now;                                                            \
  } while (0)
#else
#define BWD_PHASE(k) do {} while (0)
#endif

// hs: the forward's checkpoints (B, n_ck, D, N); dbp, dcp: one (B, T, N)
// partial per block of channels (blockIdx.x); dap: one (D, N) partial per
// batch row.
template <int N>
__global__ void __launch_bounds__(BwdShape<N>::NT, 1)
ssm_bwd(const float* __restrict__ u, const float* __restrict__ dt,
        const float* __restrict__ a, const float* __restrict__ bm,
        const float* __restrict__ cm, const float* __restrict__ dy,
        const float* __restrict__ hs, float* __restrict__ du_o,
        float* __restrict__ ddt_o, float* __restrict__ dbp,
        float* __restrict__ dcp, float* __restrict__ dap, int t_len, int d,
        int n_ck, bool vec_ud, bool vec_bc) {
  using S = BwdShape<N>;
  constexpr int NT = S::NT, G = S::G, CB = S::CB, W = S::W, SB = BWD_SB,
                SPT = BWD_SPT, NV = S::NV, KEEP = S::KEEP, PW = S::PW,
                UD = S::UD, BC = S::BC;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // half p: u, dt, dy (BWD_HS x CB), then B, C (BWD_HS x N)
  auto s_u = [&](int p) { return smem + p * S::STAGE; };
  auto s_b = [&](int p) { return smem + p * S::STAGE + 3 * UD; };
  float4* starts = reinterpret_cast<float4*>(smem + 2 * S::STAGE);
  float4* ckp = starts + BWD_NSB * NT;             // the next checkpoint
  float* terms = reinterpret_cast<float*>(ckp + NT);   // [2][SB][W][PW]

#ifdef SSM_BWD_STAMPS
  long long clk = clock64(), phase_clk[BWD_PHASES] = {};
  const unsigned long long ns0 = global_ns();
#endif
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cl = tid / G, g = tid % G;
  const int d0 = blockIdx.x * CB, dd = d0 + cl;
  const int cols = min(CB, d - d0);
  const bool on = cl < cols;                       // a channel past D: zeros
  const size_t row0 = static_cast<size_t>(blockIdx.y) * t_len;
  const size_t plane = static_cast<size_t>(gridDim.y) * t_len * N;
  float av[SPT], gr[SPT], da[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = on ? a[static_cast<size_t>(dd) * N + g * SPT + j] : 0.f;
    gr[j] = da[j] = 0.f;
  }
  // the lane's sums of dB, dC terms after the reduce-scatter: term index
  // base + i of the lane's NV (0-3 dB, 4-7 dC of states g * 4 + 0..3)
  int base = 0;
#pragma unroll
  for (int k = 0; k < S::RS; ++k)
    if (lane & (16 >> k)) base += NV >> (k + 1);
  // lanes whose remaining channel bits are 0 write the warp's sums
  constexpr int AR_MASK = ((1 << S::AR) - 1) << (5 - S::RS - S::AR);
  const bool writer = (lane & AR_MASK) == 0;

  const float* ug = u + row0 * d + d0;
  const float* dtg = dt + row0 * d + d0;
  const float* dyg = dy + row0 * d + d0;
  const float* bg = bm + row0 * N;
  const float* cg = cm + row0 * N;
  // half-chunk starting at step ts into half p; with the first half of a
  // chunk, that chunk's checkpoint (zeros for chunk 0)
  auto issue = [&](int ts, int p, int ch) {
    const int rows = min(BWD_HS, t_len - ts);
    const size_t off = static_cast<size_t>(ts) * d;
    float* su = s_u(p);
    stage_rows<CB, NT>(su, ug + off, d, rows, cols, vec_ud, u);
    stage_rows<CB, NT>(su + UD, dtg + off, d, rows, cols, vec_ud, u);
    stage_rows<CB, NT>(su + 2 * UD, dyg + off, d, rows, cols, vec_ud, u);
    float* sb = s_b(p);
    const size_t boff = static_cast<size_t>(ts) * N;
    stage_rows<N, NT>(sb, bg + boff, N, rows, N, vec_bc, u);
    stage_rows<N, NT>(sb + BC, cg + boff, N, rows, N, vec_bc, u);
    if (ts % BWD_C == 0) {
      const bool ok = ch > 0 && on;
      cp_async16(ckp + tid,
                 ok ? hs + ((static_cast<size_t>(blockIdx.y) * n_ck + ch - 1)
                            * d + dd) * N + g * SPT
                    : u,
                 ok);
    }
    cp_async_commit();
  };
  // the walk: every chunk from the last; each half's stage is refilled
  // with the next chunk's as soon as this chunk has read it
  int pl = 0;                            // the half holding the first half
#pragma unroll 1
  for (int k = 0; k < 2; ++k) issue(n_ck * BWD_C + k * BWD_HS, k, n_ck);
  int sub = 0;                                     // sub-chunks walked
#pragma unroll 1
  for (int ch = n_ck; ch >= 0; --ch) {
    const int t0 = ch * BWD_C, pu = pl ^ 1;
    cp_async_wait_one();
    __syncthreads();                     // the first half and checkpoint in
    BWD_PHASE(0);
    float h[SPT];
    {
      const float4 x = ckp[tid];
      h[0] = x.x; h[1] = x.y; h[2] = x.z; h[3] = x.w;
      starts[tid] = x;
    }
    // each sub-chunk's first state, stepping forward through the chunk
#pragma unroll 1
    for (int m = 1; m < BWD_NSB; ++m) {
      if (m == BWD_HS / SB + 1) {
        BWD_PHASE(1);
        cp_async_wait_all();
        __syncthreads();                 // the second half in
        BWD_PHASE(0);
      }
      const int r0 = (m - 1) * SB % BWD_HS;
      const float* su = s_u(m <= BWD_HS / SB ? pl : pu);
      const float* sb = s_b(m <= BWD_HS / SB ? pl : pu);
#pragma unroll
      for (int q = 0; q < SB; ++q) {
        const int r = r0 + q;
        const float dtv = su[UD + r * CB + cl];
        const float du = dtv * su[r * CB + cl];
        const float4 b4 = *reinterpret_cast<const float4*>(
            sb + r * N + g * SPT);
        const float bv[SPT] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          h[j] = fmaf(expf(dtv * av[j]), h[j], bv[j] * du);
      }
      starts[m * NT + tid] = make_float4(h[0], h[1], h[2], h[3]);
    }
    BWD_PHASE(1);
    // each sub-chunk from the last: its states and decays into registers,
    // its reverse steps, then the block's dB, dC partials of its steps
#pragma unroll 1
    for (int m = BWD_NSB - 1; m >= 0; --m) {
      const int p = m >= BWD_HS / SB ? pu : pl;
      const int r0 = m * SB % BWD_HS, ts0 = t0 + m * SB;
      const float* su = s_u(p);
      const float* sb = s_b(p);
      float hh[SB + 1][SPT], ee[SB][SPT];
      {
        const float4 x = starts[m * NT + tid];
        hh[0][0] = x.x; hh[0][1] = x.y; hh[0][2] = x.z; hh[0][3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < SB; ++q) {
        const int r = r0 + q;
        const float dtv = su[UD + r * CB + cl];
        const float du = dtv * su[r * CB + cl];
        const float4 b4 = *reinterpret_cast<const float4*>(
            sb + r * N + g * SPT);
        const float bv[SPT] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          ee[q][j] = expf(dtv * av[j]);
          hh[q + 1][j] = fmaf(ee[q][j], hh[q][j], bv[j] * du);
        }
      }
      BWD_PHASE(2);
      float* tile = terms + (sub & 1) * S::TERMS;
      ++sub;
#pragma unroll
      for (int q = SB - 1; q >= 0; --q) {
        const int r = r0 + q, t = ts0 + q;
        const float uv = su[r * CB + cl], dtv = su[UD + r * CB + cl],
                    dyv = su[2 * UD + r * CB + cl];
        const float4 b4 = *reinterpret_cast<const float4*>(
            sb + r * N + g * SPT);
        const float4 c4 = *reinterpret_cast<const float4*>(
            sb + BC + r * N + g * SPT);
        const float bv[SPT] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[SPT] = {c4.x, c4.y, c4.z, c4.w};
        const float dtu = dtv * uv;
        float v[NV], gb = 0.f, ga = 0.f;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          gr[j] = fmaf(dyv, cv[j], gr[j]);
          v[j] = gr[j] * dtu;                      // dB term
          v[SPT + j] = dyv * hh[q + 1][j];         // dC term
          gb = fmaf(gr[j], bv[j], gb);
          const float y = gr[j] * (ee[q][j] * hh[q][j]);
          ga = fmaf(av[j], y, ga);
          da[j] = fmaf(dtv, y, da[j]);
          gr[j] = ee[q][j] * gr[j];
        }
        // du = dt G.B and ddt = A (e h G) + u G.B over the channel's lanes
        const float dp = fmaf(uv, gb, ga);
        const bool live = on && t < t_len;
        const size_t o = (row0 + t) * d + dd;
        if constexpr (G == 1) {
          if (live) {
            du_o[o] = dtv * gb;
            ddt_o[o] = dp;
          }
        } else {
          const bool odd = g & 1;
          float x = (odd ? dp : gb)
                    + __shfl_xor_sync(0xffffffffu, odd ? gb : dp, 1);
#pragma unroll
          for (int off = 2; off < G; off <<= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          if (live && g < 2) (odd ? ddt_o : du_o)[o] = odd ? x : dtv * x;
        }
        // dB, dC over the warp's channels
        reduce_scatter<NV, S::RS, 0>(v, lane);
#pragma unroll
        for (int k = S::RS; k < S::RS + S::AR; ++k) {
#pragma unroll
          for (int i = 0; i < KEEP; ++i)
            v[i] += __shfl_xor_sync(0xffffffffu, v[i], 16 >> k);
        }
        if (writer) {
#pragma unroll
          for (int i = 0; i < KEEP; ++i) {
            const int idx = base + i;            // kind idx / 4, state j
            tile[(q * W + warp) * PW + idx / SPT * N + g * SPT + idx % SPT] =
                v[i];
          }
        }
      }
      BWD_PHASE(3);
      __syncthreads();                 // the tile written; the stage read
      BWD_PHASE(4);
      // a half read to its end: the next chunk's first half goes where
      // this chunk's second half was, its second half where the first was
      if (ch > 0 && m % (BWD_HS / SB) == 0)
        issue(m > 0 ? t0 - BWD_C : t0 - BWD_HS, p, ch - 1);
      // the sub-chunk's dB, dC: the block's warps summed in order, four
      // sums a thread (by the first SB * PW / 4 threads, while the others
      // go on to the next sub-chunk's history)
      for (int o = tid; o < SB * PW / 4; o += NT) {
        const int q = o / (PW / 4), k = o % (PW / 4) * 4, t = ts0 + q;
        const float4* src = reinterpret_cast<const float4*>(
            tile + q * W * PW + k);
        float4 sum = src[0];
#pragma unroll
        for (int w = 1; w < W; ++w) {
          const float4 x = src[w * PW / 4];
          sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
        }
        if (t < t_len)
          *reinterpret_cast<float4*>(
              (k < N ? dbp : dcp) + blockIdx.x * plane + (row0 + t) * N
              + k % N) = sum;
      }
      BWD_PHASE(5);
    }
    pl = pu;
  }
  if (on) {
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      dap[(static_cast<size_t>(blockIdx.y) * d + dd) * N + g * SPT + j] =
          da[j];
  }
#ifdef SSM_BWD_STAMPS
  if (tid == 0 && blockIdx.y == 0 && blockIdx.x < BWD_STAMP_BLOCKS) {
    for (int k = 0; k < BWD_PHASES; ++k)
      bwd_stamps[blockIdx.x * 8 + k] = phase_clk[k];
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    bwd_blocks[3 * blockIdx.x] = sm;
    bwd_blocks[3 * blockIdx.x + 1] = ns0;
    bwd_blocks[3 * blockIdx.x + 2] = global_ns();
  }
#endif
}

// dB, dC: the blocks' partials (plane floats each) summed in order; dA:
// the batch rows' partials (dn floats each) summed in order.
__global__ void __launch_bounds__(256)
ssm_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
               const float* __restrict__ dap, float* __restrict__ db,
               float* __restrict__ dc, float* __restrict__ da, long long plane,
               int nblk, int b, long long dn) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x
                          + threadIdx.x;
  for (long long q = first; q < 2 * plane; q += stride) {
    const bool is_c = q >= plane;
    const float* src = (is_c ? dcp : dbp) + (is_c ? q - plane : q);
    float s = __ldg(src);
    for (int k = 1; k < nblk; ++k) s += __ldg(src + k * plane);
    (is_c ? dc : db)[is_c ? q - plane : q] = s;
  }
  for (long long q = first; q < dn; q += stride) {
    float s = dap[q];
    for (int bb = 1; bb < b; ++bb) s += dap[bb * dn + q];
    da[q] = s;
  }
}

template <int N>
long long bwd_blocks_of(int d) {
  return (d + BwdShape<N>::CB - 1) / BwdShape<N>::CB;
}

template <int N>
cudaError_t launch_bwd(const float* u, const float* dt, const float* a,
                       const float* bm, const float* cm, const float* dy,
                       const float* hs, float* du, float* ddt, float* da,
                       float* db, float* dc, float* ws, int b, int t_len,
                       int d, cudaStream_t stream) {
  using S = BwdShape<N>;
  const int n_ck = (t_len + BWD_C - 1) / BWD_C - 1;
  const int nblk = static_cast<int>(bwd_blocks_of<N>(d));
  const long long plane = static_cast<long long>(b) * t_len * N;
  float* dbp = ws;
  float* dcp = dbp + nblk * plane;
  float* dap = dcp + nblk * plane;
  const bool vec_ud = d % 4 == 0 && aligned16(u) && aligned16(dt)
                      && aligned16(dy);
  const bool vec_bc = aligned16(bm) && aligned16(cm);
  const int bytes = S::SMEM_FLOATS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssm_bwd<N><<<dim3(nblk, b), S::NT, bytes, stream>>>(
      u, dt, a, bm, cm, dy, hs, du, ddt, dbp, dcp, dap, t_len, d, n_ck,
      vec_ud, vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long want = (2 * plane + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ssm_bwd_reduce<<<blocks, 256, 0, stream>>>(
      dbp, dcp, dap, db, dc, da, plane, nblk, b,
      static_cast<long long>(d) * N);
  return cudaGetLastError();
}

cudaError_t launch_bwd_n(int n, const float* u, const float* dt,
                         const float* a, const float* bm, const float* cm,
                         const float* dy, const float* hs, float* du,
                         float* ddt, float* da, float* db, float* dc,
                         float* ws, int b, int t_len, int d, cudaStream_t s) {
  switch (n) {
    case 4: return launch_bwd<4>(u, dt, a, bm, cm, dy, hs, du, ddt, da, db,
                                 dc, ws, b, t_len, d, s);
    case 8: return launch_bwd<8>(u, dt, a, bm, cm, dy, hs, du, ddt, da, db,
                                 dc, ws, b, t_len, d, s);
    case 16: return launch_bwd<16>(u, dt, a, bm, cm, dy, hs, du, ddt, da, db,
                                   dc, ws, b, t_len, d, s);
    case 32: return launch_bwd<32>(u, dt, a, bm, cm, dy, hs, du, ddt, da, db,
                                   dc, ws, b, t_len, d, s);
    case 64: return launch_bwd<64>(u, dt, a, bm, cm, dy, hs, du, ddt, da, db,
                                   dc, ws, b, t_len, d, s);
    default: return cudaErrorInvalidValue;
  }
}

long long bwd_partial_blocks(int d, int n) {
  switch (n) {
    case 4: return bwd_blocks_of<4>(d);
    case 8: return bwd_blocks_of<8>(d);
    case 16: return bwd_blocks_of<16>(d);
    case 32: return bwd_blocks_of<32>(d);
    case 64: return bwd_blocks_of<64>(d);
    default: return -1;
  }
}

int bwd_smem_bytes(int n) {
  switch (n) {
    case 4: return BwdShape<4>::SMEM_FLOATS * 4;
    case 8: return BwdShape<8>::SMEM_FLOATS * 4;
    case 16: return BwdShape<16>::SMEM_FLOATS * 4;
    case 32: return BwdShape<32>::SMEM_FLOATS * 4;
    case 64: return BwdShape<64>::SMEM_FLOATS * 4;
    default: return -1;
  }
}

long long states_floats(int b, int t_len, int d, int n) {
  const long long n_ck = (t_len + BWD_C - 1) / BWD_C - 1;
  return static_cast<long long>(b) * n_ck * d * n;
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
  if (b <= 0 || b > 65535 || t_len <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  switch (dtype) {
    case 0: return static_cast<int>(launch_n<float>(
        n, u, dt, af, bm, cm, y, nullptr, b, t_len, d, s));
    case 1: return static_cast<int>(launch_n<__nv_bfloat16>(
        n, u, dt, af, bm, cm, y, nullptr, b, t_len, d, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of the backward's checkpoints, h after every BWD_C steps but the
// last: (b, ceil(t_len / BWD_C) - 1, d, n).
long long ssm_scan_states_floats(int b, int t_len, int d, int n) {
  return states_floats(b, t_len, d, n);
}

// ssm_scan_launch for fp32 that also writes the checkpoints into hs (fp32,
// hs_floats >= ssm_scan_states_floats(b, t_len, d, n), 16-byte aligned;
// unread when that is 0): the forward a gradient needs.
int ssm_scan_fwd_states_launch(const void* u, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* hs, long long hs_floats, int b,
                               int t_len, int d, int n, void* stream) {
  if (b <= 0 || b > 65535 || t_len <= 0 || d <= 0
      || hs_floats < states_floats(b, t_len, d, n))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_n<float, true>(
      n, u, dt, static_cast<const float*>(a), bm, cm, y,
      static_cast<float*>(hs), b, t_len, d,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory (bytes) of one block at state dim n and dtype
// (0 fp32, 1 bf16); -1 if n is not built.
int ssm_scan_smem_bytes(int n, int dtype) {
  return dtype == 0 ? smem_bytes<float>(n) : smem_bytes<__nv_bfloat16>(n);
}

// Dynamic shared memory (bytes) of one ssm_bwd block at state dim n; -1
// if n is not built.
int ssm_scan_bwd_smem_bytes(int n) { return bwd_smem_bytes(n); }

// Floats of the fp32 workspace the backward needs: a (b, t_len, n) dB and
// a dC partial per block of channels; a (d, n) dA partial per batch row.
// -1 if n is not built.
long long ssm_scan_bwd_workspace_floats(int b, int t_len, int d, int n) {
  const long long nblk = bwd_partial_blocks(d, n);
  if (nblk < 0) return -1;
  return 2 * nblk * b * t_len * n + static_cast<long long>(b) * d * n;
}

// Launches the backward (ssm_bwd, ssm_bwd_reduce) on `stream` and returns
// the cudaError_t of the launch (0 on success).  fp32 only.  u, dt, dy,
// du, ddt: (b, t_len, d) contiguous; a, da: (d, n); bm, cm, db, dc: (b,
// t_len, n); hs: the checkpoints ssm_scan_fwd_states_launch wrote; ws:
// fp32 workspace of ws_floats >= ssm_scan_bwd_workspace_floats(b, t_len,
// d, n) floats, 16-byte aligned.
int ssm_scan_bwd_launch(const void* u, const void* dt, const void* a,
                        const void* bm, const void* cm, const void* dy,
                        const void* hs, void* du, void* ddt, void* da,
                        void* db, void* dc, void* ws, long long ws_floats,
                        int b, int t_len, int d, int n, void* stream) {
  if (b <= 0 || b > 65535 || t_len <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need = ssm_scan_bwd_workspace_floats(b, t_len, d, n);
  if (need < 0 || ws_floats < need)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  return static_cast<int>(launch_bwd_n(
      n, f(u), f(dt), f(a), f(bm), f(cm), f(dy), f(hs), o(du), o(ddt),
      o(da), o(db), o(dc), o(ws), b, t_len, d,
      static_cast<cudaStream_t>(stream)));
}

// Copies the backward's phase clocks (see BWD_PHASE) into `out`
// (BWD_STAMP_BLOCKS * 8 long longs) and its blocks' SMs and times into
// `blocks` (3 * BWD_STAMP_BLOCKS); -1 in a build without -DSSM_BWD_STAMPS.
int ssm_scan_bwd_stamps(long long* out, unsigned long long* blocks) {
#ifdef SSM_BWD_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(out, bwd_stamps, sizeof(bwd_stamps));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(blocks, bwd_blocks, sizeof(bwd_blocks));
  return static_cast<int>(err);
#else
  (void)out;
  (void)blocks;
  return -1;
#endif
}

// The phases ssm_scan_bwd_stamps reports, comma-separated.
const char* ssm_scan_bwd_stamp_names() { return BWD_STAMP_NAMES; }

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
