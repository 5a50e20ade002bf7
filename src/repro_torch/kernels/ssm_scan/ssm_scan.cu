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

template <typename T, int N>
__global__ void __launch_bounds__(NT, 1)
ssm_fwd(const T* __restrict__ u, const T* __restrict__ dt,
        const float* __restrict__ a, const T* __restrict__ bm,
        const T* __restrict__ cm, T* __restrict__ y, int t_len, int d,
        bool vec_ud, bool vec_bc) {
  using S = Shape<T, N>;
  constexpr int SPT = S::SPT, G = S::G, CB = S::CB, TC = S::TC,
                UD = S::UD, BC = S::BC;
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

template <typename T, int N>
cudaError_t launch(const void* u, const void* dt, const float* a,
                   const void* bm, const void* cm, void* y, int b, int t_len,
                   int d, cudaStream_t stream) {
  using S = Shape<T, N>;
  constexpr int E = 16 / sizeof(T);           // elements a 16-byte piece
  const int bytes = S::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_fwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool vec_ud = d % E == 0 && aligned16(u) && aligned16(dt)
                      && aligned16(y);
  const bool vec_bc = N % E == 0 && aligned16(bm) && aligned16(cm);
  const dim3 grid((d + S::CB - 1) / S::CB, b);
  ssm_fwd<T, N><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), t_len, d, vec_ud, vec_bc);
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
//     ddt_t = sum_n G (A e_t h_{t-1} + B_t u_t)
//     dA   += G dt_t e_t h_{t-1}       (summed over b and t)
//     G     = e_t G
//
// Three launches.  `ssm_bwd_state` steps h forward as the forward does
// and writes it after every BWD_C = 64 steps ((B, ceil(T/64) - 1, D, N)
// fp32, 67 MB at the jamba shape): the forward's no-grad launch stays as
// it is, and the backward pays one more read of u, dt, B and T*D*N exps.
// `ssm_bwd` walks each lane's chunks from the last: from the chunk's
// saved h it steps forward once, keeping each sub-chunk's first state (8
// sub-chunks of BWD_SB = 8 steps) in shared memory, then per sub-chunk
// (last first) recomputes its 8 states into registers and walks them
// back.  h_{t-1} is never recovered by dividing by e_t (e_t is near 0 or
// near 1 in the model's and the long-memory regimes).  A thread keeps 4
// states of one channel (N / 4 lanes a channel, 128 / (N / 4) channels a
// block); du and ddt are summed over a channel's lanes by xor shuffles;
// each step's dB and dC terms go to shared memory and the block sums its
// channels in order once per sub-chunk into one partial per block; dA is
// summed over t in registers into one partial per batch row.
// `ssm_bwd_reduce` sums the blocks' dB and dC partials and the batch
// rows' dA in a fixed order.  No atomics: two calls agree bit for bit.
//
// What bounds it: at the jamba shape (B 1, T 4096, D 16384, N 16) the
// function moves 1.345 GB (0.402 ms at 3.35 TB/s) and needs 23.8 GFLOP and
// 1.07 G exps; this first kernel takes each exp four times (the state
// pass, the chunk walk, the sub-chunk's states, the reverse step) and
// reads its inputs straight from global memory (PERF.md §6).
constexpr int BWD_NT = 128;          // threads a block
constexpr int BWD_SPT = 4;           // states a lane
constexpr int BWD_C = 64;            // steps between saved states
constexpr int BWD_SB = 8;            // steps a sub-chunk
constexpr int BWD_NSB = BWD_C / BWD_SB;

template <int N> struct BwdShape {
  static constexpr int G = N / BWD_SPT;      // lanes a channel
  static constexpr int CB = BWD_NT / G;      // channels a block
  // dB and dC terms (BWD_SB x CB x N each), then the sub-chunks' first
  // states (BWD_NSB x BWD_NT x BWD_SPT)
  static constexpr int SMEM_FLOATS =
      2 * BWD_SB * CB * N + BWD_NSB * BWD_NT * BWD_SPT;
  static_assert(N % BWD_SPT == 0 && G <= 32, "unsupported N");
};

// one forward step of a lane's BWD_SPT states
__device__ __forceinline__ void bwd_step(float* h, const float* av, float dtv,
                                         float uv, const float* bv) {
  const float du = dtv * uv;
#pragma unroll
  for (int j = 0; j < BWD_SPT; ++j)
    h[j] = fmaf(expf(dtv * av[j]), h[j], bv[j] * du);
}

// h after every full chunk but the last: hs (B, n_ck, D, N).
template <int N>
__global__ void __launch_bounds__(BWD_NT)
ssm_bwd_state(const float* __restrict__ u, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ bm,
              float* __restrict__ hs, int t_len, int d, int n_ck) {
  using S = BwdShape<N>;
  const int cl = threadIdx.x / S::G, g = threadIdx.x % S::G;
  const int dd = blockIdx.x * S::CB + cl;
  if (dd >= d) return;                       // no shuffles, no barriers
  const size_t row0 = static_cast<size_t>(blockIdx.y) * t_len;
  float av[BWD_SPT], h[BWD_SPT];
#pragma unroll
  for (int j = 0; j < BWD_SPT; ++j) {
    av[j] = a[static_cast<size_t>(dd) * N + g * BWD_SPT + j];
    h[j] = 0.f;
  }
  for (int c = 0; c < n_ck; ++c) {
#pragma unroll 8
    for (int q = 0; q < BWD_C; ++q) {
      const size_t p = row0 + c * BWD_C + q;
      float bv[BWD_SPT];
#pragma unroll
      for (int j = 0; j < BWD_SPT; ++j)
        bv[j] = __ldg(bm + p * N + g * BWD_SPT + j);
      bwd_step(h, av, __ldg(dt + p * d + dd), __ldg(u + p * d + dd), bv);
    }
    float* out = hs + ((static_cast<size_t>(blockIdx.y) * n_ck + c) * d + dd)
                 * N + g * BWD_SPT;
#pragma unroll
    for (int j = 0; j < BWD_SPT; ++j) out[j] = h[j];
  }
}

// dbp, dcp: one (B, T, N) partial per block of channels (blockIdx.x);
// dap: one (D, N) partial per batch row.
template <int N>
__global__ void __launch_bounds__(BWD_NT)
ssm_bwd(const float* __restrict__ u, const float* __restrict__ dt,
        const float* __restrict__ a, const float* __restrict__ bm,
        const float* __restrict__ cm, const float* __restrict__ dy,
        const float* __restrict__ hs, float* __restrict__ du_o,
        float* __restrict__ ddt_o, float* __restrict__ dbp,
        float* __restrict__ dcp, float* __restrict__ dap, int t_len, int d,
        int n_ck) {
  using S = BwdShape<N>;
  constexpr int G = S::G, CB = S::CB, SB = BWD_SB;
  extern __shared__ float4 smem4[];
  float* tb = reinterpret_cast<float*>(smem4);   // dB terms [SB][CB][N]
  float* tc = tb + SB * CB * N;                   // dC terms
  float* st = tc + SB * CB * N;                   // [NSB][NT][SPT]

  const int tid = threadIdx.x, cl = tid / G, g = tid % G;
  const int dd = blockIdx.x * CB + cl;
  const bool on = dd < d;                          // a channel past D: zeros
  const size_t row0 = static_cast<size_t>(blockIdx.y) * t_len;
  const size_t plane = static_cast<size_t>(gridDim.y) * t_len * N;
  float av[BWD_SPT], gr[BWD_SPT], da[BWD_SPT];
#pragma unroll
  for (int j = 0; j < BWD_SPT; ++j) {
    av[j] = on ? a[static_cast<size_t>(dd) * N + g * BWD_SPT + j] : 0.f;
    gr[j] = da[j] = 0.f;
  }
  auto load = [&](const float* x, size_t p) {
    return on ? __ldg(x + p * d + dd) : 0.f;
  };
  auto load_bc = [&](const float* x, size_t p, float* out) {
#pragma unroll
    for (int j = 0; j < BWD_SPT; ++j)
      out[j] = __ldg(x + p * N + g * BWD_SPT + j);
  };

  for (int ch = n_ck; ch >= 0; --ch) {
    const int t0 = ch * BWD_C;
    float h[BWD_SPT];
#pragma unroll
    for (int j = 0; j < BWD_SPT; ++j)
      h[j] = ch > 0 && on
                 ? hs[((static_cast<size_t>(blockIdx.y) * n_ck + ch - 1) * d
                       + dd) * N + g * BWD_SPT + j]
                 : 0.f;
    // each sub-chunk's first state, stepping forward through the chunk
    for (int m = 0; m < BWD_NSB; ++m) {
      *reinterpret_cast<float4*>(st + (m * BWD_NT + tid) * BWD_SPT) =
          make_float4(h[0], h[1], h[2], h[3]);
      if (m + 1 < BWD_NSB) {
#pragma unroll
        for (int q = 0; q < SB; ++q) {
          const int t = t0 + m * SB + q;
          if (t < t_len) {
            float bv[BWD_SPT];
            load_bc(bm, row0 + t, bv);
            bwd_step(h, av, load(dt, row0 + t), load(u, row0 + t), bv);
          }
        }
      }
    }
    for (int m = BWD_NSB - 1; m >= 0; --m) {
      const int ts0 = t0 + m * SB;
      if (ts0 >= t_len) continue;               // the same for every thread
      float hist[SB + 1][BWD_SPT];              // h_{ts0 - 1} .. h_{ts0 + SB - 1}
      {
        const float4 x = *reinterpret_cast<const float4*>(
            st + (m * BWD_NT + tid) * BWD_SPT);
        hist[0][0] = x.x; hist[0][1] = x.y; hist[0][2] = x.z; hist[0][3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < SB; ++q) {
#pragma unroll
        for (int j = 0; j < BWD_SPT; ++j) hist[q + 1][j] = hist[q][j];
        const int t = ts0 + q;
        if (t < t_len) {
          float bv[BWD_SPT];
          load_bc(bm, row0 + t, bv);
          bwd_step(hist[q + 1], av, load(dt, row0 + t), load(u, row0 + t),
                   bv);
        }
      }
#pragma unroll
      for (int q = SB - 1; q >= 0; --q) {
        const int t = ts0 + q;
        if (t >= t_len) continue;               // the same for every thread
        const size_t p = row0 + t;
        const float dtv = load(dt, p), uv = load(u, p), dyv = load(dy, p);
        float bv[BWD_SPT], cv[BWD_SPT], xb[BWD_SPT], xc[BWD_SPT];
        load_bc(bm, p, bv);
        load_bc(cm, p, cv);
        const float dtu = dtv * uv;
        float acc_du = 0.f, acc_ddt = 0.f;
#pragma unroll
        for (int j = 0; j < BWD_SPT; ++j) {
          gr[j] = fmaf(dyv, cv[j], gr[j]);
          xc[j] = dyv * hist[q + 1][j];
          xb[j] = gr[j] * dtu;
          acc_du = fmaf(gr[j], bv[j], acc_du);
          const float e = expf(dtv * av[j]);
          const float x = e * hist[q][j];
          acc_ddt = fmaf(gr[j], fmaf(av[j], x, bv[j] * uv), acc_ddt);
          da[j] = fmaf(gr[j] * dtv, x, da[j]);
          gr[j] = e * gr[j];
        }
#pragma unroll
        for (int off = 1; off < G; off <<= 1) {
          acc_du += __shfl_xor_sync(0xffffffffu, acc_du, off);
          acc_ddt += __shfl_xor_sync(0xffffffffu, acc_ddt, off);
        }
        if (on && g == 0) {
          du_o[p * d + dd] = dtv * acc_du;
          ddt_o[p * d + dd] = acc_ddt;
        }
        const int o = (q * CB + cl) * N + g * BWD_SPT;
        *reinterpret_cast<float4*>(tb + o) =
            make_float4(xb[0], xb[1], xb[2], xb[3]);
        *reinterpret_cast<float4*>(tc + o) =
            make_float4(xc[0], xc[1], xc[2], xc[3]);
      }
      __syncthreads();
      // dB and dC of the sub-chunk: the block's channels summed in order
      for (int idx = tid; idx < 2 * SB * N; idx += BWD_NT) {
        const int which = idx / (SB * N), q = idx % (SB * N) / N,
                  n = idx % N, t = ts0 + q;
        if (t < t_len) {
          const float* src = (which ? tc : tb) + q * CB * N + n;
          float sum = 0.f;
          for (int c2 = 0; c2 < CB; ++c2) sum += src[c2 * N];
          (which ? dcp : dbp)[blockIdx.x * plane + (row0 + t) * N + n] = sum;
        }
      }
      __syncthreads();
    }
  }
  if (on) {
#pragma unroll
    for (int j = 0; j < BWD_SPT; ++j)
      dap[(static_cast<size_t>(blockIdx.y) * d + dd) * N + g * BWD_SPT + j] =
          da[j];
  }
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
cudaError_t launch_bwd(const float* u, const float* dt, const float* a,
                       const float* bm, const float* cm, const float* dy,
                       float* du, float* ddt, float* da, float* db, float* dc,
                       float* ws, int b, int t_len, int d,
                       cudaStream_t stream) {
  using S = BwdShape<N>;
  const int n_ck = (t_len + BWD_C - 1) / BWD_C - 1;
  const int nblk = (d + S::CB - 1) / S::CB;
  const long long plane = static_cast<long long>(b) * t_len * N;
  float* hs = ws;
  float* dbp = hs + static_cast<long long>(b) * n_ck * d * N;
  float* dcp = dbp + nblk * plane;
  float* dap = dcp + nblk * plane;
  const dim3 grid(nblk, b);
  cudaError_t err;
  if (n_ck > 0) {
    ssm_bwd_state<N><<<grid, BWD_NT, 0, stream>>>(u, dt, a, bm, hs, t_len, d,
                                                  n_ck);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int bytes = S::SMEM_FLOATS * 4;
  err = cudaFuncSetAttribute(ssm_bwd<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  ssm_bwd<N><<<grid, BWD_NT, bytes, stream>>>(
      u, dt, a, bm, cm, dy, hs, du, ddt, dbp, dcp, dap, t_len, d, n_ck);
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
                         const float* dy, float* du, float* ddt, float* da,
                         float* db, float* dc, float* ws, int b, int t_len,
                         int d, cudaStream_t s) {
  switch (n) {
    case 4: return launch_bwd<4>(u, dt, a, bm, cm, dy, du, ddt, da, db, dc,
                                 ws, b, t_len, d, s);
    case 8: return launch_bwd<8>(u, dt, a, bm, cm, dy, du, ddt, da, db, dc,
                                 ws, b, t_len, d, s);
    case 16: return launch_bwd<16>(u, dt, a, bm, cm, dy, du, ddt, da, db, dc,
                                   ws, b, t_len, d, s);
    case 32: return launch_bwd<32>(u, dt, a, bm, cm, dy, du, ddt, da, db, dc,
                                   ws, b, t_len, d, s);
    case 64: return launch_bwd<64>(u, dt, a, bm, cm, dy, du, ddt, da, db, dc,
                                   ws, b, t_len, d, s);
    default: return cudaErrorInvalidValue;
  }
}

long long bwd_partial_blocks(int d, int n) {
  switch (n) {
    case 4: return (d + BwdShape<4>::CB - 1) / BwdShape<4>::CB;
    case 8: return (d + BwdShape<8>::CB - 1) / BwdShape<8>::CB;
    case 16: return (d + BwdShape<16>::CB - 1) / BwdShape<16>::CB;
    case 32: return (d + BwdShape<32>::CB - 1) / BwdShape<32>::CB;
    case 64: return (d + BwdShape<64>::CB - 1) / BwdShape<64>::CB;
    default: return -1;
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
  if (b <= 0 || b > 65535 || t_len <= 0 || d <= 0)
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

// Dynamic shared memory (bytes) of one block at state dim n and dtype
// (0 fp32, 1 bf16); -1 if n is not built.
int ssm_scan_smem_bytes(int n, int dtype) {
  return dtype == 0 ? smem_bytes<float>(n) : smem_bytes<__nv_bfloat16>(n);
}

// Floats of the fp32 workspace the backward needs: h every BWD_C steps
// (b, ceil(t_len / BWD_C) - 1, d, n); a (b, t_len, n) dB and a dC partial
// per block of channels; a (d, n) dA partial per batch row.  -1 if n is
// not built.
long long ssm_scan_bwd_workspace_floats(int b, int t_len, int d, int n) {
  const long long nblk = bwd_partial_blocks(d, n);
  if (nblk < 0) return -1;
  const long long n_ck = (t_len + BWD_C - 1) / BWD_C - 1;
  return static_cast<long long>(b) * n_ck * d * n
         + 2 * nblk * b * t_len * n + static_cast<long long>(b) * d * n;
}

// Launches the backward (ssm_bwd_state, ssm_bwd, ssm_bwd_reduce) on
// `stream` and returns the cudaError_t of the launch (0 on success).
// fp32 only.  u, dt, dy, du, ddt: (b, t_len, d) contiguous; a, da: (d, n);
// bm, cm, db, dc: (b, t_len, n); ws: fp32 workspace of ws_floats >=
// ssm_scan_bwd_workspace_floats(b, t_len, d, n) floats, 16-byte aligned.
int ssm_scan_bwd_launch(const void* u, const void* dt, const void* a,
                        const void* bm, const void* cm, const void* dy,
                        void* du, void* ddt, void* da, void* db, void* dc,
                        void* ws, long long ws_floats, int b, int t_len,
                        int d, int n, void* stream) {
  if (b <= 0 || b > 65535 || t_len <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need = ssm_scan_bwd_workspace_floats(b, t_len, d, n);
  if (need < 0 || ws_floats < need)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  return static_cast<int>(launch_bwd_n(
      n, f(u), f(dt), f(a), f(bm), f(cm), f(dy), o(du), o(ddt), o(da),
      o(db), o(dc), o(ws), b, t_len, d, static_cast<cudaStream_t>(stream)));
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
