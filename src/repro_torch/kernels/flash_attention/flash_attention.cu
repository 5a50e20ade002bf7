// Flash-attention forward (online softmax) on Hopper (sm_90a), on the
// tensor cores through warp-level mma.sync.
//
// Replaces the TPU Pallas kernel `_fa_kernel` / `flash_attention_fwd` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: for each
// (batch, head) and query row, o = softmax(q k^T * scale [causal mask]) v,
// computed tile by tile with a running max m, running sum l and an fp32
// accumulator, masked scores set to NEG_INF = -1e30 and the result divided
// by max(l, 1e-30).  Inputs fp32 or bf16, head dim 16, 32, 64 or 128; the
// output is written in the input type.
//
// Layout: q, o are (B, Sq, H, hd) and k, v are (B, Sk, KVH, hd), contiguous,
// as the model's projections leave them: the kernel computes its own
// offsets, and for grouped-query attention query head h reads KV head
// h / (H / KVH) in place.  Ragged Sq and Sk are masked.
//
// What bounds it on an H100: at the llama3.2-1b prefill shape (B 2, S 4096,
// H 32, hd 64, causal) the function is ~137 GFLOP against ~170 MB of
// traffic, so it is bound by operations, and only the tensor cores give
// the rate.  bf16 runs one m16n8k16 bf16 product per tile (989 TFLOP/s
// peak).  fp32 must stay within 2e-5 of fp32 arithmetic, which one TF32
// product (10-bit mantissa) misses by ~80x; so each fp32 operand x is split
// into big = x rounded to TF32 and small = (x - big) truncated to TF32, and
// each product is three m16n8k8 TF32 products, small*big + big*small +
// big*big, accumulated in fp32: 3x the operations at the 495 TFLOP/s TF32
// peak (0.83 ms at that shape), still 2.5x the 67 TFLOP/s of fp32 FMA.
//
// Design (FA2 on mma.sync): a block is 4 warps and 64 query rows, 16 rows
// a warp; K and V tiles of BK keys are staged in shared memory by 16-byte
// cp.async copies, double-buffered so that the next tile's copy is in
// flight while the current one computes.  The scores stay in the mma
// accumulators: each thread holds 2 rows of its warp's 16, so a row's max
// and sum take two quad shuffles.  Because the contraction index of a
// product may be permuted as long as both operands are permuted alike,
// the kernel picks the order that makes every fragment a plain load:
// - Q k^T: head-dim index d is read in the order that puts a thread's A
//   and B elements next to each other, so Q fragments (in registers, or
//   at fp32 hd 128 in shared memory) and K fragments are 8-byte loads;
// - P V: in fp32 the key order k8 index t <-> key 2t, t + 4 <-> key 2t + 1
//   makes the score accumulator (c0, c1, c2, c3) the A fragment
//   (c0, c2, c1, c3) as it stands, with V read at those keys; in bf16 two
//   adjacent n8 score tiles packed to bf16x2 are the k16 A fragment as
//   they stand, and V's B fragments come from ldmatrix.trans.
// The split is done with integer operations: cvt.rna.tf32.f32 compiles to
// a long emulated sequence on sm_90a (compare, select and multiply-add
// instructions in the SASS).
// fp32 P V sums each tile in an accumulator of its own (see add_pv).  Row
// strides are padded so that each fragment load hits 32 distinct banks.
// Causal tiles above the diagonal are skipped, masking is applied only in
// tiles that cross the diagonal or the end of the keys, and the grid is
// walked from the last query tile down so that the longest blocks start
// first.  exp is ex2.approx on scores pre-scaled by log2(e).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                   // query rows per block
constexpr int kThreads = 128;             // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Per-dtype tile shape.  BK: keys per tile (32 at fp32 hd 128, where 64
// would leave one block per SM for lack of shared memory).  KST / VST:
// row strides (elements) of the K and V tiles, padded so that the K
// fragment loads (8 bytes: 4 rows x 4 lanes a half-warp) and the V loads
// (fp32: 8 rows x 4 lanes, bf16: ldmatrix, 8 rows of 16 bytes) are free of
// bank conflicts; every row stays 16-byte aligned for cp.async.
template <typename T, int HD> struct Tile;
template <int HD> struct Tile<float, HD> {
  static constexpr int BK = HD == 128 ? 32 : 64;
  static constexpr int KST = HD + 8;      // stride = 8 (mod 32) words
  static constexpr int VST = HD + 4;      // stride = 4 (mod 32) words
  // Q's fragments live in registers (the compiler keeps their split there
  // too, HD registers) up to hd 64; at hd 128 that and the output's two
  // accumulators would spill, so Q is staged raw in shared memory (row
  // stride KST) and split per use.
  static constexpr bool kQSmem = HD == 128;
};
template <int HD> struct Tile<__nv_bfloat16, HD> {
  static constexpr int BK = 64;
  static constexpr int KST = HD == 16 ? 16 : HD + 16;  // 8 or 24 (mod 32)
  static constexpr int VST = HD + 8;      // odd multiple of 16 bytes
  static constexpr bool kQSmem = false;
};

template <typename T, int HD>
constexpr size_t smem_bytes() {
  using C = Tile<T, HD>;
  return sizeof(T) * (2 * C::BK * (C::KST + C::VST)
                      + (C::kQSmem ? kBQ * C::KST : 0));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when `ok` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = big + small + O(2^-21 |x|): big is x rounded to TF32 (to nearest,
// ties away, as cvt.rna.tf32.f32, which the compiler would emulate with
// many more instructions), small the remainder truncated to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// d += a b: m16n8k8, A row-major tf32, B col-major tf32, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k16, A row-major bf16, B col-major bf16, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 b16 matrices; lane l gives the row address of
// matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Stage rows [k0, k0 + R) of one head into a tile of row stride ST; rows
// at or past n are zero (a key's score is masked, a zero V row times a
// zero probability stays 0, a query row is never stored).
template <typename T, int HD, int R, int ST>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t row_stride, int k0, int n,
                                          int tid) {
  constexpr int kEPC = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int kCPR = HD / kEPC;         // chunks per row
#pragma unroll
  for (int i = tid; i < R * kCPR; i += kThreads) {
    const int r = i / kCPR, c = i % kCPR;
    const bool ok = k0 + r < n;
    const T* g = ok ? src + static_cast<size_t>(k0 + r) * row_stride
                          + c * kEPC
                    : src;
    cp_async16(dst + r * ST + c * kEPC, g, ok);
  }
}

// Q fragments for the block's lifetime.  fp32: q[s] is the m16n8k8 A
// fragment of head-dim step s with k index t <-> d 8s + 2t and t + 4 <->
// d 8s + 2t + 1 (raw fp32, split per use).  bf16: q[s] is the m16n8k16 A
// fragment of step s with k indices 2t, 2t+1, 2t+8, 2t+9 <-> d 16s + 4t ..
// 16s + 4t + 3.  K fragments below use the same orders.
template <typename T, int HD> struct QFrag;
template <int HD> struct QFrag<float, HD> {
  static constexpr bool kSmem = Tile<float, HD>::kQSmem;
  float q[kSmem ? 1 : HD / 8][4];
  const float* qs;                        // the thread's row g (kSmem)
  __device__ __forceinline__ void load(const float* row0, const float* row1,
                                       int t) {
    if constexpr (!kSmem) {
#pragma unroll
      for (int s = 0; s < HD / 8; ++s) {
        const float2 a = row0 ? *reinterpret_cast<const float2*>(
                                    row0 + 8 * s + 2 * t)
                              : make_float2(0.f, 0.f);
        const float2 b = row1 ? *reinterpret_cast<const float2*>(
                                    row1 + 8 * s + 2 * t)
                              : make_float2(0.f, 0.f);
        q[s][0] = a.x; q[s][1] = b.x; q[s][2] = a.y; q[s][3] = b.y;
      }
    }
  }
  __device__ __forceinline__ void fragment(int s, float (&x)[4]) const {
    if constexpr (kSmem) {
      constexpr int KST = Tile<float, HD>::KST;
      const float2 a = *reinterpret_cast<const float2*>(qs + 8 * s);
      const float2 b = *reinterpret_cast<const float2*>(qs + 8 * KST + 8 * s);
      x[0] = a.x; x[1] = b.x; x[2] = a.y; x[3] = b.y;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = q[s][i];
    }
  }
};
template <int HD> struct QFrag<__nv_bfloat16, HD> {
  uint32_t q[HD / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* row0,
                                       const __nv_bfloat16* row1, int t) {
#pragma unroll
    for (int s = 0; s < HD / 16; ++s) {
      const uint2 a = row0 ? *reinterpret_cast<const uint2*>(
                                 row0 + 16 * s + 4 * t)
                           : make_uint2(0u, 0u);
      const uint2 b = row1 ? *reinterpret_cast<const uint2*>(
                                 row1 + 16 * s + 4 * t)
                           : make_uint2(0u, 0u);
      q[s][0] = a.x; q[s][1] = b.x; q[s][2] = a.y; q[s][3] = b.y;
    }
  }
};

// sc[j] += Q K^T for keys 8j .. 8j + 7 of the tile (C fragment: c0, c1 =
// row g, keys 2t, 2t + 1; c2, c3 = row g + 8).
template <int HD, int BK>
__device__ __forceinline__ void scores(const QFrag<float, HD>& qf,
                                       const float* kt, float (&sc)[BK / 8][4],
                                       int g, int t) {
  constexpr int KST = Tile<float, HD>::KST;
#pragma unroll
  for (int s = 0; s < HD / 8; ++s) {
    float x[4];
    qf.fragment(s, x);
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], ab[i], as[i]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 kk = *reinterpret_cast<const float2*>(
          kt + (8 * j + g) * KST + 8 * s + 2 * t);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(kk.x, bb0, bs0);
      split_tf32(kk.y, bb1, bs1);
      mma_tf32(sc[j], as, bb0, bb1);      // the small terms first
      mma_tf32(sc[j], ab, bs0, bs1);
      mma_tf32(sc[j], ab, bb0, bb1);
    }
  }
}

template <int HD, int BK>
__device__ __forceinline__ void scores(const QFrag<__nv_bfloat16, HD>& qf,
                                       const __nv_bfloat16* kt,
                                       float (&sc)[BK / 8][4], int g, int t) {
  constexpr int KST = Tile<__nv_bfloat16, HD>::KST;
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint2 kk = *reinterpret_cast<const uint2*>(
          kt + (8 * j + g) * KST + 16 * s + 4 * t);
      mma_bf16(sc[j], qf.q[s], kk.x, kk.y);
    }
  }
}

// acc[n] += P V for head-dim columns 8n .. 8n + 7; p holds the tile's
// probabilities in the score layout.  The tile's products are summed in an
// accumulator of their own and added to acc once: the tensor cores do not
// round their fp32 sums to nearest, and a running sum fed to every mma of
// the row gathers that bias over the whole row.
template <int HD, int BK>
__device__ __forceinline__ void add_pv(const float (&p)[BK / 8][4],
                                       const float* vt, float (&acc)[HD / 8][4],
                                       int lane) {
  constexpr int VST = Tile<float, HD>::VST;
  const int g = lane >> 2, t = lane & 3;
  float tile[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) tile[n][i] = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
    const float* v0 = vt + (8 * j + 2 * t) * VST + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(v0[8 * n], bb0, bs0);
      split_tf32(v0[VST + 8 * n], bb1, bs1);
      mma_tf32(tile[n], as, bb0, bb1);
      mma_tf32(tile[n], ab, bs0, bs1);
      mma_tf32(tile[n], ab, bb0, bb1);
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += tile[n][i];
}

template <int HD, int BK>
__device__ __forceinline__ void add_pv(const float (&p)[BK / 8][4],
                                       const __nv_bfloat16* vt,
                                       float (&acc)[HD / 8][4], int lane) {
  constexpr int VST = Tile<__nv_bfloat16, HD>::VST;
  // ldmatrix row address: matrix m = lane / 8 covers keys (m & 1) * 8 ..
  // and columns (m >> 1) * 8 .. of a 16 x 16 block
  const __nv_bfloat16* vrow =
      vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * VST + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < BK / 16; ++s) {
    const uint32_t a[4] = {pack_bf16(p[2 * s][0], p[2 * s][1]),
                           pack_bf16(p[2 * s][2], p[2 * s][3]),
                           pack_bf16(p[2 * s + 1][0], p[2 * s + 1][1]),
                           pack_bf16(p[2 * s + 1][2], p[2 * s + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vrow + 16 * s * VST + 16 * np);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int HD>
// The minimum of one block per SM is stated: with it ptxas gives the bf16
// instantiations more registers (as many blocks fit an SM either way), and
// they run faster; the fp32 ones do not change.
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
       int sq, int sk, int h, int kvh, float scale_log2, int causal) {
  using C = Tile<T, HD>;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 8;              // n8 score tiles per key tile
  constexpr int ND = HD / 8;              // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);     // [2][BK][KST]
  T* vs = ks + 2 * BK * C::KST;           // [2][BK][VST]
  T* qs = vs + 2 * BK * C::VST;           // [kBQ][KST] if C::kQSmem

  const int qt_idx = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int q0 = qt_idx * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int kh = hh / (h / kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 16 * warp;         // the warp's first row
  const int row0 = wq0 + g, row1 = row0 + 8;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const T* qb = q + static_cast<size_t>(b) * sq * q_stride + hh * HD;
  const T* kb = k + static_cast<size_t>(b) * sk * kv_stride + kh * HD;
  const T* vb = v + static_cast<size_t>(b) * sk * kv_stride + kh * HD;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  load_tile<T, HD, BK, C::KST>(ks, kb, kv_stride, 0, sk, tid);
  load_tile<T, HD, BK, C::VST>(vs, vb, kv_stride, 0, sk, tid);
  QFrag<T, HD> qf;                        // rows >= sq are zeros
  if constexpr (C::kQSmem) {
    load_tile<T, HD, kBQ, C::KST>(qs, qb, q_stride, q0, sq, tid);
    qf.qs = qs + (16 * warp + g) * C::KST + 2 * t;
  } else {
    qf.load(row0 < sq ? qb + static_cast<size_t>(row0) * q_stride : nullptr,
            row1 < sq ? qb + static_cast<size_t>(row1) * q_stride : nullptr,
            t);
  }
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {               // next tile in flight
      const int nb = (it + 1) & 1;
      load_tile<T, HD, BK, C::KST>(ks + nb * BK * C::KST, kb, kv_stride,
                                   k0 + BK, sk, tid);
      load_tile<T, HD, BK, C::VST>(vs + nb * BK * C::VST, vb, kv_stride,
                                   k0 + BK, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + (it & 1) * BK * C::KST;
    const T* vt = vs + (it & 1) * BK * C::VST;

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
    scores<HD, BK>(qf, kt, sc, g, t);

    // scale to the log2 domain; mask only where the tile crosses the end
    // of the keys or (causal) the warp's diagonal
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > wq0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[j][i] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          if (key >= sk || (causal && key > row)) x = kNegInf;
        }
        sc[j][i] = x;
      }

    // online softmax: rows g (r = 0) and g + 8 (r = 1); a row lives in
    // one quad, so its max takes two shuffles.  l is this thread's
    // partial sum, reduced over the quad once at the end.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mt = fmaxf(mt, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[r], mt);
      const float corr = ex2(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[j][2 * r] = ex2(sc[j][2 * r] - m_new);
        sc[j][2 * r + 1] = ex2(sc[j][2 * r + 1] - m_new);
        rs += sc[j][2 * r] + sc[j][2 * r + 1];
      }
      l[r] = l[r] * corr + rs;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    add_pv<HD, BK>(sc, vt, acc, lane);
    __syncthreads();                      // the tile is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = r ? row1 : row0;
    if (row < sq) {
      const float den = fmaxf(lt, 1e-30f);
      T* orow = o + (static_cast<size_t>(b) * sq + row) * q_stride + hh * HD;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store2(orow + 8 * n + 2 * t, acc[n][2 * r] / den,
               acc[n][2 * r + 1] / den);
      // the row's log-sum-exp of the natural-log scores, for the backward
      if (lse != nullptr && t == 0)
        lse[static_cast<size_t>(bh) * sq + row] = m[r] * kLn2 + logf(den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int h, int kvh,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  fa_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h, kvh,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, float* lse, int b, int sq, int sk, int h,
                      int kvh, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, sq, sk, h, kvh, scale,
                                  causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, sq, sk, h, kvh, scale,
                                  causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, sk, h, kvh, scale,
                                  causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, sk, h, kvh,
                                    scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_hd(int hd) {
  switch (hd) {
    case 16: return static_cast<int>(smem_bytes<T, 16>());
    case 32: return static_cast<int>(smem_bytes<T, 32>());
    case 64: return static_cast<int>(smem_bytes<T, 64>());
    case 128: return static_cast<int>(smem_bytes<T, 128>());
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// Backward (FA2): given q, k, v, the forward's o and lse, and dO, computes
// dq, dk, dv in the input type with fp32 accumulation.  With P = exp(S -
// lse), S = q k^T * scale (masked entries have P = 0) and D = rowsum(dO o):
//   dV = P^T dO,   dP = dO V^T,   dS = P (dP - D),
//   dQ = scale dS K,   dK = scale dS^T Q.
// Three kernels on the stream, every product on the tensor cores through
// mma.sync (fp32: three TF32 m16n8k8 products of split operands, as in the
// forward; bf16: one m16n8k16 product, P and dS rounded to bf16):
// - fa_bwd_dot: D, one warp a row.
// - fa_bwd_dkdv: a block per (b, KV head, 64 keys), 4 warps of 16 keys.
//   For each query tile of each query head of the GQA group it computes
//   S^T = K Q^T and dP^T = V dO^T (the forward's `scores` shape, keys as
//   M, K and V the A fragments: in registers, or at fp32 hd >= 64 and at hd
//   128 in shared memory), P^T = exp2(S^T scale log2e - lse) and dS^T =
//   P^T (dP^T - D) (lse and D indexed by the column, staged per tile), then
//   dV += P^T dO and dK += dS^T Q (the forward's `add_pv` shape: the score
//   accumulators are the A fragments as they stand).  P^T and dS^T never
//   leave registers; Q, dO, lse and D tiles are double-buffered by
//   cp.async (single-buffered at fp32 hd 128, see BwdTile).
// - fa_bwd_dq: a block per (b, head, 64 query rows), 4 warps of 16 rows;
//   Q and dO are the A fragments (registers, or shared memory as above), K
//   and V tiles double-buffered by cp.async (as above); S, dP, then dQ +=
//   dS K.
// So P and dP are computed in both passes: 7 tile products against the
// function's 5.  Folding dQ into the dk/dv pass would need dQ summed across
// blocks with fp32 atomics, whose order changes from run to run; here the
// GQA group's sum stays in one block's registers and every output is
// written once, so two launches give the same bits.
// fp32 sums each tile's products in an accumulator of its own before adding
// it to the running dK, dV or dQ (the forward's add_pv rule: dK and dV sum
// 16,384 rows at llama3.2-1b).  The head-dim contraction is read in natural
// order here (k index t <-> d 8s + t) with every staged row padded to 4
// (mod 8) words, so that a tile read both ways -- rows as the B operand of
// a score product, columns as the B operand of a gradient product -- is
// free of bank conflicts both ways (fp32: scalar loads; bf16: ldmatrix and
// ldmatrix.trans).  Causal tiles above the diagonal are skipped, a warp
// skips a tile in which all its pairs are masked, the mask is applied only
// in tiles that cross the diagonal (and, in dq, the end of the keys: in
// dk/dv a key or query row past the end is zero and adds nothing), and
// both grids put the longest blocks first.
//
// What bounds it on an H100: at the llama3.2-1b shape (B 2, S 4096, H 32,
// KVH 8, hd 64, causal) the function is 5 products, 343.7 GFLOP, against
// ~337 MB (fp32): bound by operations, 2.08 ms as 3xTF32 at 495 TFLOP/s
// (0.35 ms in bf16 at 989).  The 7 products of this design floor it at
// 2.92 ms (0.49 ms in bf16).  The products run on mma.sync, which does not
// reach the wgmma rate: each warp loads its own B fragments from shared
// memory (in bf16 a 512-byte ldmatrix.x4 for two m16n8k16 products, about
// half the tensor cores' rate at 128 bytes a clock), and fp32 spends
// integer and FP32 instruction slots on the operand splits.  Q, dO (dk/dv) and
// K, V (dq) tiles are read again from L2 by every block that needs them.
constexpr int kBwdThreads = 256;          // fa_bwd_dot: 8 rows a block
constexpr int kBR = 64;                   // dkdv: keys, dq: query rows

// Per-dtype backward tile.  BQ: query rows a dkdv block stages a step; BK:
// keys a dq block stages a step (32 at fp32 hd 128, for the shared
// memory).  ST: row stride (elements) of every staged tile, 4 (mod 8)
// words, each row 16-byte aligned for cp.async.  kSmemA: the A fragments
// (K and V in dkdv, Q and dO in dq) are staged in shared memory and read
// per use instead of held in registers: in fp32 from hd 64 (the compiler
// keeps their splits in registers too) and at hd 128, where the dK and dV
// accumulators alone take 128 registers.  kStages: staged tiles in flight;
// at fp32 hd 128 one, so that two blocks share an SM (double-buffered, one
// 135 KB block a SM ran jamba's fp32 backward in 24.7 ms against 18.1).
// kMinBlocks: bf16 up to hd 64 is held to 168 registers for three blocks
// a SM (1.84 ms against 1.97 at llama3.2-1b, for 12 and 24 bytes of
// spills in dkdv and dq at hd 64).  Times: bench.py, H100 SXM at 700 W.
template <typename T, int HD> struct BwdTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int BQ = HD == 128 ? 32 : 64;
  static constexpr int BK = kF32 && HD == 128 ? 32 : 64;
  static constexpr int ST = kF32 ? HD + 4 : HD + 8;
  static constexpr bool kSmemA = kF32 ? HD >= 64 : HD == 128;
  static constexpr int kStages = kF32 && HD == 128 ? 1 : 2;
  static constexpr int kMinBlocks = !kF32 && HD <= 64 ? 3 : 1;
};

template <typename T, int HD>
constexpr size_t bwd_dkdv_smem() {       // Q, dO [S][BQ][ST]; K, V; lse, D
  using C = BwdTile<T, HD>;
  return sizeof(T) * (2 * C::kStages * C::BQ * C::ST
                      + (C::kSmemA ? 2 * kBR * C::ST : 0))
         + sizeof(float) * 2 * C::kStages * C::BQ;
}

template <typename T, int HD>
constexpr size_t bwd_dq_smem() {         // K, V [S][BK][ST]; Q, dO
  using C = BwdTile<T, HD>;
  return sizeof(T) * (2 * C::kStages * C::BK * C::ST
                      + (C::kSmemA ? 2 * kBR * C::ST : 0));
}

// 4-byte global -> shared copy; zero-fills when `ok` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragments of a warp's 16 rows (keys in dkdv, query rows in dq), by
// head-dim step s.  fp32: m16n8k8, k index t <-> d 8s + t, t + 4 <-> d 8s +
// t + 4; bf16: m16n8k16, k indices 2t, 2t + 1 <-> d 16s + 2t, + 1 and 2t +
// 8, 2t + 9 <-> d 16s + 2t + 8, + 9.  In registers (raw, loaded once) or,
// with kSmemA, read from the staged tile per use.
template <typename T, int HD> struct AFrag;
template <int HD> struct AFrag<float, HD> {
  using C = BwdTile<float, HD>;
  float x[C::kSmemA ? 1 : HD / 8][4];
  const float* p;                         // kSmemA: row g, column t
  __device__ __forceinline__ void load(const float* r0, const float* r1,
                                       int t) {
#pragma unroll
    for (int s = 0; s < HD / 8; ++s) {
      x[s][0] = r0 ? r0[8 * s + t] : 0.f;
      x[s][1] = r1 ? r1[8 * s + t] : 0.f;
      x[s][2] = r0 ? r0[8 * s + t + 4] : 0.f;
      x[s][3] = r1 ? r1[8 * s + t + 4] : 0.f;
    }
  }
  __device__ __forceinline__ void set(const float* tile, int row0,
                                      int lane) {
    p = tile + (row0 + (lane >> 2)) * C::ST + (lane & 3);
  }
  __device__ __forceinline__ void get(int s, float (&y)[4]) const {
    if constexpr (C::kSmemA) {
      y[0] = p[8 * s];
      y[1] = p[8 * C::ST + 8 * s];
      y[2] = p[8 * s + 4];
      y[3] = p[8 * C::ST + 8 * s + 4];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = x[s][i];
    }
  }
};
template <int HD> struct AFrag<__nv_bfloat16, HD> {
  using C = BwdTile<__nv_bfloat16, HD>;
  uint32_t x[C::kSmemA ? 1 : HD / 16][4];
  const __nv_bfloat16* p;                 // kSmemA: the lane's ldmatrix row
  __device__ __forceinline__ void load(const __nv_bfloat16* r0,
                                       const __nv_bfloat16* r1, int t) {
#pragma unroll
    for (int s = 0; s < HD / 16; ++s) {
      const int d = 16 * s + 2 * t;
      x[s][0] = r0 ? *reinterpret_cast<const uint32_t*>(r0 + d) : 0u;
      x[s][1] = r1 ? *reinterpret_cast<const uint32_t*>(r1 + d) : 0u;
      x[s][2] = r0 ? *reinterpret_cast<const uint32_t*>(r0 + d + 8) : 0u;
      x[s][3] = r1 ? *reinterpret_cast<const uint32_t*>(r1 + d + 8) : 0u;
    }
  }
  // matrices: rows 0-7 / 8-15 of the warp's 16 by columns 0-7 / 8-15
  __device__ __forceinline__ void set(const __nv_bfloat16* tile, int row0,
                                      int lane) {
    p = tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * C::ST
        + (lane >> 4) * 8;
  }
  __device__ __forceinline__ void get(int s, uint32_t (&y)[4]) const {
    if constexpr (C::kSmemA) {
      ldmatrix_x4(y, p + 16 * s);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = x[s][i];
    }
  }
};

// c[j] += A B^T, B^T's column n of n8 tile j being row 8j + n of the staged
// tile bt (a query row in dkdv, a key in dq); contracted over the head dim
// in AFrag's order.
template <int HD, int NJ>
__device__ __forceinline__ void bwd_scores(const AFrag<float, HD>& af,
                                           const float* bt,
                                           float (&c)[NJ][4], int lane) {
  constexpr int ST = BwdTile<float, HD>::ST;
  const float* b = bt + (lane >> 2) * ST + (lane & 3);
#pragma unroll
  for (int s = 0; s < HD / 8; ++s) {
    float x[4];
    af.get(s, x);
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], ab[i], as[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* r = b + 8 * j * ST + 8 * s;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(r[0], bb0, bs0);
      split_tf32(r[4], bb1, bs1);
      mma_tf32(c[j], as, bb0, bb1);       // the small terms first
      mma_tf32(c[j], ab, bs0, bs1);
      mma_tf32(c[j], ab, bb0, bb1);
    }
  }
}

template <int HD, int NJ>
__device__ __forceinline__ void bwd_scores(const AFrag<__nv_bfloat16, HD>& af,
                                           const __nv_bfloat16* bt,
                                           float (&c)[NJ][4], int lane) {
  constexpr int ST = BwdTile<__nv_bfloat16, HD>::ST;
  // matrices: rows 0-7 / 8-15 of an n8 tile pair by columns 0-7 / 8-15
  const __nv_bfloat16* b =
      bt + ((lane & 7) + (lane >> 4) * 8) * ST + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    uint32_t a[4];
    af.get(s, a);
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t r[4];
      ldmatrix_x4(r, b + 16 * jp * ST + 16 * s);
      mma_bf16(c[2 * jp], a, r[0], r[1]);
      mma_bf16(c[2 * jp + 1], a, r[2], r[3]);
    }
  }
}

// acc[n] += C B for head-dim columns 8n .. 8n + 7: C the 16 x 8NJ tile held
// in score accumulators c (P^T or dS^T in dkdv, dS in dq), B rows 0 ..
// 8NJ - 1 of the staged tile bt.  fp32: the k order t <-> column 8j + 2t,
// t + 4 <-> 8j + 2t + 1 makes c[j] the A fragment (c0, c2, c1, c3); the
// tile's products are summed in an accumulator of their own, up to 8
// output n8 tiles at a time, and added to acc once (see add_pv).
template <int HD, int NJ>
__device__ __forceinline__ void bwd_add(const float (&c)[NJ][4],
                                        const float* bt,
                                        float (&acc)[HD / 8][4], int lane) {
  constexpr int ST = BwdTile<float, HD>::ST;
  constexpr int ND = HD / 8, NC = ND < 8 ? ND : 8;
  const float* b = bt + 2 * (lane & 3) * ST + (lane >> 2);
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += NC) {
    float tile[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) tile[n][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ab[4], as[4];
      split_tf32(c[j][0], ab[0], as[0]);
      split_tf32(c[j][2], ab[1], as[1]);
      split_tf32(c[j][1], ab[2], as[2]);
      split_tf32(c[j][3], ab[3], as[3]);
      const float* r = b + 8 * j * ST + 8 * n0;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(r[8 * n], bb0, bs0);
        split_tf32(r[ST + 8 * n], bb1, bs1);
        mma_tf32(tile[n], as, bb0, bb1);
        mma_tf32(tile[n], ab, bs0, bs1);
        mma_tf32(tile[n], ab, bb0, bb1);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + n][i] += tile[n][i];
  }
}

// bf16: two adjacent n8 tiles of c packed to bf16x2 are the k16 A fragment
// as they stand; B's fragments come from ldmatrix.trans.
template <int HD, int NJ>
__device__ __forceinline__ void bwd_add(const float (&c)[NJ][4],
                                        const __nv_bfloat16* bt,
                                        float (&acc)[HD / 8][4], int lane) {
  constexpr int ST = BwdTile<__nv_bfloat16, HD>::ST;
  const __nv_bfloat16* b =
      bt + (((lane >> 3) & 1) * 8 + (lane & 7)) * ST + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < NJ / 2; ++s) {
    const uint32_t a[4] = {pack_bf16(c[2 * s][0], c[2 * s][1]),
                           pack_bf16(c[2 * s][2], c[2 * s][3]),
                           pack_bf16(c[2 * s + 1][0], c[2 * s + 1][1]),
                           pack_bf16(c[2 * s + 1][2], c[2 * s + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, b + 16 * s * ST + 16 * np);
      mma_bf16(acc[2 * np], a, r[0], r[1]);
      mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[n][i] = 0.f;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D[(b h) sq + s] = sum_d dO[b, s, h, d] o[b, s, h, d]: one warp per row.
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
fa_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
           float* __restrict__ delta, int rows, int sq, int h) {
  const int row = blockIdx.x * (kBwdThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * HD;
  const T* drow = dout + static_cast<size_t>(row) * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int hh = row % h, s = (row / h) % sq, b = row / (h * sq);
    delta[(static_cast<size_t>(b) * h + hh) * sq + s] = acc;
  }
}

// grid (b * kvh, key tiles): tile 0, whose causal loop is the longest, is
// in the first row of blocks to launch.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, BwdTile<T, HD>::kMinBlocks)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
            int kvh, float scale_log2, float scale, int causal) {
  using C = BwdTile<T, HD>;
  constexpr int BQ = C::BQ, ST = C::ST, NJ = BQ / 8, ND = HD / 8;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);     // [S][BQ][ST]
  T* dos = qs + S * BQ * ST;              // [S][BQ][ST]
  T* kvs = dos + S * BQ * ST;             // K, V [kBR][ST] if C::kSmemA
  float* ls = reinterpret_cast<float*>(kvs + (C::kSmemA ? 2 * kBR * ST : 0));
  float* dls = ls + S * BQ;               // lse, D [S][BQ]

  const int b = blockIdx.x / kvh, kh = blockIdx.x % kvh;
  const int k0 = blockIdx.y * kBR;
  const int rep = h / kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 16 * warp;         // the warp's first key
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t kv_off = static_cast<size_t>(b) * sk * kv_stride + kh * HD;

  AFrag<T, HD> kf, vf;                    // keys >= sk are zeros
  if constexpr (C::kSmemA) {
    load_tile<T, HD, kBR, ST>(kvs, k + kv_off, kv_stride, k0, sk, tid);
    load_tile<T, HD, kBR, ST>(kvs + kBR * ST, v + kv_off, kv_stride, k0, sk,
                              tid);
    kf.set(kvs, 16 * warp, lane);
    vf.set(kvs + kBR * ST, 16 * warp, lane);
  } else {
    const int r0 = kw0 + g, r1 = r0 + 8;
    const size_t o0 = kv_off + static_cast<size_t>(r0) * kv_stride;
    const size_t o1 = o0 + 8 * kv_stride;
    kf.load(r0 < sk ? k + o0 : nullptr, r1 < sk ? k + o1 : nullptr, t);
    vf.load(r0 < sk ? v + o0 : nullptr, r1 < sk ? v + o1 : nullptr, t);
  }

  // steps: (query head of the group, query tile); rows before k0 see none
  // of these keys under the causal mask
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < sq ? (sq - q_begin + BQ - 1) / BQ : 0;
  const int n_steps = rep * n_qt;
  auto stage = [&](int it, int buf) {
    const int hh = kh * rep + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * BQ;
    const size_t q_off = static_cast<size_t>(b) * sq * q_stride + hh * HD;
    load_tile<T, HD, BQ, ST>(qs + buf * BQ * ST, q + q_off, q_stride, q0, sq,
                             tid);
    load_tile<T, HD, BQ, ST>(dos + buf * BQ * ST, dout + q_off, q_stride, q0,
                             sq, tid);
    const size_t r = (static_cast<size_t>(b) * h + hh) * sq;
    if (tid < 2 * BQ) {                   // rows >= sq: lse = D = 0
      const int i = tid % BQ;
      const bool ok = q0 + i < sq;
      const float* src = tid < BQ ? lse + r : delta + r;
      cp_async4((tid < BQ ? ls : dls) + buf * BQ + i, ok ? src + q0 + i : src,
                ok);
    }
  };
  if (n_steps > 0) stage(0, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
  zero(dka);
  zero(dva);
  for (int it = 0; it < n_steps; ++it) {
    if (S == 1) {
      if (it > 0) {
        stage(it, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    } else if (it + 1 < n_steps) {        // next tile in flight
      stage(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = S == 1 ? 0 : it & 1;
    const int q0 = q_begin + (it % n_qt) * BQ;
    // a warp whose keys are all past the end, or (causal) all after the
    // tile's last row, has nothing to add
    if (kw0 < sk && (!causal || q0 + BQ - 1 >= kw0)) {
      const T* qt = qs + buf * BQ * ST;
      const T* dt = dos + buf * BQ * ST;
      const float* lt = ls + buf * BQ;
      const float* dlt = dls + buf * BQ;
      float sc[NJ][4];
      zero(sc);
      bwd_scores<HD, NJ>(kf, qt, sc, lane);          // S^T = K Q^T
      // P^T: rows keys kw0 + g (+ 8), columns queries q0 + 8j + 2t (+ 1)
      const bool masked = causal && q0 < kw0 + 15;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = ex2(fmaf(sc[j][i], scale_log2, nl[i & 1]));
          if (masked && kw0 + g + 8 * (i >> 1) > q0 + 8 * j + 2 * t + (i & 1))
            p = 0.f;
          sc[j][i] = p;
        }
      }
      bwd_add<HD, NJ>(sc, dt, dva, lane);            // dV += P^T dO
      float dp[NJ][4];
      zero(dp);
      bwd_scores<HD, NJ>(vf, dt, dp, lane);          // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[j][i] = sc[j][i] * (dp[j][i] - (i & 1 ? d2.y : d2.x));
      }
      bwd_add<HD, NJ>(dp, qt, dka, lane);            // dK += dS^T Q
    }
    __syncthreads();                      // the tile is consumed
  }
  cp_async_wait<0>();                     // K, V when there was no step

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= sk) continue;
    const size_t off = kv_off + static_cast<size_t>(key) * kv_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(dk + off + 8 * n, dka[n][2 * r] * scale,
             dka[n][2 * r + 1] * scale);
      store2(dv + off + 8 * n, dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// grid (b * h, query tiles), walked from the last query tile down so that
// the longest blocks launch first.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, BwdTile<T, HD>::kMinBlocks)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int sk, int h, int kvh,
          float scale_log2, float scale, int causal) {
  using C = BwdTile<T, HD>;
  constexpr int BK = C::BK, ST = C::ST, NJ = BK / 8, ND = HD / 8;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);     // [S][BK][ST]
  T* vs = ks + S * BK * ST;               // [S][BK][ST]
  T* qds = vs + S * BK * ST;              // Q, dO [kBR][ST] if C::kSmemA

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int kh = hh / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 16 * warp;         // the warp's first row
  const int row0 = wq0 + g, row1 = row0 + 8;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t q_off = static_cast<size_t>(b) * sq * q_stride + hh * HD;
  const size_t kv_off = static_cast<size_t>(b) * sk * kv_stride + kh * HD;

  const int k_end = causal ? min(sk, q0 + kBR) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  load_tile<T, HD, BK, ST>(ks, k + kv_off, kv_stride, 0, sk, tid);
  load_tile<T, HD, BK, ST>(vs, v + kv_off, kv_stride, 0, sk, tid);
  AFrag<T, HD> qf, df;                    // rows >= sq are zeros
  if constexpr (C::kSmemA) {
    load_tile<T, HD, kBR, ST>(qds, q + q_off, q_stride, q0, sq, tid);
    load_tile<T, HD, kBR, ST>(qds + kBR * ST, dout + q_off, q_stride, q0, sq,
                              tid);
    qf.set(qds, 16 * warp, lane);
    df.set(qds + kBR * ST, 16 * warp, lane);
  } else {
    const size_t o0 = q_off + static_cast<size_t>(row0) * q_stride;
    const size_t o1 = o0 + 8 * q_stride;
    qf.load(row0 < sq ? q + o0 : nullptr, row1 < sq ? q + o1 : nullptr, t);
    df.load(row0 < sq ? dout + o0 : nullptr,
            row1 < sq ? dout + o1 : nullptr, t);
  }
  cp_async_commit();
  float nl[2], dl[2];                     // -lse log2(e) and D of the rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const size_t i = (static_cast<size_t>(b) * h + hh) * sq + row;
    nl[r] = row < sq ? -lse[i] * kLog2e : 0.f;
    dl[r] = row < sq ? delta[i] : 0.f;
  }

  float dqa[ND][4];
  zero(dqa);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (S == 1) {
      if (it > 0) {
        load_tile<T, HD, BK, ST>(ks, k + kv_off, kv_stride, k0, sk, tid);
        load_tile<T, HD, BK, ST>(vs, v + kv_off, kv_stride, k0, sk, tid);
        cp_async_commit();
      }
      cp_async_wait<0>();
    } else if (it + 1 < n_tiles) {        // next tile in flight
      const int nb = (it + 1) & 1;
      load_tile<T, HD, BK, ST>(ks + nb * BK * ST, k + kv_off, kv_stride,
                               k0 + BK, sk, tid);
      load_tile<T, HD, BK, ST>(vs + nb * BK * ST, v + kv_off, kv_stride,
                               k0 + BK, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // (causal) a warp whose rows all precede the tile has nothing to add
    if (!causal || k0 <= wq0 + 15) {
      const T* kt = ks + (S == 1 ? 0 : it & 1) * BK * ST;
      const T* vt = vs + (S == 1 ? 0 : it & 1) * BK * ST;
      float sc[NJ][4];
      zero(sc);
      bwd_scores<HD, NJ>(qf, kt, sc, lane);          // S = Q K^T
      // P: rows wq0 + g (+ 8), columns keys k0 + 8j + 2t (+ 1); masked
      // where the tile crosses the end of the keys or the warp's diagonal
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > wq0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = ex2(fmaf(sc[j][i], scale_log2, nl[i >> 1]));
          if (masked) {
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            if (key >= sk || (causal && key > (i < 2 ? row0 : row1))) p = 0.f;
          }
          sc[j][i] = p;
        }
      float dp[NJ][4];
      zero(dp);
      bwd_scores<HD, NJ>(df, vt, dp, lane);          // dP = dO V^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[j][i] = sc[j][i] * (dp[j][i] - dl[i >> 1]);
      bwd_add<HD, NJ>(dp, kt, dqa, lane);            // dQ += dS K
    }
    __syncthreads();                      // the tile is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= sq) continue;
    T* out = dq + q_off + static_cast<size_t>(row) * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(out + 8 * n, dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int b,
                       int sq, int sk, int h, int kvh, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t bytes = bwd_dkdv_smem<T, HD>();
  constexpr size_t dq_bytes = bwd_dq_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  const int rows = b * sq * h;
  const int per = kBwdThreads / 32;
  fa_bwd_dot<T, HD><<<(rows + per - 1) / per, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, sq,
      h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  fa_bwd_dkdv<T, HD><<<dim3(b * kvh, (sk + kBR - 1) / kBR), kThreads, bytes,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, kvh, scale_log2,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq<T, HD><<<dim3(b * h, (sq + kBR - 1) / kBR), kThreads, dq_bytes,
                     stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, h, kvh, scale_log2, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_hd(int hd, const void* q, const void* k,
                          const void* v, const void* o, const void* dout,
                          const float* lse, float* delta, void* dq, void* dk,
                          void* dv, int b, int sq, int sk, int h, int kvh,
                          float scale, int causal, cudaStream_t stream) {
#define REPRO_FA_BWD(HD)                                                  \
  case HD:                                                                \
    return launch_bwd<T, HD>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, \
                             sq, sk, h, kvh, scale, causal, stream);
  switch (hd) {
    REPRO_FA_BWD(16)
    REPRO_FA_BWD(32)
    REPRO_FA_BWD(64)
    REPRO_FA_BWD(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FA_BWD
}

template <typename T>
int bwd_smem_hd(int hd, int which) {
#define REPRO_FA_BWD_SMEM(HD)                                             \
  case HD:                                                                \
    return static_cast<int>(which ? bwd_dq_smem<T, HD>()                  \
                                  : bwd_dkdv_smem<T, HD>());
  switch (hd) {
    REPRO_FA_BWD_SMEM(16)
    REPRO_FA_BWD_SMEM(32)
    REPRO_FA_BWD_SMEM(64)
    REPRO_FA_BWD_SMEM(128)
    default: return -1;
  }
#undef REPRO_FA_BWD_SMEM
}


}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success).  dtype: 0 fp32, 1 bf16.
// q, o: (b, sq, h, hd); k, v: (b, sk, kvh, hd); contiguous, 16-byte
// aligned; h a multiple of kvh; hd in {16, 32, 64, 128}.  lse: null, or
// (b, h, sq) fp32 to receive each row's log-sum-exp (the backward's input).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int b, int sq, int sk, int h,
                           int kvh, int hd, int dtype, float scale,
                           int causal, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return static_cast<int>(launch_hd<float>(
        hd, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, s));
    case 1: return static_cast<int>(launch_hd<__nv_bfloat16>(
        hd, q, k, v, o, l, b, sq, sk, h, kvh, scale, causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward on `stream`: three kernels (D, then dk/dv, then dq); returns
// the first cudaError_t (0 on success).  q, o, dout, dq: (b, sq, h, hd);
// k, v, dk, dv: (b, sk, kvh, hd); lse and delta (workspace): (b, h, sq)
// fp32.  Same types and shapes as flash_attention_launch.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int b, int sq, int sk,
                               int h, int kvh, int hd, int dtype, float scale,
                               int causal, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (dtype) {
    case 0: return static_cast<int>(launch_bwd_hd<float>(
        hd, q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, sk, h, kvh, scale,
        causal, s));
    case 1: return static_cast<int>(launch_bwd_hd<__nv_bfloat16>(
        hd, q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, sk, h, kvh, scale,
        causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory (bytes) of one block for (hd, dtype); -1 if the
// pair is not built.
int flash_attention_smem_bytes(int hd, int dtype) {
  switch (dtype) {
    case 0: return smem_hd<float>(hd);
    case 1: return smem_hd<__nv_bfloat16>(hd);
    default: return -1;
  }
}

// Dynamic shared memory (bytes) of one backward block for (hd, dtype):
// which 0 is fa_bwd_dkdv, 1 fa_bwd_dq; -1 if the pair is not built.
int flash_attention_bwd_smem_bytes(int hd, int dtype, int which) {
  switch (dtype) {
    case 0: return bwd_smem_hd<float>(hd, which);
    case 1: return bwd_smem_hd<__nv_bfloat16>(hd, which);
    default: return -1;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
