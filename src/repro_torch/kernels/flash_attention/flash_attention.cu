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
// Three kernels on the stream: bwd_dot (D), bwd_dkdv (a block per (b, KV
// head, 64-key tile): it loops over the group's H / KVH query heads and
// their query tiles, so GQA's sum over the group happens in registers and
// no atomics are needed; dk and dv are the same bits every run), bwd_dq (a
// block per (b, head, 64-row query tile), looping over the key tiles).  P
// and dP are recomputed in both, which is 7 tile products against the
// function's 5.
//
// What bounds it on an H100: at the llama3.2-1b shape (B 2, S 4096, H 32,
// hd 64, causal) the function is 5 products, 343.7 GFLOP, against ~235 MB
// (fp32): bound by operations.  This first version runs every product as
// fp32 FMA on the SIMT cores (67 TFLOP/s, 5.13 ms at that shape) for both
// types: operands are staged in shared memory as fp32 (rows padded to an
// odd stride, so a column read by 16 lanes hits 16 banks), and each of the
// 256 threads (16 x 16) owns a 4 x 4 grid of (row, key) entries spaced 16
// apart, or 4 rows x hd/16 columns of an accumulator.  Tensor cores
// (mma.sync / wgmma) are the next step.
constexpr int kBB = 64;                   // query rows and keys per tile
constexpr int kBwdThreads = 256;          // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
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

// Rows [r0, r0 + kBB) of one head (row stride `stride` elements) into an
// fp32 tile of row stride HD + 1; rows at or past n are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      size_t stride, int r0, int n) {
  for (int i = threadIdx.x; i < kBB * HD; i += kBwdThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] =
        r0 + r < n ? to_f(src[static_cast<size_t>(r0 + r) * stride + c])
                   : 0.f;
  }
}

// s += Q K^T and dp += dO V^T over the head dim for rows ty + 16a and keys
// tx + 16c of the tiles (fp32, row stride HD + 1).
template <int HD>
__device__ __forceinline__ void scores_dp(const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          float (&s)[4][4], float (&dp)[4][4],
                                          int ty, int tx) {
  constexpr int ST = HD + 1;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = qs[(ty + 16 * a) * ST + d];
      da[a] = dos[(ty + 16 * a) * ST + d];
      kb[a] = ks[(tx + 16 * a) * ST + d];
      vb[a] = vs[(tx + 16 * a) * ST + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
        dp[a][c] = fmaf(da[a], vb[c], dp[a][c]);
      }
  }
}

// P and dS of the tile pair (q0, k0) for this thread's 4 x 4 entries, from
// the scores and dP; masked entries (past sq or sk, or above the causal
// diagonal) are 0.
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lses, const float* dls,
                                      int q0, int k0, int sq, int sk,
                                      int causal, float scale_log2, int ty,
                                      int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      const bool ok = i < sq && j < sk && (!causal || j <= i);
      const float p = ok ? ex2(s[a][c] * scale_log2 - lses[r]) : 0.f;
      s[a][c] = p;
      dp[a][c] = p * (dp[a][c] - dls[r]);
    }
  }
}

// Shared memory of one block: Q, dO, K, V tiles (kBB x (HD + 1)), `tiles`
// kBB x (kBB + 1) ones (P and dS for dk/dv, dS alone for dq), and the query
// rows' lse (log2 domain) and D.
template <int HD>
constexpr size_t bwd_smem_bytes(int tiles) {
  return sizeof(float) *
         (4 * kBB * (HD + 1) + tiles * kBB * (kBB + 1) + 2 * kBB);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
            int kvh, float scale_log2, float scale, int causal) {
  constexpr int ST = HD + 1, PT = kBB + 1, NC = HD / 16;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + kBB * ST;
  float* ks = dos + kBB * ST;
  float* vs = ks + kBB * ST;
  float* ps = vs + kBB * ST;
  float* dss = ps + kBB * PT;
  float* lses = dss + kBB * PT;
  float* dls = lses + kBB;

  const int k0 = blockIdx.x * kBB;        // tile 0 has the most work first
  const int b = blockIdx.y / kvh, kh = blockIdx.y % kvh;
  const int rep = h / kvh;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t kv_off = static_cast<size_t>(b) * sk * kv_stride + kh * HD;
  stage<T, HD>(ks, k + kv_off, kv_stride, k0, sk);
  stage<T, HD>(vs, v + kv_off, kv_stride, k0, sk);

  float dka[4][NC], dva[4][NC];           // keys ty + 16a, dims tx + 16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[a][c] = dva[a][c] = 0.f;

  const int q_begin = causal ? k0 : 0;    // earlier rows see none of these keys
  for (int hh = kh * rep; hh < (kh + 1) * rep; ++hh) {
    const size_t q_off = static_cast<size_t>(b) * sq * q_stride + hh * HD;
    const float* lse_h = lse + (static_cast<size_t>(b) * h + hh) * sq;
    const float* dl_h = delta + (static_cast<size_t>(b) * h + hh) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += kBB) {
      __syncthreads();                    // the previous tiles are consumed
      stage<T, HD>(qs, q + q_off, q_stride, q0, sq);
      stage<T, HD>(dos, dout + q_off, q_stride, q0, sq);
      if (tid < kBB) {
        const bool ok = q0 + tid < sq;
        lses[tid] = ok ? lse_h[q0 + tid] * kLog2e : 0.f;
        dls[tid] = ok ? dl_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      scores_dp<HD>(qs, dos, ks, vs, s, dp, ty, tx);
      probs(s, dp, lses, dls, q0, k0, sq, sk, causal, scale_log2, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(ty + 16 * a) * PT + tx + 16 * c] = s[a][c];
          dss[(ty + 16 * a) * PT + tx + 16 * c] = dp[a][c];
        }
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
      const int i_end = min(kBB, sq - q0);
#pragma unroll 2
      for (int i = 0; i < i_end; ++i) {
        float pa[4], sa[4], dov[NC], qv[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = ps[i * PT + ty + 16 * a];
          sa[a] = dss[i * PT + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dos[i * ST + tx + 16 * c];
          qv[c] = qs[i * ST + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dva[a][c] = fmaf(pa[a], dov[c], dva[a][c]);
            dka[a][c] = fmaf(sa[a], qv[c], dka[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= sk) continue;
    const size_t off = kv_off + static_cast<size_t>(j) * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(dka[a][c] * scale);
      dv[off + tx + 16 * c] = from_f<T>(dva[a][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int sk, int h, int kvh,
          float scale_log2, float scale, int causal) {
  constexpr int ST = HD + 1, PT = kBB + 1, NC = HD / 16;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + kBB * ST;
  float* ks = dos + kBB * ST;
  float* vs = ks + kBB * ST;
  float* dss = vs + kBB * ST;
  float* lses = dss + kBB * PT;
  float* dls = lses + kBB;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBB;  // longest tiles first
  const int b = blockIdx.y / h, hh = blockIdx.y % h;
  const int kh = hh / (h / kvh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_stride = static_cast<size_t>(h) * HD;
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t q_off = static_cast<size_t>(b) * sq * q_stride + hh * HD;
  const size_t kv_off = static_cast<size_t>(b) * sk * kv_stride + kh * HD;
  stage<T, HD>(qs, q + q_off, q_stride, q0, sq);
  stage<T, HD>(dos, dout + q_off, q_stride, q0, sq);
  if (tid < kBB) {
    const bool ok = q0 + tid < sq;
    const size_t r = (static_cast<size_t>(b) * h + hh) * sq + q0 + tid;
    lses[tid] = ok ? lse[r] * kLog2e : 0.f;
    dls[tid] = ok ? delta[r] : 0.f;
  }

  float dqa[4][NC];                       // rows ty + 16a, dims tx + 16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[a][c] = 0.f;

  const int k_end = causal ? min(sk, q0 + kBB) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBB) {
    __syncthreads();                      // the previous tiles are consumed
    stage<T, HD>(ks, k + kv_off, kv_stride, k0, sk);
    stage<T, HD>(vs, v + kv_off, kv_stride, k0, sk);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    scores_dp<HD>(qs, dos, ks, vs, s, dp, ty, tx);
    probs(s, dp, lses, dls, q0, k0, sq, sk, causal, scale_log2, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dss[(ty + 16 * a) * PT + tx + 16 * c] = dp[a][c];
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
    const int j_end = min(kBB, sk - k0);
#pragma unroll 2
    for (int j = 0; j < j_end; ++j) {
      float sa[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(ty + 16 * a) * PT + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[j * ST + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) dqa[a][c] = fmaf(sa[a], kv[c], dqa[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= sq) continue;
    T* row = dq + q_off + static_cast<size_t>(i) * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      row[tx + 16 * c] = from_f<T>(dqa[a][c] * scale);
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int b,
                       int sq, int sk, int h, int kvh, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t bytes = bwd_smem_bytes<HD>(2);
  constexpr size_t dq_bytes = bwd_smem_bytes<HD>(1);
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
  fa_bwd_dkdv<T, HD><<<dim3((sk + kBB - 1) / kBB, b * kvh), kBwdThreads,
                       bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, kvh, scale_log2,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq<T, HD><<<dim3((sq + kBB - 1) / kBB, b * h), kBwdThreads,
                     dq_bytes, stream>>>(
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

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
