// RWKV6 ("Finch") WKV recurrence on Hopper (sm_90a), as a chunked scan.
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
// H 64, hd 64) the function moves ~0.34 GB (five (B, T, H, hd) fp32
// arrays), 0.100 ms at 3.35 TB/s, and needs ~5.45 GFLOP, 0.081 ms at 67
// TFLOP/s.  Stepping the recurrence makes the time T times the latency of
// one step instead, so the kernel cuts T into chunks of C = 64 steps and
// makes the chain ceil(T/C) - 1 chunk updates long.  For a chunk with
// incoming state S0, with every decay a product of w (never a quotient or
// a difference of logs, so w = 0 or denormal gives what the recurrence
// gives):
//
//     D_ts = prod_{s<q<t} w_q   (s < t)      R_s = prod_{s<q<C} w_q
//     E_t  = prod_{q<t} w_q                  P   = prod_q w_q
//     y_t  = (r_t E_t) . S0 + sum_{s<t} A_ts v_s + A_tt v_t,
//            A_ts = sum_i r_t[i] k_s[i] D_ts[i],  A_tt = sum_i r_t[i] u[i] k_t[i]
//     S_C  = diag(P) S0 + (k R)^T v
//
// Two kernels, one launch of each per call:
//
// * `wkv_state` (grid: hd/32 row tiles x B*H) keeps a 32-row tile of S in
//   registers and walks the chunks, writing each chunk's S0 to an fp32
//   workspace (B, H, ceil(T/C) - 1, hd, hd) that the caller allocates.
//   Per chunk, 32 threads form k R and P as running products (R = 1; for
//   s = C-1 down to 0: kR_s = k_s R; R *= w_s), then every thread forms
//   P S + (k R)^T v for its 4 x 2 elements, with S kept as a compensated
//   (Kahan) pair and (k R)^T v joined L steps at a time: with w near 1, S
//   grows with T, and rounding every step or chunk at S's magnitude would
//   drift from the exact sum as stepping the recurrence does.  The next
//   chunk's k, w, v are copied into a second shared buffer meanwhile.
// * `wkv_out` (grid: chunks x B*H, 256 threads) computes one chunk's y:
//   A from r, k, w (the note above wkv_out), then each thread forms a
//   4 x hd/16 tile of y as [r E | A] . [S0 ; V], two dense products from
//   shared memory (A is lower triangular, so the s loop stops at the
//   tile's last row).
//
// What holds it now (chip_smoke.py's per-pass profile on an NVIDIA H100
// 80GB HBM3 at 700 W, PERF.md section 6): neither bytes nor FLOPs.  The
// state pass is a chain of ceil(T/C) - 1 dependent chunk steps, each a
// barrier-separated sequence (the k R chain, the update, the copy) that
// one or two blocks an SM do not overlap; in the output pass the
// in-sub-chunk walk, the blocks below the diagonal, the dense products
// and the copies each take a similar share of the time and overlap
// poorly.  Tensor cores (3xTF32, as flash_attention does) for the dense
// products are left for later.
//
// Inputs are staged in shared memory as fp32: fp32 by cp.async, bf16 in
// 16-byte vectors widened once.  All math is fp32 on the SIMT units.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int C = 64;                      // steps per chunk
constexpr int L = 16;                      // steps per sub-chunk (wkv_out)
constexpr int NB = C / L;
constexpr int OUT_THREADS = 4 * C;         // wkv_out: 4 threads per row
// wkv_state: rows of S per block, 8 elements per thread
template <int HD> __host__ __device__ constexpr int jr() {
  return HD < 32 ? HD : 32;
}
template <int HD> __host__ __device__ constexpr int state_threads() {
  return HD * jr<HD>() / 8;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n"
               "cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows [t0, t0 + C) x columns [0, W) of one head of a (B, T, H, hd)
// array (`src` at that head's row 0, column 0; rows `t_stride` apart) into
// shared `dst` (C x W fp32, row stride DS); rows at or past t_len are zero.
// fp32 goes by cp.async straight to `dst` and store() does nothing; bf16
// is held in registers by load() as 16-byte vectors (8 values) and widened
// into `dst` by store(), so a caller can overlap the two with other work.
// Either way the caller waits (cp_async_wait_all) and syncs before use.
template <typename T, int W, int NT, int DS = W> struct Stage;

template <int W, int NT, int DS> struct Stage<float, W, NT, DS> {
  static constexpr int NV = C * W / 4;
  static constexpr int PER = (NV + NT - 1) / NT;
  __device__ __forceinline__ void load(const float* src, size_t t_stride,
                                       int t0, int t_len, float* dst,
                                       int tid) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * NT;
      if (NV % NT == 0 || idx < NV) {
        const int tt = idx / (W / 4), c = idx % (W / 4) * 4;
        const bool ok = t0 + tt < t_len;
        cp_async16(dst + tt * DS + c,
                   ok ? src + (t0 + tt) * t_stride + c : src, ok);
      }
    }
  }
  __device__ __forceinline__ void store(float*, int) {}
};

template <int W, int NT, int DS> struct Stage<__nv_bfloat16, W, NT, DS> {
  static constexpr int NV = C * W / 8;
  static constexpr int PER = (NV + NT - 1) / NT;
  uint4 raw[PER];
  __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                       size_t t_stride, int t0, int t_len,
                                       float*, int tid) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * NT;
      raw[e] = make_uint4(0u, 0u, 0u, 0u);
      if (NV % NT == 0 || idx < NV) {
        const int tt = idx / (W / 8), c = idx % (W / 8) * 8;
        if (t0 + tt < t_len)
          raw[e] = *reinterpret_cast<const uint4*>(
              src + (t0 + tt) * t_stride + c);
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int tid) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * NT;
      if (NV % NT == 0 || idx < NV) {
        const int tt = idx / (W / 8), c = idx % (W / 8) * 8;
        const uint32_t wd[4] = {raw[e].x, raw[e].y, raw[e].z, raw[e].w};
        float f[8];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 p = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&wd[m]));
          f[2 * m] = p.x;
          f[2 * m + 1] = p.y;
        }
        float4* d = reinterpret_cast<float4*>(dst + tt * DS + c);
        d[0] = make_float4(f[0], f[1], f[2], f[3]);
        d[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
};

// Shared memory (floats) of each kernel at head size HD.
template <int HD> __host__ __device__ constexpr int state_floats() {
  return 2 * (2 * C * jr<HD>() + C * HD) + jr<HD>();   // two (k, w, v), P
}
// wkv_out's row stride for r, k, w: rows 4 banks apart, so 8 lanes
// reading 8 rows in one 16-byte load do not conflict
template <int HD> __host__ __device__ constexpr int pad() { return HD + 4; }
// v and S0 are needed after A only: they go where k and w were, if they
// fit there (hd <= 64: three blocks an SM at hd 64)
template <int HD> __host__ __device__ constexpr bool v_late() {
  return HD * HD + C * HD <= 2 * C * pad<HD>();
}
template <int HD> __host__ __device__ constexpr int out_floats() {
  // r, A, M, [v], k, w (r, k, w in padded rows), and what more S0 needs
  return 3 * C * pad<HD>() + C * C + NB * HD + (v_late<HD>() ? 0 : C * HD)
         + (HD * HD > 2 * C * pad<HD>() ? HD * HD - 2 * C * pad<HD>() : 0);
}

// One head's chunk updates, for the forward's state pass (REV false: S0
// of chunk c + 1 -> ws slot c, for c = 0 .. n_upd - 1, every such chunk
// full; a = k, x = v, and the products R_s of w after s to the chunk's
// end) and for the backward's G pass (REV true: G_end of chunk c, dL/dS at
// its end, -> ws slot c, walked from chunk n_upd, possibly ragged, down to
// chunk 1; a = r, x = dy, and the products E_t of w before t from the
// chunk's start).  Either way the state X goes to diag(P) X + (a P_a)^T x
// a chunk.  A block owns rows row0 .. row0 + JR - 1 of X (it reads a and
// w of those channels only, and all of x); thread (rg, cp) owns rows
// row0 + 4 rg .. + 3 and columns 2 cp, 2 cp + 1.
template <typename T, int HD, bool REV>
__device__ __forceinline__ void chunk_states(const T* __restrict__ a,
                                             const T* __restrict__ x,
                                             const T* __restrict__ w,
                                             float* __restrict__ ws,
                                             int t_len, int h, int n_upd) {
  constexpr int NT = state_threads<HD>(), JR = jr<HD>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int BUF = 2 * C * JR + C * HD;       // floats per buffer
  float* pw = smem + 2 * BUF;                    // P, JR floats

  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int row0 = blockIdx.x * JR;
  const int tid = threadIdx.x;
  const int rg = tid / (HD / 2), cp = tid % (HD / 2);
  const size_t t_stride = static_cast<size_t>(h) * HD;
  const size_t head = static_cast<size_t>(b) * t_len * t_stride + hh * HD;

  Stage<T, JR, NT> sk, sw;
  Stage<T, HD, NT> sv;
  auto load = [&](int it, float* buf) {
    const int c = REV ? n_upd - it : it;
    sk.load(a + head + row0, t_stride, c * C, t_len, buf, tid);
    sw.load(w + head + row0, t_stride, c * C, t_len, buf + C * JR, tid);
    sv.load(x + head, t_stride, c * C, t_len, buf + 2 * C * JR, tid);
  };
  auto store = [&](float* buf) {
    sk.store(buf, tid);
    sw.store(buf + C * JR, tid);
    sv.store(buf + 2 * C * JR, tid);
  };

  float s[4][2] = {}, e[4][2] = {};
  load(0, smem);
  store(smem);
  cp_async_wait_all();
  __syncthreads();
  for (int it = 0; it < n_upd; ++it) {
    float* kb = smem + (it & 1) * BUF;
    const float* wb = kb + C * JR;
    const float* vb = kb + 2 * C * JR;
    if (it + 1 < n_upd) load(it + 1, smem + ((it + 1) & 1) * BUF);

    if (tid < JR) {                  // a P_a and P, running products
      float rr = 1.f;
      // 16 steps at a time through registers: stores into kb between
      // loads of wb would serialise every step on shared memory
      for (int n = 0; n < C / 16; ++n) {
        const int t1 = REV ? 16 * n : C - 16 - 16 * n;
        float kk[16], ww[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          kk[m] = kb[(t1 + m) * JR + tid];
          ww[m] = wb[(t1 + m) * JR + tid];
        }
        if constexpr (REV) {
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            kk[m] *= rr;
            rr *= ww[m];
          }
        } else {
#pragma unroll
          for (int m = 15; m >= 0; --m) {
            kk[m] *= rr;
            rr *= ww[m];
          }
        }
#pragma unroll
        for (int m = 0; m < 16; ++m) kb[(t1 + m) * JR + tid] = kk[m];
      }
      pw[tid] = rr;
    }
    __syncthreads();

    // X = P X + (a P_a)^T x with X held as s - e (Kahan; see the top
    // note): the scaling's exact rounding error goes into e (an FMA gives
    // it), then each L-step partial sum is added with compensation.  The
    // _rn intrinsics keep the compiler from fusing.
    const float4 p4 = *reinterpret_cast<const float4*>(pw + 4 * rg);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float hi = __fmul_rn(p[i], s[i][j]);
        e[i][j] = fmaf(p[i], e[i][j], -fmaf(p[i], s[i][j], -hi));
        s[i][j] = hi;
      }
    for (int t1 = 0; t1 < C; t1 += L) {
      float d[4][2] = {};
#pragma unroll 8
      for (int t = t1; t < t1 + L; ++t) {
        const float4 av4 = *reinterpret_cast<const float4*>(
            kb + t * JR + 4 * rg);
        const float2 xv = *reinterpret_cast<const float2*>(
            vb + t * HD + 2 * cp);
        const float av[4] = {av4.x, av4.y, av4.z, av4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[i][0] = fmaf(av[i], xv.x, d[i][0]);
          d[i][1] = fmaf(av[i], xv.y, d[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float yv = __fsub_rn(d[i][j], e[i][j]);
          const float tv = __fadd_rn(s[i][j], yv);
          e[i][j] = __fsub_rn(__fsub_rn(tv, s[i][j]), yv);
          s[i][j] = tv;
        }
    }
    const int slot = REV ? n_upd - 1 - it : it;
    float* dst = ws + (static_cast<size_t>(bh) * n_upd + slot) * HD * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(dst + (row0 + 4 * rg + i) * HD + 2 * cp) =
          make_float2(__fsub_rn(s[i][0], e[i][0]),
                      __fsub_rn(s[i][1], e[i][1]));

    if (it + 1 < n_upd) store(smem + ((it + 1) & 1) * BUF);
    cp_async_wait_all();
    __syncthreads();
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(state_threads<HD>())
wkv_state(const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ w, float* __restrict__ ws, int t_len, int h,
          int n_upd) {
  chunk_states<T, HD, false>(k, v, w, ws, t_len, h, n_upd);
}

template <typename T, int TC>
__device__ __forceinline__ void store_row(T* p, const float* x);

template <>
__device__ __forceinline__ void store_row<float, 1>(float* p,
                                                    const float* x) {
  *p = x[0];
}
template <>
__device__ __forceinline__ void store_row<float, 2>(float* p,
                                                    const float* x) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
template <>
__device__ __forceinline__ void store_row<float, 4>(float* p,
                                                    const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
template <>
__device__ __forceinline__ void store_row<float, 8>(float* p,
                                                    const float* x) {
  store_row<float, 4>(p, x);
  store_row<float, 4>(p + 4, x + 4);
}
template <>
__device__ __forceinline__ void store_row<__nv_bfloat16, 1>(
    __nv_bfloat16* p, const float* x) {
  *p = __float2bfloat16_rn(x[0]);
}
template <>
__device__ __forceinline__ void store_row<__nv_bfloat16, 2>(
    __nv_bfloat16* p, const float* x) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
}
template <>
__device__ __forceinline__ void store_row<__nv_bfloat16, 4>(
    __nv_bfloat16* p, const float* x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
template <>
__device__ __forceinline__ void store_row<__nv_bfloat16, 8>(
    __nv_bfloat16* p, const float* x) {
  store_row<__nv_bfloat16, 4>(p, x);
  store_row<__nv_bfloat16, 4>(p + 4, x + 4);
}

// x[0 .. TC) = p[0 .. TC), in 16- or 8-byte shared loads where TC allows.
template <int TC>
__device__ __forceinline__ void ld_row(const float* p, float* x) {
  if constexpr (TC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TC; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      x[q] = a.x; x[q + 1] = a.y; x[q + 2] = a.z; x[q + 3] = a.w;
    }
  } else if constexpr (TC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// One chunk of one head: y for rows c C .. c C + C - 1.
//
// A is built in sub-chunks of L steps.  Inside a sub-chunk (and for the
// u term) thread (t, g) walks s = t-1 down to the sub-chunk's start with
// q = r_t D_ts (q *= w_s after each s), leaving q = r_t E^a_t, E^a the
// running product from the start of t's sub-chunk a.  Below the diagonal
// blocks, for s in an earlier sub-chunk b, D_ts = R^b_s M_{b+1} .. M_{a-1}
// E^a_t, with R^b_s = prod_{s<q<end of b} w_q and M_j the product over
// sub-chunk j, so A_ts = (r_t E^a_t M_{a-1} .. M_{b+1}) . (k_s R^b_s): a
// dot product of two rows of shared memory.  The left rows start as q and
// are scaled by M_b after block column b (b from NB-2 down to 0); after
// M_0 they are r_t E_t.
template <typename T, int HD>
__global__ void __launch_bounds__(OUT_THREADS)
wkv_out(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ ws,
        T* __restrict__ y, int t_len, int h, int n_upd) {
  constexpr int NT = OUT_THREADS;
  constexpr int RS = pad<HD>();          // row stride of r, k, w
  constexpr int CPT = HD / 4;            // channels per thread, the walk
  constexpr int TC = HD / 16;            // y columns per thread, phase B
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);
  float* as = rs + C * RS;               // A, C x C
  float* ms = as + C * C;                // M_b, NB x HD
  float* ks = ms + NB * HD + (v_late<HD>() ? 0 : C * HD);
  float* wsm = ks + C * RS;
  float* s0 = ks;                        // S0 (HD x HD) from k on, later
  float* vs = v_late<HD>() ? ks + HD * HD : ms + NB * HD;

  const int c = blockIdx.x, bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int t0 = c * C;
  const int tid = threadIdx.x;
  const size_t t_stride = static_cast<size_t>(h) * HD;
  const size_t head = static_cast<size_t>(b) * t_len * t_stride + hh * HD;

  Stage<T, HD, NT> sv;
  {
    Stage<T, HD, NT, RS> st[3];
    st[0].load(r + head, t_stride, t0, t_len, rs, tid);
    st[1].load(k + head, t_stride, t0, t_len, ks, tid);
    st[2].load(w + head, t_stride, t0, t_len, wsm, tid);
    if (!v_late<HD>()) sv.load(v + head, t_stride, t0, t_len, vs, tid);
    st[0].store(rs, tid);
    st[1].store(ks, tid);
    st[2].store(wsm, tid);
    if (!v_late<HD>()) sv.store(vs, tid);
    cp_async_wait_all();
  }
  __syncthreads();

  // ---- phase A1: the u term, the diagonal blocks of A, r_t E^a_t
  {
    const int t = tid / 4, g = tid % 4, ch = g * CPT;
    float q[CPT];
    float d = 0.f;
#pragma unroll
    for (int m = 0; m < CPT; m += 4) {
      const float4 x = *reinterpret_cast<const float4*>(rs + t * RS + ch + m);
      const float4 kk = *reinterpret_cast<const float4*>(ks + t * RS + ch + m);
      const float4 uu = *reinterpret_cast<const float4*>(
          u + hh * HD + ch + m);
      q[m] = x.x; q[m + 1] = x.y; q[m + 2] = x.z; q[m + 3] = x.w;
      d = fmaf(x.x * uu.x, kk.x, d);
      d = fmaf(x.y * uu.y, kk.y, d);
      d = fmaf(x.z * uu.z, kk.z, d);
      d = fmaf(x.w * uu.w, kk.w, d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (g == 0) as[t * C + t] = d;
    for (int s = t + 1 + g; s < C; s += 4) as[t * C + s] = 0.f;

    // this warp's rows 8 (tid / 32) .. + 7 lie in one sub-chunk; s runs
    // warp-uniformly from the last row's predecessor to its start
    const int s_top = (tid / 32) * 8 + 6, s_lo = (tid / 32) * 8 / L * L;
    for (int s = s_top; s >= s_lo; --s) {
      const bool on = s < t;
      float pp[4] = {};                  // four short FMA chains
      if (on) {
#pragma unroll
        for (int m = 0; m < CPT; m += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(
              ks + s * RS + ch + m);
          const float4 ww = *reinterpret_cast<const float4*>(
              wsm + s * RS + ch + m);
          pp[0] = fmaf(q[m], kk.x, pp[0]);
          pp[1] = fmaf(q[m + 1], kk.y, pp[1]);
          pp[2] = fmaf(q[m + 2], kk.z, pp[2]);
          pp[3] = fmaf(q[m + 3], kk.w, pp[3]);
          q[m] *= ww.x; q[m + 1] *= ww.y; q[m + 2] *= ww.z; q[m + 3] *= ww.w;
        }
      }
      float p = (pp[0] + pp[1]) + (pp[2] + pp[3]);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (on && g == 0) as[t * C + s] = p;
    }
    // row t of rs is read by this thread only
#pragma unroll
    for (int m = 0; m < CPT; m += 4)
      *reinterpret_cast<float4*>(rs + t * RS + ch + m) =
          make_float4(q[m], q[m + 1], q[m + 2], q[m + 3]);
  }
  __syncthreads();

  // ---- phase A2: k_s R^b_s in place of k, and M_b (sub-chunks 0..NB-2)
  for (int idx = tid; idx < HD * (NB - 1); idx += NT) {
    const int i = idx % HD, sb = idx / HD;
    float kk[L], ww[L], rr = 1.f;
#pragma unroll
    for (int e = 0; e < L; ++e) {
      kk[e] = ks[(sb * L + e) * RS + i];
      ww[e] = wsm[(sb * L + e) * RS + i];
    }
#pragma unroll
    for (int e = L - 1; e >= 0; --e) {
      kk[e] *= rr;
      rr *= ww[e];
    }
#pragma unroll
    for (int e = 0; e < L; ++e) ks[(sb * L + e) * RS + i] = kk[e];
    ms[sb * HD + i] = rr;
  }
  __syncthreads();

  // ---- phase A3: the blocks below the diagonal, block column sb at a
  // time, rows (sb + 1) L .. C - 1
  for (int sb = NB - 2; sb >= 0; --sb) {
    const int row0 = (sb + 1) * L;
    for (int o = tid; o < (C - row0) * L; o += NT) {
      const int t = row0 + o / L, s = sb * L + o % L;
      float pp[4] = {};
#pragma unroll 8
      for (int i = 0; i < HD; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(rs + t * RS + i);
        const float4 kk = *reinterpret_cast<const float4*>(ks + s * RS + i);
        pp[0] = fmaf(x.x, kk.x, pp[0]);
        pp[1] = fmaf(x.y, kk.y, pp[1]);
        pp[2] = fmaf(x.z, kk.z, pp[2]);
        pp[3] = fmaf(x.w, kk.w, pp[3]);
      }
      as[t * C + s] = (pp[0] + pp[1]) + (pp[2] + pp[3]);
    }
    __syncthreads();
    for (int idx = tid; idx < (C - row0) * HD / 4; idx += NT) {
      const int t = row0 + idx / (HD / 4), i = idx % (HD / 4) * 4;
      float4* x = reinterpret_cast<float4*>(rs + t * RS + i);
      const float4 m = *reinterpret_cast<const float4*>(ms + sb * HD + i);
      *x = make_float4(x->x * m.x, x->y * m.y, x->z * m.z, x->w * m.w);
    }
    __syncthreads();                      // rs holds r E once sb = 0 is done
  }

  // k, w are free: S0 (and v) go there
  if (v_late<HD>()) {
    sv.load(v + head, t_stride, t0, t_len, vs, tid);
    sv.store(vs, tid);
  }
  if (c > 0) {
    const float* src = ws + (static_cast<size_t>(bh) * n_upd + c - 1)
                       * HD * HD;
    for (int idx = tid; idx < HD * HD / 4; idx += NT)
      cp_async16(s0 + 4 * idx, src + 4 * idx, true);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- phase B: y = [r E | A] . [S0 ; V], rows 4 rb .. + 3
  const int rb = tid / 16, cb = tid % 16, j0 = cb * TC;
  float acc[4][TC] = {};
  auto mac = [&](const float* arow, int ast, const float* brow, int kk) {
    // acc += arow[4 rows, kk .. kk + 3] . brow[kk .. kk + 3][j0 .. + TC)
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          arow + (4 * rb + i) * ast + kk);
      a[i][0] = x.x; a[i][1] = x.y; a[i][2] = x.z; a[i][3] = x.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float bv[TC];
      ld_row<TC>(brow + (kk + e) * HD + j0, bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < TC; ++jj)
          acc[i][jj] = fmaf(a[i][e], bv[jj], acc[i][jj]);
    }
  };
  if (c > 0) {
#pragma unroll 4
    for (int i = 0; i < HD; i += 4) mac(rs, RS, s0, i);
  }
  for (int s = 0; s <= 4 * rb; s += 4) mac(as, C, vs, s);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * rb + i;
    if (t < t_len) store_row<T, TC>(y + head + t * t_stride + j0, acc[i]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, void* y, float* ws,
                   int b, int t_len, int h, cudaStream_t stream) {
  const int n_chunks = (t_len + C - 1) / C, n_upd = n_chunks - 1;
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* wp = static_cast<const T*>(w);
  cudaError_t err;
  if (n_upd > 0) {
    const int bytes = state_floats<HD>() * 4;
    err = cudaFuncSetAttribute(wkv_state<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    wkv_state<T, HD><<<dim3(HD / jr<HD>(), b * h), state_threads<HD>(),
                        bytes, stream>>>(
        kp, vp, wp, ws, t_len, h, n_upd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int bytes = out_floats<HD>() * 4;
  err = cudaFuncSetAttribute(wkv_out<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  wkv_out<T, HD><<<dim3(n_chunks, b * h), OUT_THREADS, bytes, stream>>>(
      rp, kp, vp, wp, u, ws, static_cast<T*>(y), t_len, h, n_upd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* r, const void* k, const void* v,
                      const void* w, const float* u, void* y, float* ws,
                      int b, int t_len, int h, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, ws, b, t_len, h, s);
    case 32: return launch<T, 32>(r, k, v, w, u, y, ws, b, t_len, h, s);
    case 64: return launch<T, 64>(r, k, v, w, u, y, ws, b, t_len, h, s);
    case 128: return launch<T, 128>(r, k, v, w, u, y, ws, b, t_len, h, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- backward
//
// (dr, dk, dv, dw, du) of the function above for an output gradient dy,
// fp32 in and out, from the chunk states wkv_state wrote (S0 of chunk
// c + 1 in workspace slot c).  Per (batch, head), walking t = T-1 down to
// 0 with G = dL/dS_out (zero at T) and S_in the state before step t:
//
//     Gt_ij  = G_ij + u_i r_t_i dy_t_j              (dL/d(k_t^T v_t))
//     dr_t_i = sum_j dy_t_j S_in_ij + u_i k_t_i (dy_t . v_t)
//     dk_t_i = sum_j Gt_ij v_t_j
//     dv_t_j = sum_i Gt_ij k_t_i
//     dw_t_i = sum_j G_ij S_in_ij
//     du_i  += r_t_i k_t_i (dy_t . v_t)
//     G      = diag(w_t) G + r_t^T dy_t
//
// What bounds it: at the rwkv6-7b training shape (B 1, T 4096, H 64, hd
// 64) the function needs 15.3 GFLOP, 0.228 ms at 67 TFLOP/s, and moves
// 604 MB, 0.180 ms at 3.35 TB/s.  The first backward kernel (one block
// per 16-row tile of a head, 256 blocks) took 20x that: (1) each block
// walked all T steps, a chain of dependent loads, FMAs and shuffle trees
// whose latency, not the card's throughput, set the time; (2) S was
// stepped forward again from the chunk's start for every sub-chunk inside
// that chain, 2.5 steps a step; (3) every step read r, k, w, v, dy from
// global memory, unstaged; (4) dv, a sum down the rows, went out as a
// whole (B, T, H, hd) partial per row tile (268 MB) that a second kernel
// read back.  So the walk is cut at the chunks, and every chunk is walked
// at once:
//
// * `wkv_bwd_state` (wkv_state's walk, chunk_states with REV) writes G at
//   the end of every chunk but the last: with E_t = prod_{q<t} w_q over
//   the chunk's steps and P the chunk's product,
//       G_end(c-1) = diag(P_c) G_end(c) + (r_c E_c)^T dy_c,
//   kept as a compensated pair (with w = 1, G grows with T) and formed
//   from running products, never a quotient of w.  (B, H, ceil(T/C) - 1,
//   hd, hd) fp32 beside the forward's S0 states: its chain is
//   ceil(T/C) - 1 chunk updates, as the forward's state pass.
// * `wkv_bwd` (grid: hd/16 row tiles x chunks x B*H, clusters of the hd/16
//   tiles of one chunk; 256 threads) walks one chunk of 16 rows, so the
//   dependent chain is C = 64 steps: (1).  It stages the chunk's r, k, w
//   of its rows (then packed with u r into one 16-byte word a row and
//   step) and v, dy of every column in shared memory by cp.async (3),
//   steps S from the saved S0 once to keep S at the start of each
//   sub-chunk of SB = BWD_HIST / (hd/16) steps (a checkpoint per thread
//   in shared memory), then per sub-chunk, last first, steps SB - 1
//   states into registers from its checkpoint and walks the sub-chunk back
//   from G = G_end with the formulas above, two steps at a time so that
//   their shuffle trees overlap: 1.75 forward steps a step at hd 64,
//   bounded to the chunk (2).  Thread (row, lane) owns row i of S and G,
//   columns lane * hd/16 .. + hd/16 - 1; dk, dw and dr are three row sums
//   taken in one shuffle tree (xor 8 sends half the values, xor 4 half the
//   rest, then 2 and 1) and written a row tile at a time after the
//   sub-chunk; dv is summed over row pairs by one shuffle, over the block's
//   8 pairs in order after the sub-chunk (into v's rows, no longer read),
//   then over the cluster's row tiles in order from distributed shared
//   memory, each block summing C / tiles of the steps: no dv workspace (4).
//   G needs no compensation here: 64 steps from a compensated G_end round
//   as 64 steps do, not as T do.
// * `wkv_bwd_du` sums du's partials, one per (b, h, chunk) row, over the
//   chunks, then over the batch rows, in order.
//
// No atomics: two calls agree bit for bit.  dy . v of each step is taken
// once per block as a row sum of the same shape.
//
// What holds it now (kernels/rwkv6_scan/bench.py, NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md section 6): the G pass takes what the forward's state
// pass takes (0.175 ms), the chunk pass 1.63-1.66 ms, 8x the function's
// bound for the two.  Its --stamps put a block's life at ~27K clocks, two
// blocks an SM (109 registers, 100 KB of shared memory): the walks 37%,
// the barriers and stores after them 18%, staging and dy . v 15%, the
// forward stepping 12%, the checkpoint pass 9%, the cluster's dv 7%, du
// 3%.  No phase dominates; fewer instructions a step (one load for r, k,
// w, u r; du and dr's u term out of the walk), a shorter history and
// paired steps each moved it by 5% or less.  Next: persistent blocks that
// stage the next chunk during the walk, more columns a thread, or the
// chunk's products on the tensor cores.
constexpr int BWD_ROWS = 16;                   // rows of S and G a block
constexpr int BWD_LANES = 16;                  // threads a row
constexpr int BWD_THREADS = BWD_ROWS * BWD_LANES;
constexpr int BWD_HIST = 32;                   // S_in values a thread keeps
constexpr int BWD_PAIRS = BWD_ROWS / 2;
template <int HD> __host__ __device__ constexpr int bwd_cols() {
  return HD / BWD_LANES;                       // columns a thread
}
template <int HD> __host__ __device__ constexpr int bwd_sub() {
  return BWD_HIST / bwd_cols<HD>();            // steps a sub-chunk
}
template <int HD> __host__ __device__ constexpr int bwd_tiles() {
  return HD / BWD_ROWS;                        // row tiles: the cluster
}
// wkv_bwd's region of S's checkpoints, one per sub-chunk, where r, k, w
// are staged first (floats)
template <int HD> __host__ __device__ constexpr int bwd_ck() {
  return C / bwd_sub<HD>() * BWD_THREADS * bwd_cols<HD>() > 3 * C * BWD_ROWS
             ? C / bwd_sub<HD>() * BWD_THREADS * bwd_cols<HD>()
             : 3 * C * BWD_ROWS;
}
// wkv_bwd's shared memory (floats): r, k, w, u r of the tile's rows; v
// (then the tile's dv), dy; the checkpoints; dv's row pairs and dk, dw, dr
// of a sub-chunk; dy . v
template <int HD> __host__ __device__ constexpr int bwd_floats() {
  return 4 * C * BWD_ROWS + 2 * C * HD + bwd_ck<HD>()
         + bwd_sub<HD>() * (BWD_PAIRS * HD + 3 * BWD_ROWS) + C;
}

template <int HD>
__global__ void __launch_bounds__(state_threads<HD>())
wkv_bwd_state(const float* __restrict__ r, const float* __restrict__ dy,
              const float* __restrict__ w, float* __restrict__ gs,
              int t_len, int h, int n_upd) {
  chunk_states<float, HD, true>(r, dy, w, gs, t_len, h, n_upd);
}

// x[0 .. N) = p[0 .. N) from global memory, in 16- or 8-byte loads
template <int N>
__device__ __forceinline__ void ldg_row(const float* p, float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + q));
      x[q] = a.x; x[q + 1] = a.y; x[q + 2] = a.z; x[q + 3] = a.w;
    }
  } else if constexpr (N == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = __ldg(p);
  }
}

// p[0 .. N) = x[0 .. N) in shared memory, in 16- or 8-byte stores
template <int N>
__device__ __forceinline__ void st_row(float* p, const float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// the sum over a row's 16 lanes (every lane gets it)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// Three sums over a row's 16 lanes in five shuffles: lanes 0-3 get a's,
// 4-7 b's, 8-11 c's.  Each level adds the same pairs as row_sum (8, 4,
// 2, 1 apart), so each sum is row_sum's to the bit.
__device__ __forceinline__ float row_sum3(float a, float b, float c,
                                          int lane) {
  const bool h8 = lane & 8, h4 = lane & 4;
  float k0 = h8 ? c : a, k1 = h8 ? 0.f : b;
  k0 += __shfl_xor_sync(0xffffffffu, h8 ? a : c, 8);
  k1 += __shfl_xor_sync(0xffffffffu, h8 ? b : 0.f, 8);
  float x = h4 ? k1 : k0;
  x += __shfl_xor_sync(0xffffffffu, h4 ? k0 : k1, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// Phase clocks for kernels/rwkv6_scan/bench.py --stamps, in a build with
// -DRWKV6_BWD_STAMPS only: thread 0 of each block of (b, h) 0 adds
// clock64() deltas per phase (BWD_PHASES: staging and dy . v, the
// checkpoint pass, the sub-chunks' forward stepping, their walks, the
// barriers and stores after them, du, the cluster's dv) and writes them
// to bwd_stamps[(chunk * tiles + tile) * 8 + phase], chunks < 64; and
// each of the first BWD_BLOCKS blocks its SM and its first and last
// %globaltimer (ns) to bwd_blocks[3 * block], block = (bh * chunks +
// chunk) * tiles + tile.
constexpr int BWD_PHASES = 7;
constexpr int BWD_BLOCKS = 65536;
#ifdef RWKV6_BWD_STAMPS
__device__ long long bwd_stamps[64 * 8 * 8];
__device__ unsigned long long bwd_blocks[3 * BWD_BLOCKS];
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

// One chunk of 16 rows of one head (see the note above).  ss: the
// forward's S0 states, gs: G_end, both (B, H, n_upd, hd, hd); dup: du's
// partial of each (b, h, chunk), (B, H, n_chunks, hd).
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS, HD <= 64 ? 2 : 1)
wkv_bwd(const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ dy,
        const float* __restrict__ ss, const float* __restrict__ gs,
        float* __restrict__ dr, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dw,
        float* __restrict__ dup, int t_len, int h, int n_upd) {
  constexpr int CPT = bwd_cols<HD>(), SB = bwd_sub<HD>(), NSB = C / SB;
  constexpr int R = BWD_ROWS, NT = BWD_THREADS, TILES = bwd_tiles<HD>();
  extern __shared__ float4 smem4[];
  float4* rkw = smem4;                           // C x R: r, k, w, u r
  float* vs = reinterpret_cast<float*>(rkw + C * R);   // C x HD each
  float* ds = vs + C * HD;
  float* ck = ds + C * HD;                       // NSB x CPT x NT
  float* rs = ck;                                // r, k, w staged (C x R
  float* ks = rs + C * R;                        // each) where the
  float* wsm = ks + C * R;                       // checkpoints go later
  float* dvs = ck + bwd_ck<HD>();                // SB x PAIRS x HD
  float* out = dvs + SB * BWD_PAIRS * HD;        // SB x 3 x R: dk, dw, dr
  float* dyv = out + SB * 3 * R;                 // C

#ifdef RWKV6_BWD_STAMPS
  long long clk = clock64(), phase_clk[BWD_PHASES] = {};
  const unsigned long long ns0 = global_ns();
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.x, ch = blockIdx.y, bh = blockIdx.z;
  const int b = bh / h, hh = bh % h, t0 = ch * C;
  const int tid = threadIdx.x, row = tid / BWD_LANES, lane = tid % BWD_LANES;
  const int i = tile * R + row, j0 = lane * CPT;
  const size_t t_stride = static_cast<size_t>(h) * HD;
  const size_t head = static_cast<size_t>(b) * t_len * t_stride + hh * HD;

  {
    Stage<float, R, NT> st_r, st_k, st_w;
    Stage<float, HD, NT> st_v, st_d;
    st_r.load(r + head + tile * R, t_stride, t0, t_len, rs, tid);
    st_k.load(k + head + tile * R, t_stride, t0, t_len, ks, tid);
    st_w.load(w + head + tile * R, t_stride, t0, t_len, wsm, tid);
    st_v.load(v + head, t_stride, t0, t_len, vs, tid);
    st_d.load(dy + head, t_stride, t0, t_len, ds, tid);
  }
  float s[CPT], g[CPT];
  const size_t slot = static_cast<size_t>(bh) * n_upd * HD * HD
                      + static_cast<size_t>(i) * HD + j0;
  if (ch > 0) {
    ldg_row<CPT>(ss + slot + static_cast<size_t>(ch - 1) * HD * HD, s);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[c] = 0.f;
  }
  if (ch < n_upd) {
    ldg_row<CPT>(gs + slot + static_cast<size_t>(ch) * HD * HD, g);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) g[c] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  // a step's r, k, w and u r of each row in one 16-byte word
#pragma unroll
  for (int e = 0; e < C * R / NT; ++e) {
    const int idx = tid + e * NT, rr = idx % R;
    rkw[idx] = make_float4(rs[idx], ks[idx], wsm[idx],
                           __ldg(u + hh * HD + tile * R + rr) * rs[idx]);
  }

  // dy . v of every step: row `row` of the block takes steps row + 16 q
#pragma unroll
  for (int q = 0; q < C / R; ++q) {
    const int t = row + R * q;
    float vv[CPT], dd[CPT];
    ld_row<CPT>(vs + t * HD + j0, vv);
    ld_row<CPT>(ds + t * HD + j0, dd);
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) a = fmaf(dd[c], vv[c], a);
    a = row_sum(a);
    if (lane == 0) dyv[t] = a;
  }

  __syncthreads();                               // rkw; r, k, w read
  BWD_PHASE(0);
  // S = diag(w_t) S + k_t^T v_t on this thread's elements
  auto step = [&](int t) {
    const float4 p = rkw[t * R + row];
    float vv[CPT];
    ld_row<CPT>(vs + t * HD + j0, vv);
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[c] = fmaf(p.z, s[c], p.y * vv[c]);
  };
  float* mine = ck + tid;                        // [m][c] at (m CPT + c) NT
#pragma unroll
  for (int m = 0; m < NSB; ++m) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) mine[(m * CPT + c) * NT] = s[c];
    if (m + 1 < NSB) {
#pragma unroll
      for (int q = 0; q < SB; ++q) step(m * SB + q);
    }
  }
  __syncthreads();                               // dyv
  BWD_PHASE(1);

  for (int m = NSB - 1; m >= 0; --m) {
    const int ts0 = m * SB;                      // the sub-chunk's first step
    if (t0 + ts0 >= t_len) continue;             // the same for every thread
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[c] = mine[(m * CPT + c) * NT];
    float hist[SB][CPT];                         // S_in of the SB steps
#pragma unroll
    for (int q = 0; q < SB; ++q) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) hist[q][c] = s[c];
      if (q + 1 < SB) step(ts0 + q);
    }
    BWD_PHASE(2);

    // Two steps at a time, both steps' arithmetic before both shuffle
    // trees, in straight-line code so that the trees overlap: steps past
    // T (zeros in every staged array; G stays 0 through them, as it is at
    // the last chunk's end) are walked like the others and their sums not
    // written, and lanes 0, 4, 8 store the row's dk, dw, dr sums (dr
    // without its u term) to shared memory.
#pragma unroll
    for (int q2 = SB - 1; q2 >= 1; q2 -= 2) {
      float a_dk[2], a_dw[2], a_dr[2], dvv[2][CPT];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q2 - e, t = ts0 + q;
        const float4 p = rkw[t * R + row];       // r, k, w, u r
        float vv[CPT], dd[CPT];
        ld_row<CPT>(vs + t * HD + j0, vv);
        ld_row<CPT>(ds + t * HD + j0, dd);
        a_dk[e] = a_dw[e] = a_dr[e] = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float gt = fmaf(p.w, dd[c], g[c]);
          a_dk[e] = fmaf(gt, vv[c], a_dk[e]);
          dvv[e][c] = gt * p.y;
          a_dw[e] = fmaf(g[c], hist[q][c], a_dw[e]);
          a_dr[e] = fmaf(dd[c], hist[q][c], a_dr[e]);
          g[c] = fmaf(p.z, g[c], p.x * dd[c]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q2 - e;
        const float sum = row_sum3(a_dk[e], a_dw[e], a_dr[e], lane);
        if ((lane & 3) == 0 && lane < 12)
          out[(q * 3 + lane / 4) * R + row] = sum;
        float* dst = dvs + (q * BWD_PAIRS + row / 2) * HD + j0;
        if constexpr (CPT == 1) {
          const float x = dvv[e][0]
                          + __shfl_xor_sync(0xffffffffu, dvv[e][0], 16);
          if ((row & 1) == 0) *dst = x;
        } else {
          constexpr int HC = CPT / 2;
          const bool odd = row & 1;
          float keep[HC];
#pragma unroll
          for (int c = 0; c < HC; ++c)
            keep[c] = (odd ? dvv[e][c + HC] : dvv[e][c])
                      + __shfl_xor_sync(0xffffffffu,
                                        odd ? dvv[e][c] : dvv[e][c + HC], 16);
          st_row<HC>(dst + (odd ? HC : 0), keep);
        }
      }
    }
    BWD_PHASE(3);
    __syncthreads();
    // dk, dw, dr (with its u term) of the sub-chunk, a row tile's 16
    // channels at a time
#pragma unroll
    for (int e = 0; e < (SB * 3 * R + NT - 1) / NT; ++e) {
      const int idx = tid + e * NT;
      const int rr = idx % R, x = idx / R % 3, t = ts0 + idx / (3 * R);
      if (idx < SB * 3 * R && t0 + t < t_len) {
        const size_t p = head + static_cast<size_t>(t0 + t) * t_stride
                         + tile * R + rr;
        if (x == 0) {
          dk[p] = out[idx];
        } else if (x == 1) {
          dw[p] = out[idx];
        } else {
          dr[p] = fmaf(__ldg(u + hh * HD + tile * R + rr)
                       * rkw[t * R + rr].y, dyv[t], out[idx]);
        }
      }
    }
    // the tile's dv of the sub-chunk: the 8 row pairs in order, into v's
    // rows of the sub-chunk (the walk below reads earlier rows only)
#pragma unroll
    for (int e = 0; e < SB * HD / NT; ++e) {
      const int idx = tid + e * NT, q = idx / HD, jj = idx % HD;
      float sum = 0.f;
#pragma unroll
      for (int pp = 0; pp < BWD_PAIRS; ++pp)
        sum += dvs[(q * BWD_PAIRS + pp) * HD + jj];
      vs[(ts0 + q) * HD + jj] = sum;
    }
    __syncthreads();
    BWD_PHASE(4);
  }
  // du over the chunk's steps, last first
  if (tid < R) {
    float du_acc = 0.f;
#pragma unroll 8
    for (int t = C - 1; t >= 0; --t) {
      const float4 p = rkw[t * R + tid];
      du_acc = fmaf(p.x * p.y, dyv[t], du_acc);
    }
    dup[(static_cast<size_t>(bh) * gridDim.y + ch) * HD + tile * R + tid] =
        du_acc;
  }
  BWD_PHASE(5);

  // dv = the cluster's row tiles in order; this block writes steps
  // tile * C / TILES .. + C / TILES - 1 of the chunk
  cluster.sync();
  constexpr int TR = C / TILES;
  for (int idx = tid; idx < TR * HD / 4; idx += NT) {
    const int t = tile * TR + idx / (HD / 4), jj = idx % (HD / 4) * 4;
    if (t0 + t < t_len) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int rk = 0; rk < TILES; ++rk) {
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(vs, rk) + t * HD + jj);
        sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
      }
      *reinterpret_cast<float4*>(
          dv + head + static_cast<size_t>(t0 + t) * t_stride + jj) = sum;
    }
  }
  cluster.sync();                                // peers done reading
#ifdef RWKV6_BWD_STAMPS
  BWD_PHASE(6);
  if (tid == 0 && bh == 0 && ch < 64) {
    for (int k = 0; k < BWD_PHASES; ++k)
      bwd_stamps[(ch * TILES + tile) * 8 + k] = phase_clk[k];
  }
  const size_t blk = (static_cast<size_t>(bh) * gridDim.y + ch) * TILES
                     + tile;
  if (tid == 0 && blk < BWD_BLOCKS) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    bwd_blocks[3 * blk] = sm;
    bwd_blocks[3 * blk + 1] = ns0;
    bwd_blocks[3 * blk + 2] = global_ns();
  }
#endif
}

// du = per (h, channel), the chunks' partials summed in order, then the
// batch rows' (hhd = H hd).
__global__ void __launch_bounds__(256)
wkv_bwd_du(const float* __restrict__ dup, float* __restrict__ du, int b,
           int h, int hd, int n_chunks) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= h * hd) return;
  const int hh = q / hd, i = q % hd;
  float tot = 0.f;
  for (int bb = 0; bb < b; ++bb) {
    const float* p = dup + static_cast<size_t>(bb * h + hh) * n_chunks * hd
                     + i;
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += p[static_cast<size_t>(c) * hd];
    tot += s;
  }
  du[q] = tot;
}

template <int HD>
cudaError_t launch_bwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* dy,
                       const float* states, float* dr, float* dk, float* dv,
                       float* dw, float* du, float* ws, int b, int t_len,
                       int h, cudaStream_t stream) {
  const int n_chunks = (t_len + C - 1) / C, n_upd = n_chunks - 1;
  float* gs = ws;
  float* dup = ws + static_cast<size_t>(b) * h * n_upd * HD * HD;
  cudaError_t err;
  if (n_upd > 0) {
    const int bytes = state_floats<HD>() * 4;
    err = cudaFuncSetAttribute(wkv_bwd_state<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    wkv_bwd_state<HD><<<dim3(HD / jr<HD>(), b * h), state_threads<HD>(),
                         bytes, stream>>>(r, dy, w, gs, t_len, h, n_upd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int bytes = bwd_floats<HD>() * 4;
  err = cudaFuncSetAttribute(wkv_bwd<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bwd_tiles<HD>(), n_chunks, b * h);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = bwd_tiles<HD>();
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* gsc = gs;
  err = cudaLaunchKernelEx(&cfg, wkv_bwd<HD>, r, k, v, w, u, dy, states,
                           gsc, dr, dk, dv, dw, dup, t_len, h, n_upd);
  if (err != cudaSuccess) return err;
  wkv_bwd_du<<<(h * HD + 255) / 256, 256, 0, stream>>>(dup, du, b, h, HD,
                                                        n_chunks);
  return cudaGetLastError();
}

cudaError_t launch_bwd_hd(int hd, const float* r, const float* k,
                          const float* v, const float* w, const float* u,
                          const float* dy, const float* states, float* dr,
                          float* dk, float* dv, float* dw, float* du,
                          float* ws, int b, int t_len, int h,
                          cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<16>(r, k, v, w, u, dy, states, dr, dk, dv, dw,
                                   du, ws, b, t_len, h, s);
    case 32: return launch_bwd<32>(r, k, v, w, u, dy, states, dr, dk, dv, dw,
                                   du, ws, b, t_len, h, s);
    case 64: return launch_bwd<64>(r, k, v, w, u, dy, states, dr, dk, dv, dw,
                                   du, ws, b, t_len, h, s);
    case 128: return launch_bwd<128>(r, k, v, w, u, dy, states, dr, dk, dv,
                                     dw, du, ws, b, t_len, h, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory (bytes) of one block of a kernel at HD (see
// rwkv6_scan_smem_bytes).
template <int HD> int smem_of(int which) {
  switch (which) {
    case 0: return 4 * state_floats<HD>();
    case 1: return 4 * out_floats<HD>();
    case 2: return 4 * bwd_floats<HD>();
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Floats of the fp32 workspace a call needs: the incoming state of every
// chunk but the first, (b, h, ceil(t_len / C) - 1, hd, hd).
long long rwkv6_scan_workspace_floats(int b, int t_len, int h, int hd) {
  return static_cast<long long>(b) * h * ((t_len + C - 1) / C - 1) * hd * hd;
}

// Launches the kernels on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success).  dtype: 0 fp32, 1 bf16.
// r, k, v, w, y: (b, t_len, h, hd) contiguous in that dtype, 16-byte
// aligned; u: (h, hd) fp32; hd in {16, 32, 64, 128}; ws: fp32 workspace
// of ws_floats >= rwkv6_scan_workspace_floats(b, t_len, h, hd) floats.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* w, const void* u, void* y, void* ws,
                      long long ws_floats, int b, int t_len, int h, int hd,
                      int dtype, void* stream) {
  if (b <= 0 || t_len <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ws_floats < rwkv6_scan_workspace_floats(b, t_len, h, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* wsf = static_cast<float*>(ws);
  switch (dtype) {
    case 0: return static_cast<int>(launch_hd<float>(
        hd, r, k, v, w, uf, y, wsf, b, t_len, h, s));
    case 1: return static_cast<int>(launch_hd<__nv_bfloat16>(
        hd, r, k, v, w, uf, y, wsf, b, t_len, h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory (bytes) of one block of each kernel at hd
// (which: 0 the state passes, the forward's and the backward's G pass; 1
// the output pass; 2 the backward's chunk pass, wkv_bwd); -1 if not built.
int rwkv6_scan_smem_bytes(int hd, int which) {
  switch (hd) {
    case 16: return smem_of<16>(which);
    case 32: return smem_of<32>(which);
    case 64: return smem_of<64>(which);
    case 128: return smem_of<128>(which);
    default: return -1;
  }
}

// Floats of the fp32 workspace the backward needs: G at the end of every
// chunk but the last, (b, h, ceil(t_len / C) - 1, hd, hd), then du's
// partials, (b, h, ceil(t_len / C), hd).
long long rwkv6_scan_bwd_workspace_floats(int b, int t_len, int h, int hd) {
  const long long n_chunks = (t_len + C - 1) / C;
  return static_cast<long long>(b) * h * (n_chunks - 1) * hd * hd
         + static_cast<long long>(b) * h * n_chunks * hd;
}

// Launches the backward (wkv_bwd_state, wkv_bwd, wkv_bwd_du) on `stream`
// and returns the cudaError_t of the launch (0 on success).  fp32 only.
// r, k, v, w, dy, dr, dk, dv, dw: (b, t_len, h, hd) contiguous, 16-byte
// aligned; u, du: (h, hd); states: the forward's workspace (chunk states,
// rwkv6_scan_workspace_floats floats); ws: fp32 workspace of ws_floats >=
// rwkv6_scan_bwd_workspace_floats(b, t_len, h, hd) floats.
int rwkv6_scan_bwd_launch(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* dy,
                          const void* states, void* dr, void* dk, void* dv,
                          void* dw, void* du, void* ws, long long ws_floats,
                          int b, int t_len, int h, int hd, void* stream) {
  if (b <= 0 || t_len <= 0 || h <= 0 || b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ws_floats < rwkv6_scan_bwd_workspace_floats(b, t_len, h, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  return static_cast<int>(launch_bwd_hd(
      hd, f(r), f(k), f(v), f(w), f(u), f(dy), f(states), o(dr), o(dk),
      o(dv), o(dw), o(du), o(ws), b, t_len, h,
      static_cast<cudaStream_t>(stream)));
}

// Copies the backward's phase clocks (see BWD_PHASE) into `out` (64 * 8 *
// 8 long longs) and its blocks' SMs and times into `blocks` (3 *
// BWD_BLOCKS); -1 in a build without -DRWKV6_BWD_STAMPS.
int rwkv6_scan_bwd_stamps(long long* out, unsigned long long* blocks) {
#ifdef RWKV6_BWD_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(out, bwd_stamps,
                                         sizeof(bwd_stamps));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(blocks, bwd_blocks, sizeof(bwd_blocks));
  return static_cast<int>(err);
#else
  (void)out;
  (void)blocks;
  return -1;
#endif
}

const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
