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
#include <cstdint>

namespace {

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

// One head's chunk updates: S0 of chunk c + 1 -> ws slot c, for c = 0 ..
// n_upd - 1 (every such chunk is full).  A block owns rows row0 .. row0 +
// JR - 1 of S (it reads k and w of those channels only, and all of v);
// thread (rg, cp) owns rows row0 + 4 rg .. + 3 and columns 2 cp, 2 cp + 1.
template <typename T, int HD>
__global__ void __launch_bounds__(state_threads<HD>())
wkv_state(const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ w, float* __restrict__ ws, int t_len, int h,
          int n_upd) {
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
  auto load = [&](int c, float* buf) {
    sk.load(k + head + row0, t_stride, c * C, t_len, buf, tid);
    sw.load(w + head + row0, t_stride, c * C, t_len, buf + C * JR, tid);
    sv.load(v + head, t_stride, c * C, t_len, buf + 2 * C * JR, tid);
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
  for (int c = 0; c < n_upd; ++c) {
    float* kb = smem + (c & 1) * BUF;
    const float* wb = kb + C * JR;
    const float* vb = kb + 2 * C * JR;
    if (c + 1 < n_upd) load(c + 1, smem + ((c + 1) & 1) * BUF);

    if (tid < JR) {                  // k R and P, running products
      float rr = 1.f;
      // 16 steps at a time through registers: stores into kb between
      // loads of wb would serialise every step on shared memory
      for (int t1 = C - 16; t1 >= 0; t1 -= 16) {
        float kk[16], ww[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          kk[m] = kb[(t1 + m) * JR + tid];
          ww[m] = wb[(t1 + m) * JR + tid];
        }
#pragma unroll
        for (int m = 15; m >= 0; --m) {
          kk[m] *= rr;
          rr *= ww[m];
        }
#pragma unroll
        for (int m = 0; m < 16; ++m) kb[(t1 + m) * JR + tid] = kk[m];
      }
      pw[tid] = rr;
    }
    __syncthreads();

    // S = P S + (k R)^T v with S held as s - e (Kahan; see the top note):
    // the scaling's exact rounding error goes into e (an FMA gives it),
    // then each L-step partial sum of (k R)^T v is added with
    // compensation.  The _rn intrinsics keep the compiler from fusing.
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
        const float4 a = *reinterpret_cast<const float4*>(
            kb + t * JR + 4 * rg);
        const float2 x = *reinterpret_cast<const float2*>(
            vb + t * HD + 2 * cp);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[i][0] = fmaf(av[i], x.x, d[i][0]);
          d[i][1] = fmaf(av[i], x.y, d[i][1]);
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
    float* slot = ws + (static_cast<size_t>(bh) * n_upd + c) * HD * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(slot + (row0 + 4 * rg + i) * HD + 2 * cp) =
          make_float2(__fsub_rn(s[i][0], e[i][0]),
                      __fsub_rn(s[i][1], e[i][1]));

    if (c + 1 < n_upd) store(smem + ((c + 1) & 1) * BUF);
    cp_async_wait_all();
    __syncthreads();
  }
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
// Rows are independent: row i of S and of G reads w, k, r of channel i
// only (and all of v and dy).  So `wkv_bwd` (grid: hd/16 row tiles x B*H,
// 256 threads) gives each block 16 rows and each row 16 threads of hd/16
// columns.  dr, dk, dw and dy.v are sums along a row: a chain of FMAs per
// thread, then xor shuffles over the row's 16 lanes.  dv is a sum down
// the rows: a row pair by one shuffle, then the block's 8 pairs in order
// from shared memory, written as one partial per row tile.  du is summed
// over t per (b, h, row).  `wkv_bwd_reduce` then sums the row tiles' dv
// partials and the batch rows' du in a fixed order.  No atomics: two
// calls agree bit for bit.
//
// S_in comes from the saved chunk states: per chunk (last first) and per
// sub-chunk of SB = 64 / (hd/16) steps (last first), S is stepped forward
// in fp32 from the chunk's S0 to the sub-chunk's start, then its SB
// states are kept in registers and the sub-chunk is walked back.  No step
// is undone by dividing by w (w = 0 and denormal w are inputs).  G is
// kept as a compensated pair g - e, as wkv_state keeps S: with w = 1 it
// grows with T.
//
// What bounds it: at the rwkv6-7b training shape (B 1, T 4096, H 64, hd
// 64) the function needs 15.3 GFLOP (0.228 ms at 67 TFLOP/s) and moves
// 604 MB (0.180 ms at 3.35 TB/s), but this first kernel is a walk of T
// dependent steps in each block, with the forward recompute on top (2.5
// steps a step at hd 64): latency, not throughput, holds it (PERF.md §6).
// Inputs are read straight from global memory (L1/L2), not staged.
constexpr int BWD_ROWS = 16;                   // rows of S and G a block
constexpr int BWD_LANES = 16;                  // threads a row
constexpr int BWD_THREADS = BWD_ROWS * BWD_LANES;
constexpr int BWD_HIST = 64;                   // S_in values a thread keeps
constexpr int BWD_PAIRS = BWD_ROWS / 2;
template <int HD> __host__ __device__ constexpr int bwd_cols() {
  return HD / BWD_LANES;                       // columns a thread
}
template <int HD> __host__ __device__ constexpr int bwd_sub() {
  return BWD_HIST / bwd_cols<HD>();            // steps a sub-chunk
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

// the sum over a row's 16 lanes (every lane gets it)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// Thread (row, lane) owns row i = 16 tile + row of S and G, columns
// j0 = lane CPT .. + CPT - 1.  dvp: one (B, T, H, hd) partial per row
// tile; dup: (B, H, hd).
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS)
wkv_bwd(const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ dy,
        const float* __restrict__ ws, float* __restrict__ dr,
        float* __restrict__ dk, float* __restrict__ dw,
        float* __restrict__ dvp, float* __restrict__ dup, int t_len, int h,
        int n_upd) {
  constexpr int CPT = bwd_cols<HD>(), SB = bwd_sub<HD>(), NSB = C / SB;
  __shared__ __align__(16) float dvs[SB * BWD_PAIRS * HD];

  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int tid = threadIdx.x, row = tid / BWD_LANES, lane = tid % BWD_LANES;
  const int i = tile * BWD_ROWS + row, j0 = lane * CPT;
  const size_t t_stride = static_cast<size_t>(h) * HD;
  const size_t head = static_cast<size_t>(b) * t_len * t_stride + hh * HD;
  const size_t plane = static_cast<size_t>(gridDim.y) * t_len * HD;
  const float ui = u[hh * HD + i];

  // S = diag(w_t) S + k_t^T v_t on this thread's elements
  auto step = [&](float* s, int t) {
    const size_t p = head + static_cast<size_t>(t) * t_stride;
    const float ki = __ldg(k + p + i), wi = __ldg(w + p + i);
    float vv[CPT];
    ldg_row<CPT>(v + p + j0, vv);
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[c] = fmaf(wi, s[c], ki * vv[c]);
  };

  float g[CPT], ge[CPT];                       // G = g - ge
#pragma unroll
  for (int c = 0; c < CPT; ++c) g[c] = ge[c] = 0.f;
  float du_acc = 0.f;
  for (int ch = n_upd; ch >= 0; --ch) {
    const int t0 = ch * C;
    for (int m = NSB - 1; m >= 0; --m) {
      const int ts0 = t0 + m * SB;             // the sub-chunk's first step
      if (ts0 >= t_len) continue;              // the same for every thread
      float s[CPT];
      if (ch > 0) {
        ldg_row<CPT>(ws + (static_cast<size_t>(bh) * n_upd + ch - 1) * HD
                     * HD + i * HD + j0, s);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[c] = 0.f;
      }
#pragma unroll 4
      for (int t = t0; t < ts0; ++t) step(s, t);
      float hist[SB][CPT];                     // S_in of the SB steps
#pragma unroll
      for (int q = 0; q < SB; ++q) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) hist[q][c] = s[c];
        if (q + 1 < SB && ts0 + q < t_len) step(s, ts0 + q);
      }

#pragma unroll
      for (int q = SB - 1; q >= 0; --q) {
        const int t = ts0 + q;
        if (t >= t_len) continue;              // the same for every thread
        const size_t p = head + static_cast<size_t>(t) * t_stride;
        const float ri = __ldg(r + p + i), ki = __ldg(k + p + i);
        const float wi = __ldg(w + p + i);
        float vv[CPT], dd[CPT], dvv[CPT];
        ldg_row<CPT>(v + p + j0, vv);
        ldg_row<CPT>(dy + p + j0, dd);
        const float uri = ui * ri;
        float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f, a_dyv = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float gv = __fsub_rn(g[c], ge[c]);
          const float gt = fmaf(uri, dd[c], gv);
          a_dk = fmaf(gt, vv[c], a_dk);
          dvv[c] = gt * ki;
          a_dw = fmaf(gv, hist[q][c], a_dw);
          a_dr = fmaf(dd[c], hist[q][c], a_dr);
          a_dyv = fmaf(dd[c], vv[c], a_dyv);
        }
        a_dr = row_sum(a_dr);
        a_dk = row_sum(a_dk);
        a_dw = row_sum(a_dw);
        a_dyv = row_sum(a_dyv);
        if (lane == 0) {
          dr[p + i] = fmaf(ui * ki, a_dyv, a_dr);
          dk[p + i] = a_dk;
          dw[p + i] = a_dw;
        }
        du_acc = fmaf(ri * ki, a_dyv, du_acc);
        // rows 2 w and 2 w + 1 share warp w: one shuffle sums the pair
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          dvv[c] += __shfl_xor_sync(0xffffffffu, dvv[c], 16);
        if ((row & 1) == 0) {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            dvs[(q * BWD_PAIRS + row / 2) * HD + j0 + c] = dvv[c];
        }
        // G = diag(w) G + r^T dy, compensated: the scaling's exact
        // rounding error goes into ge (an FMA gives it), then r dy is
        // added with Kahan's correction; the _rn intrinsics keep the
        // compiler from fusing
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float hi = __fmul_rn(wi, g[c]);
          ge[c] = fmaf(wi, ge[c], -fmaf(wi, g[c], -hi));
          g[c] = hi;
          const float yv = __fsub_rn(__fmul_rn(ri, dd[c]), ge[c]);
          const float tv = __fadd_rn(g[c], yv);
          ge[c] = __fsub_rn(__fsub_rn(tv, g[c]), yv);
          g[c] = tv;
        }
      }
      __syncthreads();
      // dv of this row tile for the sub-chunk: the 8 row pairs in order
      for (int idx = tid; idx < SB * HD; idx += BWD_THREADS) {
        const int q = idx / HD, jj = idx % HD, t = ts0 + q;
        if (t < t_len) {
          float sum = 0.f;
#pragma unroll
          for (int pp = 0; pp < BWD_PAIRS; ++pp)
            sum += dvs[(q * BWD_PAIRS + pp) * HD + jj];
          dvp[tile * plane + head + static_cast<size_t>(t) * t_stride + jj] =
              sum;
        }
      }
      __syncthreads();
    }
  }
  if (lane == 0) dup[static_cast<size_t>(bh) * HD + i] = du_acc;
}

// dv = the row tiles' partials summed in order (n4: plane / 4 float4s a
// partial); du = the batch rows' partials summed in order (hhd = H hd).
__global__ void __launch_bounds__(256)
wkv_bwd_reduce(const float4* __restrict__ dvp, const float* __restrict__ dup,
               float4* __restrict__ dv, float* __restrict__ du, long long n4,
               int tiles, int b, int hhd) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x
                          + threadIdx.x;
  for (long long q = first; q < n4; q += stride) {
    float4 s = __ldg(dvp + q);
    for (int tl = 1; tl < tiles; ++tl) {
      const float4 x = __ldg(dvp + tl * n4 + q);
      s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
    }
    dv[q] = s;
  }
  for (long long q = first; q < hhd; q += stride) {
    float s = dup[q];
    for (int bb = 1; bb < b; ++bb) s += dup[static_cast<long long>(bb) * hhd
                                            + q];
    du[q] = s;
  }
}

template <int HD>
cudaError_t launch_bwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* dy,
                       const float* states, float* dr, float* dk, float* dv,
                       float* dw, float* du, float* ws, int b, int t_len,
                       int h, cudaStream_t stream) {
  const int n_upd = (t_len + C - 1) / C - 1, tiles = HD / BWD_ROWS;
  const long long plane = static_cast<long long>(b) * t_len * h * HD;
  float* dvp = ws;
  float* dup = ws + tiles * plane;
  wkv_bwd<HD><<<dim3(tiles, b * h), BWD_THREADS, 0, stream>>>(
      r, k, v, w, u, dy, states, dr, dk, dw, dvp, dup, t_len, h, n_upd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n4 = plane / 4;
  const long long want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? (want > 0 ? want : 1)
                                                  : 4096);
  wkv_bwd_reduce<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dvp), dup, reinterpret_cast<float4*>(dv),
      du, n4, tiles, b, h * HD);
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
// (which: 0 the state pass, 1 the output pass; either dtype); -1 if not
// built.
int rwkv6_scan_smem_bytes(int hd, int which) {
  switch (hd) {
    case 16: return 4 * (which ? out_floats<16>() : state_floats<16>());
    case 32: return 4 * (which ? out_floats<32>() : state_floats<32>());
    case 64: return 4 * (which ? out_floats<64>() : state_floats<64>());
    case 128: return 4 * (which ? out_floats<128>() : state_floats<128>());
    default: return -1;
  }
}

// Floats of the fp32 workspace the backward needs: one (b, t_len, h, hd)
// dv partial per 16-row tile of the state, and (b, h, hd) du partials.
long long rwkv6_scan_bwd_workspace_floats(int b, int t_len, int h, int hd) {
  return static_cast<long long>(hd / BWD_ROWS) * b * t_len * h * hd
         + static_cast<long long>(b) * h * hd;
}

// Launches the backward (wkv_bwd, then wkv_bwd_reduce) on `stream` and
// returns the cudaError_t of the launch (0 on success).  fp32 only.
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

const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
