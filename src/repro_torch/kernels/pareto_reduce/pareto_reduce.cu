// Exact Pareto reduction of a sweep chunk's filter survivors on Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package does this step on the host, in
// repro.core.pareto.ParetoArchive.insert: every chunk's filter survivors
// are copied off the device and screened there, in numpy on one thread,
// against each other and against the archive.  Over 99% of them are
// dominated, and on a sweep's first chunk (tens of thousands of survivors,
// an empty archive) the host screening took most of the chunk while the
// card idled.  This kernel screens them where they already are, and only
// the rows that enter the front, with the archive rows they dominate, go
// to the host, which then just applies them (ParetoArchive.apply).
//
// Given the chunk's rows ys (c, 3) with a keep mask marking the candidates
// (the survivors), and the archive's rows front (f, 3), it finds
//   enter: the candidates that no other candidate and no front row
//          dominates,
//   dead:  the front rows that an entering candidate dominates,
// with ParetoArchive's rule: a dominates b when a <= b in every objective
// and a < b in at least one.  Equal rows never dominate each other.  A
// comparison with NaN is false, as numpy's is, so a row holding NaN
// neither dominates nor is dominated.  Only comparisons: bit-exact flags
// (NVCC_FLAGS), the same that ParetoArchive.insert finds on the same
// values in float64.
//
// Outputs, in device memory: head (2 + f) int32 = [n candidates, m
// entering, dead flag of each front row], and out (c, 4) int32 whose first
// m rows are the entering rows, (the three objectives' float bits, id), in
// no particular order (the host orders them by id).
//
// What bounds it on an H100: pair tests, one per (candidate, possible
// dominator), each six compares and five logic operations.  A candidate
// has to meet one dominator, or all rows that could dominate it when none
// does.  The design aims at that least:
//  - Sort by a monotone key.  key = (y0 w0 + y1 w1) + y2 w2 in fp32 with
//    positive weights (the caller's scale of each objective), NaN mapped to
//    +inf and clamped to FLT_MAX, non-candidates +inf.  Rounding is
//    monotone, so a dominator's key is <= the dominated row's: a candidate
//    need only scan the rows sorted before it and its ties, and stops at
//    the first row whose key is larger.  Rows with small weighted sums,
//    good on every objective, come first: they dominate most candidates,
//    which then exit within a few rows.  torch.sort sorts the keys; the
//    candidates are the first n sorted rows (non-candidates sort last).
//  - One thread per sorted candidate, consecutive candidates in a warp:
//    their keys and so their scan lengths are close, every lane reads the
//    same row at the same step (one broadcast load), and four rows are
//    loaded before they are tested, so the loads overlap.
//  - The front rows (the archive: strong, at most its capacity) are tested
//    first.  The dead flags are a second pass, one thread per front row,
//    over the m entering rows, which are few.
//  - Entering rows are appended through one atomic counter, so the host
//    copies m rows rather than a mask over the chunk.
// Measured on an H100 (bench.py; PERF.md), a sweep's first chunk (52,358
// survivors, an empty archive) takes 2.8 ms, far above the least work: a
// survivor near the front has few dominators, met only after ~half the
// rows sorted before it, so the scans grow as n^2.  Later chunks (at most
// a few thousand survivors) take 0.1-0.25 ms, mostly the sort of every
// row's key.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads per block, a row each
constexpr int kUnroll = 4;              // rows loaded before they are tested

__device__ __forceinline__ bool dominates(float a0, float a1, float a2,
                                          float b0, float b1, float b2) {
  return (a0 <= b0) & (a1 <= b1) & (a2 <= b2)
         & ((a0 < b0) | (a1 < b1) | (a2 < b2));
}

// key[i]: the weighted sum of row i, NaN -> +inf, clamped to FLT_MAX; +inf
// for a row the mask leaves out
__global__ void __launch_bounds__(kThreads)
key_kernel(const float* __restrict__ ys, const uint8_t* __restrict__ keep,
           long long c, float w0, float w1, float w2,
           float* __restrict__ key) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= c) return;
  float k = INFINITY;
  if (keep[i]) {
    k = (ys[3 * i] * w0 + ys[3 * i + 1] * w1) + ys[3 * i + 2] * w2;
    k = isnan(k) ? FLT_MAX : fminf(k, FLT_MAX);
  }
  key[i] = k;
}

// rows[t] = (sorted row t, its key) and rid[t] its id for every candidate;
// head[0] = n (the candidates: sorted keys below +inf), head[1] = 0
__global__ void __launch_bounds__(kThreads)
stage_kernel(const float* __restrict__ ys, const float* __restrict__ skey,
             const long long* __restrict__ perm,
             const int* __restrict__ ids, long long c,
             float4* __restrict__ rows, int* __restrict__ rid,
             int* __restrict__ head) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (t == 0) head[1] = 0;
  if (t >= c) return;
  const float k = skey[t];
  if (k == INFINITY) {
    if (t == 0) head[0] = 0;
    return;
  }
  if (t + 1 == c || skey[t + 1] == INFINITY) head[0] = static_cast<int>(t + 1);
  const long long p = perm[t];
  rows[t] = make_float4(ys[3 * p], ys[3 * p + 1], ys[3 * p + 2], k);
  rid[t] = ids[p];
}

// one thread per sorted candidate: the front rows, then the sorted rows up
// to the first with a larger key; an entering row is appended to out
__global__ void __launch_bounds__(kThreads)
enter_kernel(const float4* __restrict__ rows, const int* __restrict__ rid,
             const float* __restrict__ front, int f,
             int* __restrict__ head, int4* __restrict__ out) {
  const int n = head[0];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const float4 me = rows[t];
  bool dom = false;
  for (int j = 0; j < f && !dom; ++j) {
    dom = dominates(front[3 * j], front[3 * j + 1], front[3 * j + 2],
                    me.x, me.y, me.z);
  }
  for (int j = 0; j < n && !dom; j += kUnroll) {
    float4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = rows[min(j + u, n - 1)];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dom |= dominates(r[u].x, r[u].y, r[u].z, me.x, me.y, me.z);
    }
    if (r[kUnroll - 1].w > me.w) break;   // later rows' keys are larger
  }
  if (dom) return;
  const int slot = atomicAdd(&head[1], 1);
  out[slot] = make_int4(__float_as_int(me.x), __float_as_int(me.y),
                        __float_as_int(me.z), rid[t]);
}

// one thread per front row: dominated by one of the m entering rows?
__global__ void __launch_bounds__(kThreads)
dead_kernel(const float* __restrict__ front, int f,
            const int4* __restrict__ out, int* __restrict__ head) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= f) return;
  const int m = head[1];
  const float b0 = front[3 * r], b1 = front[3 * r + 1], b2 = front[3 * r + 2];
  bool dead = false;
  for (int i = 0; i < m && !dead; ++i) {
    const int4 o = out[i];
    dead = dominates(__int_as_float(o.x), __int_as_float(o.y),
                     __int_as_float(o.z), b0, b1, b2);
  }
  head[2 + r] = dead ? 1 : 0;
}

int blocks(long long rows) {
  return static_cast<int>((rows + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Both launch on `stream`, which must belong to the calling thread's current
// device, and return the cudaError_t of their last launch (0 on success).
// Neither synchronises.
//
// ys: (c, 3) fp32 rows; keep: c bytes (0 or 1);
// w0..w2: the key's positive, finite weights; key: (c,) fp32 out.
int pareto_key_launch(const float* ys, const uint8_t* keep, long long c,
                      float w0, float w1, float w2, float* key,
                      void* stream) {
  if (c <= 0) return 0;
  if (c > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  key_kernel<<<blocks(c), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ys, keep, c, w0, w1, w2, key);
  return static_cast<int>(cudaGetLastError());
}

// skey, perm: the keys sorted ascending and their positions (torch.sort);
// ids: (c,) int32; front: (f, 3) fp32; scratch
// rows (c, 4) fp32 and rid (c,) int32; out: (c, 4) int32; head: (2 + f,)
// int32.  Stages the sorted candidates, finds the entering rows, then the
// dead front rows.
int pareto_reduce_launch(const float* ys, const float* skey,
                         const long long* perm, const int* ids, long long c,
                         const float* front, int f, float* rows, int* rid,
                         int* out, int* head, void* stream) {
  if (c <= 0 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (c > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stage_kernel<<<blocks(c), kThreads, 0, s>>>(
      ys, skey, perm, ids, c, reinterpret_cast<float4*>(rows), rid, head);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  enter_kernel<<<blocks(c), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(rows), rid, front, f, head,
      reinterpret_cast<int4*>(out));
  e = cudaGetLastError();
  if (e != cudaSuccess || f == 0) return static_cast<int>(e);
  dead_kernel<<<blocks(f), kThreads, 0, s>>>(
      front, f, reinterpret_cast<const int4*>(out), head);
  return static_cast<int>(cudaGetLastError());
}

const char* pareto_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
