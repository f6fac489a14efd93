// tile_scan.cuh — the tiled scan shared by the device merge's kernels
// (running_fill.cu, tail_good_join.cu, run_merge.cu) on Hopper (sm_90a).
//
// A scan runs in three launches over tiles of rows, the same structure as
// dense_neighbors.cu:
//   1. reduce: each tile folds its rows into one aggregate;
//   2. carry:  one block scans the tiles' aggregates in scan order into
//              each tile's exclusive carry (carry[tiles] = the fold of
//              every tile);
//   3. emit:   each tile scans its rows again from its carry and writes.
// Inside a tile a thread folds its consecutive items in registers, a warp
// scans its 32 thread states with 5 shuffle steps, and warp 0 scans the
// warps' totals the same way. Nothing spins on another block, so no
// launch order can stall a scan, and the result does not depend on the
// tile size.
//
// A scan state S is a struct of 32-bit words (it is shuffled word by
// word); an Op gives
//   static S identity();
//   static S combine(const S& x, const S& y);   // x before y in scan order
// with combine associative. A BWD scan runs from the last row to the
// first: lane 31 before lane 0, the last warp first, the last tile first,
// and a thread's items from its last to its first.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_scan {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CARRY_THREADS = 1024;
constexpr int CARRY_ITEMS = 4;

template <class S>
__device__ __forceinline__ S shfl_idx(const S& x, int src) {
  static_assert(sizeof(S) % 4 == 0, "scan states are 32-bit words");
  S y;
  const int* a = reinterpret_cast<const int*>(&x);
  int* b = reinterpret_cast<int*>(&y);
#pragma unroll
  for (int i = 0; i < int(sizeof(S) / 4); ++i)
    b[i] = __shfl_sync(FULL, a[i], src);
  return y;
}

// the state of the lane d places earlier in scan order
template <bool BWD, class S>
__device__ __forceinline__ S shfl_prev(const S& x, int d) {
  static_assert(sizeof(S) % 4 == 0, "scan states are 32-bit words");
  S y;
  const int* a = reinterpret_cast<const int*>(&x);
  int* b = reinterpret_cast<int*>(&y);
#pragma unroll
  for (int i = 0; i < int(sizeof(S) / 4); ++i)
    b[i] = BWD ? __shfl_down_sync(FULL, a[i], d)
               : __shfl_up_sync(FULL, a[i], d);
  return y;
}

// Warp scan of the lanes' states in scan order: returns this lane's
// exclusive prefix and sets *total to the fold of all 32 lanes.
template <bool BWD, class Op, class S>
__device__ __forceinline__ S warp_scan(S x, S* total) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S y = shfl_prev<BWD>(x, d);
    if (BWD ? lane + d < 32 : lane >= d) x = Op::combine(y, x);
  }
  S ex = shfl_prev<BWD>(x, 1);
  if (lane == (BWD ? 31 : 0)) ex = Op::identity();
  *total = shfl_idx(x, BWD ? 0 : 31);
  return ex;
}

// Block scan of one state per thread in scan order: returns this thread's
// exclusive prefix, starting from ``carry``; *total is the fold of the
// block's states (without the carry). ``wagg`` is shared memory for 33
// states; blockDim.x is a multiple of 32, at most 1024.
template <bool BWD, class Op, class S>
__device__ __forceinline__ S block_scan(S x, const S& carry, S* wagg,
                                        S* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  S wtot;
  const S ex = warp_scan<BWD, Op>(x, &wtot);
  if (lane == 0) wagg[warp] = wtot;
  __syncthreads();
  if (warp == 0) {
    // the identity lanes past nwarps come last forward and first
    // backward: they change nothing
    const S w = lane < nwarps ? wagg[lane] : Op::identity();
    S all;
    const S wex = warp_scan<BWD, Op>(w, &all);
    if (lane < nwarps) wagg[lane] = Op::combine(carry, wex);
    if (lane == 0) wagg[32] = all;
  }
  __syncthreads();
  const S r = Op::combine(wagg[warp], ex);
  *total = wagg[32];
  __syncthreads();  // wagg is reused by the next scan
  return r;
}

// Launch 2: one block of CARRY_THREADS turns ``tiles`` aggregates into
// exclusive carries in scan order, CARRY_ITEMS per thread per round;
// carry[tiles] is the fold of all of them.
template <bool BWD, class Op, class S>
__global__ void __launch_bounds__(CARRY_THREADS)
    carry_kernel(const S* __restrict__ agg, S* __restrict__ carry,
                 int tiles) {
  __shared__ S wagg[33];
  constexpr int CH = CARRY_THREADS * CARRY_ITEMS;
  const int rounds = (tiles + CH - 1) / CH;
  S run = Op::identity();
  for (int c = 0; c < rounds; ++c) {
    const int base = (BWD ? rounds - 1 - c : c) * CH
                     + threadIdx.x * CARRY_ITEMS;
    S it[CARRY_ITEMS];
    S acc = Op::identity();
#pragma unroll
    for (int q = 0; q < CARRY_ITEMS; ++q) {
      const int j = BWD ? CARRY_ITEMS - 1 - q : q;
      it[j] = base + j < tiles ? agg[base + j] : Op::identity();
      acc = Op::combine(acc, it[j]);
    }
    S tot;
    S ex = block_scan<BWD, Op>(acc, run, wagg, &tot);
#pragma unroll
    for (int q = 0; q < CARRY_ITEMS; ++q) {
      const int j = BWD ? CARRY_ITEMS - 1 - q : q;
      if (base + j < tiles) carry[base + j] = ex;
      ex = Op::combine(ex, it[j]);
    }
    run = Op::combine(run, tot);
  }
  if (threadIdx.x == 0) carry[tiles] = run;
}

// 16-byte loads and stores of consecutive items (the caller checks the
// alignment)
__device__ __forceinline__ void ld16(const int* p, int* v) {
  const int4 w = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
__device__ __forceinline__ void ld16(const long long* p, long long* v) {
  const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(p));
  v[0] = w.x; v[1] = w.y;
}
__device__ __forceinline__ void st16(int* p, const int* v) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(long long* p, const long long* v) {
  *reinterpret_cast<longlong2*>(p) = make_longlong2(v[0], v[1]);
}

// ``n`` consecutive items of ``src`` from row r0 into v (rows at or past
// ``rows`` read as ``fill``): 16-byte loads when the thread's rows are
// whole and ``vec`` says the array is 16-byte aligned.
template <int N, class T>
__device__ __forceinline__ void load_items(const T* __restrict__ src,
                                           long long r0, long long rows,
                                           bool vec, T fill, T* v) {
  constexpr int PER = 16 / int(sizeof(T));
  static_assert(N % PER == 0, "whole 16-byte vectors per thread");
  if (vec && r0 + N <= rows) {
#pragma unroll
    for (int k = 0; k < N; k += PER) ld16(src + r0 + k, v + k);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = r0 + j < rows ? __ldg(src + r0 + j)
                                                     : fill;
  }
}

template <int N, class T>
__device__ __forceinline__ void store_items(T* __restrict__ dst, long long r0,
                                            long long rows, bool vec,
                                            const T* v) {
  constexpr int PER = 16 / int(sizeof(T));
  if (vec && r0 + N <= rows) {
#pragma unroll
    for (int k = 0; k < N; k += PER) st16(dst + r0 + k, v + k);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (r0 + j < rows) dst[r0 + j] = v[j];
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace tile_scan
