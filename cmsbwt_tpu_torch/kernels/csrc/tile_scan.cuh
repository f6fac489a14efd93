// tile_scan.cuh — the tiled scans shared by the device merge's kernels
// (running_fill.cu, tail_good_join.cu, tail_exact_credit.cu, run_merge.cu)
// on Hopper (sm_90a). Two schemes:
//
// The three-launch scan (running_fill.cu, tail_exact_credit.cu), the same
// structure as dense_neighbors.cu:
//   1. reduce: each tile folds its rows into one aggregate;
//   2. carry:  one block scans the tiles' aggregates in scan order into
//              each tile's exclusive carry (carry[tiles] = the fold of
//              every tile);
//   3. emit:   each tile scans its rows again from its carry and writes.
// Nothing spins on another block, but every row is read twice.
//
// The single-pass scan with decoupled look-back (tail_good_join.cu,
// run_merge.cu: Merrill and Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016): one launch, each row read once. A
// block takes its tile's place in scan order from an atomic ticket (not
// from blockIdx), so a tile only ever waits on tiles whose blocks took a
// ticket earlier and so are running: no launch order can hang the card.
// It folds its rows (held in registers), publishes its aggregate with a
// status flag, and its first warp looks back over the tiles before it, 32
// flags at a time: it folds their aggregates until it meets a tile that
// has published its inclusive state, which ends the look-back. A tile
// publishes its inclusive state only when its look-back ends, so the
// inclusive states form a chain that caps the scan at about 32 tiles per
// look-back round; an operator whose aggregates usually hide everything
// before them (Op::absorbs) breaks the chain: such a tile publishes its
// inclusive state with its aggregate, and the tile after it finds it at
// once. A kernel that can learn a tile's prefix from a few rows beside
// the tile (tail_good_join's halo) skips the look-back for that tile.
// Flags and ticket live in scratch the caller zeroes per call
// (lookback_bytes); the values are published with release stores of the
// flags and read after acquire loads of them.
//
// Inside a tile (both schemes) a thread folds its consecutive items in
// registers, a warp scans its 32 thread states with 5 shuffle steps, and
// warp 0 scans the warps' totals the same way. The result does not depend
// on the tile size or on the order in which tiles finish.
//
// A scan state S is a struct of 32-bit words (it is shuffled word by
// word); an Op gives
//   static S identity();
//   static S combine(const S& x, const S& y);   // x before y in scan order
// with combine associative, and for the look-back
//   static bool absorbs(const S& y);   // combine(x, y) == y for every x
// (false where unsure). A BWD scan runs from the last row to the first:
// lane 31 before lane 0, the last warp first, the last tile first, and a
// thread's items from its last to its first.
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

// ---------------------------------------------------------------------------
// single-pass scan with decoupled look-back
// ---------------------------------------------------------------------------

enum : int { LB_EMPTY = 0, LB_AGG = 1, LB_INCL = 2 };

// The look-back's scratch: a 16-byte head (the ticket, then three words
// the kernel may use: a count, a fault flag), one flag per tile, and per
// tile its aggregate and its inclusive state. All of it zeroed per call.
template <class S>
struct Lookback {
  unsigned* ticket;
  int* head;   // head[0..2], after the ticket
  int* flag;
  S* agg;
  S* incl;
};

__host__ __device__ inline long long lb_round16(long long b) {
  return (b + 15) / 16 * 16;
}

template <class S>
__host__ __device__ inline long long lookback_bytes(long long tiles) {
  return 16 + lb_round16(4 * tiles) + lb_round16(2 * tiles * sizeof(S));
}

template <class S>
__host__ __device__ inline Lookback<S> lookback_at(void* scratch,
                                                    long long tiles) {
  char* p = static_cast<char*>(scratch);
  Lookback<S> lb;
  lb.ticket = reinterpret_cast<unsigned*>(p);
  lb.head = reinterpret_cast<int*>(p) + 1;
  lb.flag = reinterpret_cast<int*>(p + 16);
  lb.agg = reinterpret_cast<S*>(p + 16 + lb_round16(4 * tiles));
  lb.incl = lb.agg + tiles;
  return lb;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// a published state, read from L2 (never a stale L1 line)
template <class S>
__device__ __forceinline__ S ld_state(const S* p) {
  static_assert(sizeof(S) % 4 == 0, "scan states are 32-bit words");
  S x;
  const int* a = reinterpret_cast<const int*>(p);
  int* b = reinterpret_cast<int*>(&x);
#pragma unroll
  for (int i = 0; i < int(sizeof(S) / 4); ++i) b[i] = __ldcg(a + i);
  return x;
}

template <class S>
__device__ __forceinline__ void st_state(S* p, const S& x) {
  const int* a = reinterpret_cast<const int*>(&x);
  int* b = reinterpret_cast<int*>(p);
#pragma unroll
  for (int i = 0; i < int(sizeof(S) / 4); ++i) __stcg(b + i, a[i]);
}

// This block's tile in scan order, from the ticket; every thread gets it.
__device__ __forceinline__ int take_ticket(unsigned* ticket) {
  __shared__ int t;
  if (threadIdx.x == 0) t = int(atomicAdd(ticket, 1u));
  __syncthreads();
  return t;
}

// The exclusive prefix of tile t (scan order) given its aggregate: the
// fold of every tile before it. Publishes the tile's aggregate, then its
// inclusive state — at once, with no look-back on its critical path, when
// Op::absorbs(aggregate) says the aggregate hides every state before it
// (combine(x, aggregate) == aggregate for all x), or when the caller
// already knows the prefix by other means (``known``, block-uniform; the
// prefix is then ``prefix``).
// Called by the whole block; the first warp looks back, lane k reading
// tile p - k, and the window moves back 32 tiles while no tile in it holds
// an inclusive state (tile 0 always will). Returns the prefix to every
// thread.
template <class Op, class S>
__device__ __forceinline__ S lookback(const Lookback<S>& lb, int t,
                                      const S& aggregate, bool known = false,
                                      const S& prefix = Op::identity()) {
  __shared__ S slot;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool done = t == 0 || known || Op::absorbs(aggregate);
    if (lane == 0) {
      st_state((done ? lb.incl : lb.agg) + t,
               known ? Op::combine(prefix, aggregate) : aggregate);
      st_release(lb.flag + t, done ? LB_INCL : LB_AGG);
    }
    S ex = Op::identity();
    for (int p = t - 1; t > 0 && !known; p -= 32) {
      const int q = p - lane;
      int f = q >= 0 ? ld_acquire(lb.flag + q) : LB_INCL;
      while (__any_sync(FULL, f == LB_EMPTY)) {
        __nanosleep(20);
        if (f == LB_EMPTY) f = ld_acquire(lb.flag + q);
      }
      S x = q < 0 ? Op::identity()
                  : ld_state(f == LB_INCL ? lb.incl + q : lb.agg + q);
      const unsigned incl = __ballot_sync(FULL, f == LB_INCL);
      // the nearest inclusive state ends the fold; farther tiles drop
      const int stop = incl ? __ffs(incl) - 1 : 31;
      if (lane > stop) x = Op::identity();
      // fold lanes stop .. 0 in scan order (the farthest tile first):
      // lane 31 before lane 0, as a backward warp scan runs
      S win;
      warp_scan<true, Op>(x, &win);
      ex = Op::combine(win, ex);
      if (incl) break;
    }
    if (known) ex = prefix;
    if (lane == 0 && !done) {
      st_state(lb.incl + t, Op::combine(ex, aggregate));
      st_release(lb.flag + t, LB_INCL);
    }
    if (lane == 0) slot = ex;
  }
  __syncthreads();
  return slot;
}

}  // namespace tile_scan
