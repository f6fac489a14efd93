// tile_scan.cuh — the tiled scans shared by the device merge's kernels
// (running_fill.cu, tail_good_join.cu, tail_exact_credit.cu, run_merge.cu)
// on Hopper (sm_90a): the block scan, coalesced loads and stores of a
// thread's consecutive items, and the single-pass scan with decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016): one launch, each row read once.
//
// A block takes its tile's place in scan order from an atomic ticket (not
// from blockIdx), so a tile only ever waits on tiles whose blocks took a
// ticket earlier and so are running: no launch order can hang the card.
// It folds its rows, publishes its aggregate with a status flag, and its
// first warp looks back over the tiles before it, 32 at a time: it folds
// their aggregates until it meets a tile that has published its inclusive
// state, which ends the look-back. A tile publishes its inclusive state
// only when its look-back ends, so the inclusive states form a chain that
// caps the scan at about 32 tiles per look-back round; an operator whose
// aggregates usually hide everything before them (Op::absorbs) breaks the
// chain: such a tile publishes its inclusive state with its aggregate, and
// the tile after it finds it at once; a kernel that can learn a tile's
// prefix from a few rows beside the tile (tail_good_join's and
// bucket_sums' halos) skips the look-back for that tile. Each 32-bit word
// of a published state shares a 64-bit word with its flag, so a round of
// the look-back is one trip to L2, and a window waits only on the tiles up
// to its nearest inclusive state. The ticket and the states live in
// scratch the caller zeroes per call (lookback_bytes).
//
// Inside a tile a thread folds its consecutive items in registers, a warp
// scans its 32 thread states with 5 shuffle steps, and warp 0 scans the
// warps' totals the same way. The result does not depend on the tile size
// or on the order in which tiles finish.
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

// The slot of 16-byte vector q in a shared tile where a warp stages its
// threads' consecutive items, NV vectors a thread: XOR-swizzled so that
// neither 8 consecutive lanes taking vectors q, q+1, ... (the warp's
// coalesced loads and stores) nor 8 consecutive threads each taking its
// u-th vector (vectors l * NV + u) meet a bank conflict. It permutes only
// within aligned groups of 8 vectors, so each warp keeps to its own part.
template <int NV>
__device__ __forceinline__ int swz(int q) {
  constexpr int SH = NV <= 8 ? 3 : (NV == 16 ? 4 : 5);
  constexpr int MSK = NV >= 8 ? 7 : (NV == 4 ? 3 : (NV == 2 ? 1 : 0));
  return q ^ ((q >> SH) & MSK);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// single-pass scan with decoupled look-back
// ---------------------------------------------------------------------------

enum : int { LB_EMPTY = 0, LB_AGG = 1, LB_INCL = 2 };

// This block's tile in scan order, from the ticket; every thread gets it.
__device__ __forceinline__ int take_ticket(unsigned* ticket) {
  __shared__ int t;
  if (threadIdx.x == 0) t = int(atomicAdd(ticket, 1u));
  __syncthreads();
  return t;
}

// Each tile's published state is N = sizeof(S) / 4 64-bit words, word i
// holding the state's 32-bit word i and the flag (LB_AGG or LB_INCL) in
// its upper half. Words are written and read with relaxed gpu-scope
// accesses: a word is never seen without its value, and a state whose
// words carry different flags (an inclusive state half over its
// aggregate) is not yet whole and is read again. The scratch (zeroed per
// call, lookback_bytes): a 16-byte head (the ticket, then three words the
// kernel may use: a count, a fault word) and N words per tile.

__host__ __device__ inline long long lookback_bytes(long long tiles,
                                                    int state_bytes) {
  return 16 + 8 * tiles * (state_bytes / 4);
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w) : "l"(p) : "memory");
  return w;
}

template <class S>
__device__ __forceinline__ void publish_packed(unsigned long long* slot,
                                               int flag, const S& x) {
  const unsigned* a = reinterpret_cast<const unsigned*>(&x);
#pragma unroll
  for (int i = 0; i < int(sizeof(S) / 4); ++i)
    st_word(slot + i, (static_cast<unsigned long long>(flag) << 32) | a[i]);
}

// the flag of a tile's state (LB_EMPTY while it is not whole) and the state
template <class S>
__device__ __forceinline__ int read_packed(const unsigned long long* slot,
                                           S* x) {
  constexpr int N = int(sizeof(S) / 4);
  unsigned long long w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = ld_word(slot + i);
  unsigned* a = reinterpret_cast<unsigned*>(x);
  const int f = int(w[0] >> 32);
  bool whole = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = unsigned(w[i]);
    whole = whole && int(w[i] >> 32) == f;
  }
  return whole ? f : LB_EMPTY;
}

// The exclusive prefix of tile t (scan order) given its aggregate: the
// fold of every tile before it, from the states at ``slots``. Publishes
// the tile's aggregate, then its inclusive state — at once, with no
// look-back on its critical path, when Op::absorbs(aggregate) says the
// aggregate hides every state before it (combine(x, aggregate) ==
// aggregate for all x), or when the caller already knows the prefix by
// other means (``known``, block-uniform; the prefix is then ``prefix``).
// Called by the whole block; the first warp looks back, lane k reading
// tile p - k, and the window moves back 32 tiles while no tile in it holds
// an inclusive state (tile 0 always will). Returns the prefix to every
// thread.
template <class Op, class S>
__device__ __forceinline__ S lookback(unsigned long long* slots, int t,
                                      const S& aggregate, bool known = false,
                                      const S& prefix = Op::identity()) {
  constexpr int N = int(sizeof(S) / 4);
  __shared__ S slot;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool done = t == 0 || known || Op::absorbs(aggregate);
    if (lane == 0)
      publish_packed(slots + (long long)t * N, done ? LB_INCL : LB_AGG,
                     known ? Op::combine(prefix, aggregate) : aggregate);
    S ex = known ? prefix : Op::identity();
    for (int p = t - 1; p >= 0 && !known; p -= 32) {
      const int q = p - lane;
      S x = Op::identity();
      int f = q >= 0 ? read_packed(slots + (long long)q * N, &x) : LB_INCL;
      unsigned incl, lim;
      while (true) {
        incl = __ballot_sync(FULL, f == LB_INCL);
        // the lanes up to the nearest inclusive state are those folded
        lim = incl ? (2u << (__ffs(incl) - 1)) - 1 : FULL;
        if (!(__ballot_sync(FULL, f == LB_EMPTY) & lim)) break;
        __nanosleep(20);
        if (f == LB_EMPTY) f = read_packed(slots + (long long)q * N, &x);
      }
      if (!((lim >> lane) & 1u)) x = Op::identity();
      // fold lanes stop .. 0 in scan order (the farthest tile first):
      // lane 31 before lane 0, as a backward warp scan runs
      S win;
      warp_scan<true, Op>(x, &win);
      ex = Op::combine(win, ex);
      if (incl) break;
    }
    if (lane == 0) {
      if (!done)
        publish_packed(slots + (long long)t * N, LB_INCL,
                       Op::combine(ex, aggregate));
      slot = ex;
    }
  }
  __syncthreads();
  return slot;
}

}  // namespace tile_scan
