// sa_round — the rank step of the joint suffix sort's seed and of each
// round of its prefix doubling, after that step's sort, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA programs that
// cmsbwt_tpu/ops/joint_sa.py runs after the seed's lax.sort (:198-208)
// and after each round's, a full round's (:244-266) and a compacted
// round's (:307-341), which the port ran as a dozen torch passes (change
// flags, running maxima, inversions). Equal to
// cmsbwt_tpu_torch/ops/joint_sa._seed_ranks_reference and
// _round_ranks_reference element for element.
//
// Over R rows sorted by their key words (perm[r]: the source row of sorted
// row r; a round's four int32 keys: key 0 the group, the rank or INT_MAX
// for a compacted round's dead rows, keys 1-3 the ranks + 1 at three
// shifts; the seed's 3 or 6 words of its packs and payload), per sorted
// row r:
//   g(r)     key 0 differs from row r-1's, or r == 0: a group starts;
//   mid(r)   keys 0-1 differ: a mid-level group starts;
//   full(r)  any key differs: a full-level group starts (the seed has one
//            level: g = mid = full, any word differs);
//   G, M, F  the last g, mid and full start row at or before r;
//   sing(r)  full(r) and full(r+1), true past the end: a singleton.
// A full round (R = m, perm[r] the text position t):
//   mid_rank[t] = M, full_rank[t] = F, resolved[t] = sing(r),
//   lv_out[r] = lv_in[r], or where that is 0: k+1 at a mid start, k+2 at
//   a full start.
// The seed (R = m, t = perm[r], k the seed level):
//   full_rank[t] = F (the rank), resolved[t] = sing(r), lv_out[r] = k at
//   a start, else 0.
// A compacted round (R = U; t = ti[perm[r]]; live: key 0 != INT_MAX):
//   rank_u = key 0 + (F - G) (and key 0 + (M - G) for the mid level); at
//   live rows mid_rank[t], full_rank[t] and resolved[t] are set, and
//   lv_out[key 0 + (M - G)] = k+1 at a mid start that is no group start,
//   lv_out[rank_u] = k+2 at a full start that is no mid start; the carried
//   slice: ti_s[r] = t, rank_u[r], keep[r] = live and not sing(r).
// Each counts the rows that stay unresolved (live and not sing) into one
// word, which the caller reads once a round.
//
// dense_rank_launch runs the same binned store for the rank step of
// cmsbwt_tpu_torch/index/device.suffix_array_device's doubling rounds
// (the counterpart of cmsbwt_tpu/index/device.py:24-35 _dense_rank and
// its caller's rounds :47-120). Over the n rows in the order of the
// round's sort: a row starts a rank where key 0 (sorted) or key 1 differs
// from the row before. Key 1 is read through the order only where a row's
// key 0 equals a neighbour's: every other row starts a rank, and so does
// the row after it, whatever key 1 holds (on the H100, at 500 Mchars,
// the gather of every row took ~0.87 of the step's 1.33 ms). With the
// rank history (RANK_DENSE) the rank is the JAX package's dense
// cumsum(changed) - 1; without it (RANK_START, the head string) it is
// the sorted index at which the row's group starts, and the step also
// writes the slice of unresolved rows (groups of two or more) in sorted
// order. The rank lands at its text position through the binned store;
// with the history sa_round_settle writes the next round's shifted key
// beside it, without it slice_keys_kernel writes the slice's (every later
// round is a compacted one).
// dense_rank_comp_launch runs such a round's step over the slice alone
// (dense_rank_comp_kernel: the rank, the newly resolved rows' places in
// the suffix array, the next slice; then slice_keys_kernel). The largest
// rank or the unresolved count and the fault word go into one 8-byte
// word pair the host reads once a round. Equal to
// index/device._dense_rank_reference and _comp_rank_reference element
// for element.
//
// What bounds it on this card: bytes. A full round reads perm, lv and the
// keys of each row and writes lv, the two rank rows and the flags: 37 B a
// row, 2.8 ms at m = 252 M. But the keys are read through perm and the
// results land through it, on random rows. A random read moves a 32-byte
// sector for its 16 bytes; a random 8-byte write, which the L2 (50 MB)
// cannot merge with its neighbours before it evicts the sector, costs a
// sector read and a sector write in DRAM: at m = 252 M the scatter of one
// word a row took 17.3 of the former kernel's 26.2 ms, the gather 7.8.
//
// Design: two C calls. sa_round_pack_launch lays a step's key rows side
// by side (K: one gathered 16- or 32-byte row, one sector, where four
// gathers would move four; its own call so that the caller can free the
// key rows before the staging below is made). sa_round_launch then runs
// sa_round_kernel, a single-pass scan with decoupled look-back
// (tile_scan.cuh's lookback) of (G, M, F) under max over tiles of 2048
// rows, 256 threads of 8 consecutive rows, and for a full round and the
// seed sa_round_fine and sa_round_settle.
//  * No random partial-sector write: the text order is cut into bins of
//    2^shift positions (kernels.sa_round_bins: 2^20) and those into fine
//    bins of 4096. A tile counts its rows per bin (shared atomics), scans
//    the counts, takes each bin's run of rows from the bin's cursor (one
//    global atomic a bin a tile), lays its rows out in shared memory by
//    bin and writes each run, coalesced, to the bin's part of a bin-major
//    staging (three int32 rows: the position in the bin << 1 | sing, M,
//    F; the seed writes no M). Since perm is a permutation, bin b holds
//    exactly its width of rows, from b << shift on, so the cursors need
//    no scan; the order of the runs in a bin is the order the tiles took
//    them, which no output depends on (each position is written once).
//    sa_round_fine sorts each bin's staging by fine bin the same way, in
//    chunks of 4096 rows, into a second staging laid over K (dead by
//    then); sa_round_settle lays each fine bin's rows out in shared
//    memory at their positions and writes the 4096 positions' results in
//    order. Placing each row's results at random inside an L2-resident
//    bin instead took 14.8 ms a 252 M-row round on the H100 (three
//    scattered rows), 9.3 as one scattered word split in order, against
//    6.0 for the two levels. Bins of 2^20 balance the kernel's runs
//    (longer in wider bins) against the fine pass's (shorter): 22.25 ms a
//    round, 23.30 at 2^19, 22.69-24.76 at 2^21-2^22. Staging loads and
//    the key gathers are streaming loads (evict first), so the L2 keeps
//    the writes.
//  * A compacted round (R <= m/16) writes its live rows straight into
//    copies of rank and resolved.
//  * A block takes its tile from a ticket. Each thread loads its 8 perm
//    entries with 16-byte loads and gathers its rows' keys, all issued
//    before any is used.
//  * The row before a thread's first row is the last row of the thread
//    before: a shuffle inside a warp, shared memory across warps, and one
//    gathered row before the tile. The full-start flag of the row after a
//    thread's last row comes back the same way; the tile's last thread
//    compares the next tile's first row itself.
//  * A tile that starts a group starts a mid and a full group too, so its
//    aggregate hides every tile before it (Op::absorbs): it publishes its
//    inclusive state at once, and a look-back waits only across the tiles
//    of one group.
//  * The unresolved count: a warp sum, a shared sum and one global atomic
//    a tile.
//  * A destination outside [0, m) is not written, nor a row past its
//    bin's width (neither occurs for a permutation; the plain version
//    raises on the first).
//
// Plain C interface (bound with ctypes): each launch function launches on
// the given stream and returns the first cudaGetLastError() that is not
// 0; nothing allocates or synchronises. The caller passes
// sa_round_scratch_bytes(R, m, shift) bytes of zeroed scratch (the
// ticket, the count, the tiles' states, the bins' and the fine bins'
// cursors), K (rows of 16 bytes, or 32 for the wide seed; R + 8 of them,
// since a full round's or the seed's second staging, 12 * ((m + 3) & ~3)
// bytes, is laid over it) and, for those two, the staging (three or two
// int32[m]); for a compacted round mid_rank, full_rank, resolved and
// lv_out as copies of rank, rank, resolved and lv.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;   // blocks an SM holds: caps the registers
constexpr int DEAD = INT_MAX;   // key 0 of a compacted round's dead rows
constexpr int MAX_BINS = 1024;  // bins a tile counts in shared memory
constexpr int BIN_ITEMS = MAX_BINS / THREADS;
constexpr int CURSOR_STRIDE = 32;  // int32s between two bins' cursors

enum Mode : int {
  FULL_ROUND = 0,
  COMP_ROUND = 1,
  SEED_NARROW = 2,
  SEED_WIDE = 3
};

// the last group, mid and full start row at or before a row (-1: none)
struct Starts {
  int g, mid, full;
};

struct StartsOp {
  static __device__ __forceinline__ Starts identity() {
    return Starts{-1, -1, -1};
  }
  static __device__ __forceinline__ Starts combine(const Starts& x,
                                                   const Starts& y) {
    return Starts{max(x.g, y.g), max(x.mid, y.mid), max(x.full, y.full)};
  }
  // a group start is a mid and a full start too, on a later row than
  // every state before it
  static __device__ __forceinline__ bool absorbs(const Starts& y) {
    return y.g >= 0;
  }
};

struct SumOp {
  static __device__ __forceinline__ int identity() { return 0; }
  static __device__ __forceinline__ int combine(int x, int y) {
    return x + y;
  }
  static __device__ __forceinline__ bool absorbs(int) { return false; }
};

// a row's key words: 4, or 8 for the wide seed
template <int KW>
struct Keys {
  int w[KW];
};

struct Args {
  const int* perm;
  const int4* K;        // the key words of each source row
  const int* ti;        // compacted: the text position of each source row
  const int* lv_in;     // full: split levels, SA order
  int* lv_out;
  int* mid_rank;        // text order
  int* full_rank;       // the seed's rank
  unsigned char* resolved;
  unsigned* st_pos;     // full, seed: the staging, bin-major
  int* st_mid;
  int* st_full;
  int* ti_s;            // compacted: the carried slice, sorted order
  int* rank_u;
  unsigned char* keep;
  int R, m, k, shift, bins;
  bool vec;             // perm, lv and the slice are 16-byte aligned
  unsigned* ticket;
  int* count;
  unsigned long long* slots;
  int* cursors;         // each bin's rows taken so far
};

template <int KW>
__device__ __forceinline__ Keys<KW> gather(const Args& a, int src) {
  Keys<KW> x;
#pragma unroll
  for (int h = 0; h < KW / 4; ++h) {
    const int4 w = __ldcs(a.K + (long long)src * (KW / 4) + h);
    x.w[4 * h] = w.x;
    x.w[4 * h + 1] = w.y;
    x.w[4 * h + 2] = w.z;
    x.w[4 * h + 3] = w.w;
  }
  return x;
}

template <int KW>
__device__ __forceinline__ Keys<KW> zero_keys() {
  Keys<KW> x;
#pragma unroll
  for (int q = 0; q < KW; ++q) x.w[q] = 0;
  return x;
}

template <int KW>
__device__ __forceinline__ bool differ(const Keys<KW>& x, const Keys<KW>& y) {
  bool d = false;
#pragma unroll
  for (int q = 0; q < KW; ++q) d = d || x.w[q] != y.w[q];
  return d;
}

template <int KW>
__device__ __forceinline__ Keys<KW> shfl_up_keys(const Keys<KW>& x) {
  Keys<KW> y;
#pragma unroll
  for (int q = 0; q < KW; ++q) y.w[q] = __shfl_up_sync(FULL, x.w[q], 1);
  return y;
}

__device__ __forceinline__ int top_row(long long r0, unsigned bits) {
  return bits ? int(r0) + 31 - __clz(bits) : -1;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    sa_round_kernel(const Args a) {
  constexpr int KW = MODE == SEED_WIDE ? 8 : 4;
  constexpr bool COMPACT = MODE == COMP_ROUND;
  constexpr bool SEEDS = MODE == SEED_NARROW || MODE == SEED_WIDE;
  constexpr bool BINNED = !COMPACT;
  constexpr int BT = BINNED ? TILE : 1;   // shared staging rows
  __shared__ Starts wagg[33];
  __shared__ int sagg[33];
  __shared__ Keys<KW> wlast[WARPS];   // each warp's last row's keys
  __shared__ int wfirst[WARPS];   // each warp's first row's full flag
  __shared__ int tile_count;
  // the binned scatter: each bin's count in the tile, then its run's
  // offset in the tile (off) and its cursor in the bin (at); the tile's
  // rows by bin and each one's staging row (-1: not written)
  __shared__ int off[BINNED ? MAX_BINS : 1], at[BINNED ? MAX_BINS : 1];
  __shared__ unsigned s_pos[BT];
  __shared__ int s_mid[MODE == FULL_ROUND ? TILE : 1], s_full[BT];
  __shared__ int s_dst[BT];
  if (threadIdx.x == 0) tile_count = 0;
  if (BINNED)
    for (int b = threadIdx.x; b < a.bins; b += THREADS) off[b] = 0;
  const int t = take_ticket(a.ticket);   // synchronises the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)t * TILE + (long long)threadIdx.x * ITEMS;
  // this thread's rows; a thread with rows follows threads with all theirs
  const int n = int(max(0ll, min((long long)ITEMS, a.R - r0)));
  int src[ITEMS];
  load_items<ITEMS>(a.perm, r0, a.R, a.vec, 0, src);
  Keys<KW> key[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    key[j] = j < n ? gather<KW>(a, src[j]) : zero_keys<KW>();

  // the row before this thread's first row
  Keys<KW> prev = shfl_up_keys(key[ITEMS - 1]);
  if (lane == 31) wlast[warp] = key[ITEMS - 1];
  Keys<KW> before = zero_keys<KW>();
  if (threadIdx.x == 0 && r0 > 0)
    before = gather<KW>(a, __ldg(a.perm + r0 - 1));
  __syncthreads();
  if (lane == 0) prev = warp ? wlast[warp - 1] : before;

  // bit j: row r0 + j starts a group, a mid group, a full group
  unsigned fg = 0, fm = 0, ff = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const Keys<KW>& c = key[j];
    const Keys<KW>& p = j ? key[j - 1] : prev;
    const bool top = j == 0 && r0 == 0;
    bool dg, dm, df;
    if (SEEDS) {
      dg = dm = df = top || differ(c, p);
    } else {
      dg = top || c.w[0] != p.w[0];
      dm = dg || c.w[1] != p.w[1];
      df = dm || c.w[2] != p.w[2] || c.w[3] != p.w[3];
    }
    if (j < n) {
      fg |= unsigned(dg) << j;
      fm |= unsigned(dm) << j;
      ff |= unsigned(df) << j;
    }
  }
  // the full flag of the row after this thread's last row: lane + 1's
  // first, the next warp's first (read after the block scan's barriers),
  // or, for the tile's last thread, the next tile's first row
  int next_full = __shfl_down_sync(FULL, int(ff & 1u), 1);
  if (lane == 0) wfirst[warp] = int(ff & 1u);
  int after = 1;
  if (threadIdx.x == THREADS - 1 && r0 + ITEMS < a.R)
    after = differ(gather<KW>(a, __ldg(a.perm + r0 + ITEMS)),
                   key[ITEMS - 1]);

  const Starts agg{top_row(r0, fg), top_row(r0, fm), top_row(r0, ff)};
  Starts tot;
  const Starts ex = block_scan<false, StartsOp>(agg, StartsOp::identity(),
                                                wagg, &tot);
  Starts run = StartsOp::combine(lookback<StartsOp>(a.slots, t, tot), ex);
  if (lane == 31) next_full = warp + 1 < WARPS ? wfirst[warp + 1] : after;

  int lvv[ITEMS], tis[ITEMS], rku[ITEMS], mv[ITEMS], fv[ITEMS];
  unsigned sing_bits = 0;
  if (MODE == FULL_ROUND)
    load_items<ITEMS>(a.lv_in, r0, a.R, a.vec, 0, lvv);
  int unresolved = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j >= n) break;
    const int r = int(r0) + j;
    const bool dg = fg >> j & 1u, dm = fm >> j & 1u, df = ff >> j & 1u;
    if (dg) run.g = r;
    if (dm) run.mid = r;
    if (df) run.full = r;
    const bool nf = r + 1 >= a.R ||
                    (j + 1 < ITEMS ? (ff >> (j + 1) & 1u) != 0
                                   : next_full != 0);
    const bool sing = df && nf;
    if (COMPACT) {
      const int g0 = key[j].w[0];
      const bool live = g0 != DEAD;
      // int32 arithmetic wraps, as torch's does
      const int mid = int(unsigned(g0) + unsigned(run.mid - run.g));
      const int full = int(unsigned(g0) + unsigned(run.full - run.g));
      const int to = __ldg(a.ti + src[j]);
      if (live) {
        if (unsigned(to) < unsigned(a.m)) {
          a.mid_rank[to] = mid;
          a.full_rank[to] = full;
          a.resolved[to] = sing;
        }
        if (dm && !dg && unsigned(mid) < unsigned(a.m))
          a.lv_out[mid] = a.k + 1;
        if (df && !dm && unsigned(full) < unsigned(a.m))
          a.lv_out[full] = a.k + 2;
      }
      tis[j] = to;
      rku[j] = full;
      a.keep[r] = live && !sing;
      unresolved += live && !sing;
    } else {
      mv[j] = run.mid;
      fv[j] = run.full;
      sing_bits |= unsigned(sing) << j;
      if (SEEDS)
        lvv[j] = df ? a.k : 0;
      else if (lvv[j] == 0)
        lvv[j] = dm ? a.k + 1 : (df ? a.k + 2 : 0);
      unresolved += !sing;
    }
  }
  if (COMPACT) {
    store_items<ITEMS>(a.ti_s, r0, a.R, a.vec, tis);
    store_items<ITEMS>(a.rank_u, r0, a.R, a.vec, rku);
  } else {
    store_items<ITEMS>(a.lv_out, r0, a.R, a.vec, lvv);
  }

  if (BINNED) {
    // each row's place in its bin's run of the tile
    int slot[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      slot[j] = j < n && unsigned(src[j]) < unsigned(a.m)
                    ? atomicAdd(&off[src[j] >> a.shift], 1)
                    : -1;
    __syncthreads();
    // the runs' offsets in the tile, and their cursors in the bins
    int cnt[BIN_ITEMS], sum = 0;
#pragma unroll
    for (int q = 0; q < BIN_ITEMS; ++q) {
      const int b = threadIdx.x * BIN_ITEMS + q;
      cnt[q] = b < a.bins ? off[b] : 0;
      sum += cnt[q];
    }
    int rows;
    int o = block_scan<false, SumOp>(sum, 0, sagg, &rows);
#pragma unroll
    for (int q = 0; q < BIN_ITEMS; ++q) {
      const int b = threadIdx.x * BIN_ITEMS + q;
      if (cnt[q]) {
        off[b] = o;
        at[b] = atomicAdd(a.cursors + (long long)b * CURSOR_STRIDE, cnt[q]);
      }
      o += cnt[q];
    }
    __syncthreads();
    // the tile's rows into shared memory by bin, each with its staging row
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (slot[j] < 0) continue;
      const int b = src[j] >> a.shift;
      const int base = b << a.shift;
      const int width = min(1 << a.shift, a.m - base);
      const int p = off[b] + slot[j];
      const int g = at[b] + slot[j];
      s_pos[p] = unsigned(src[j] - base) << 1 | (sing_bits >> j & 1u);
      if (MODE == FULL_ROUND) s_mid[p] = mv[j];
      s_full[p] = fv[j];
      s_dst[p] = g < width ? base + g : -1;
    }
    __syncthreads();
    // each bin's run, coalesced, into its staging rows
    for (int p = threadIdx.x; p < rows; p += THREADS) {
      const int d = s_dst[p];
      if (d < 0) continue;
      a.st_pos[d] = s_pos[p];
      if (MODE == FULL_ROUND) a.st_mid[d] = s_mid[p];
      a.st_full[d] = s_full[p];
    }
  }

  unresolved = __reduce_add_sync(FULL, unresolved);
  if (lane == 0 && unresolved) atomicAdd(&tile_count, unresolved);
  __syncthreads();
  if (threadIdx.x == 0 && tile_count) atomicAdd(a.count, tile_count);
}

// The doubling rounds' rank steps of index/device.suffix_array_device.
// A full step runs over the n rows in the order of a stable sort by (key
// 0, key 1): a row starts a rank where key 0 (sorted, s0[r]) or key 1
// (read through the order; absent for the one-key seed) differs from the
// row before. In RANK_DENSE mode (the rank history's rows) its rank is the
// count of starts up to it, less 1; in RANK_START mode (the head string's
// sort, no history) it is F, the last start row at or before it (the
// sorted index at which its group starts), and the rows in groups of two
// or more (unresolved: not a start followed by a start) go, in sorted
// order, to the next round's slice (their text positions and ranks). The
// rank lands at its text position through the binned store below; the
// last row's rank (DENSE) or the unresolved count (START) and the fault
// word go into one 8-byte word pair the host reads once a round. One
// thread: 8 consecutive rows; the scan over tiles is the look-back of a
// sum (DENSE), or of (F under max, the unresolved count) (START).
struct RankArgs {
  const int* order;     // the sorted rows' sources: text positions (full),
                        // slice rows (compacted)
  const int* s0;        // key 0 in sorted order
  const int* key1;      // key 1 by source, or null (the one-key seed)
  const int* ti;        // compacted: the slice's text positions
  int* rank;            // compacted: the rank, written at the slice's rows
  int* sa;              // compacted: each row written at its place
  int* ti_n;            // START, compacted: the unresolved rows' text
  int* k0_n;            //   positions and ranks, sorted order, cap rows
  int cap;
  int n, m;             // rows; text positions (a full step: n == m)
  int shift, bins;
  bool vec;             // order and s0 16-byte aligned
  unsigned* ticket;
  int* top;             // the largest rank or the count, the fault's copy
  const int* fault;
  unsigned long long* slots;
  int* cursors;
  unsigned* st_pos;     // the staging, bin-major: position in bin << 1
  int* st_rank;
};

enum RankMode : int { RANK_DENSE = 0, RANK_START = 1 };

// START's scan state: the last start row, the unresolved rows
struct StartCount {
  int f, cnt;
};

struct StartCountOp {
  static __device__ __forceinline__ StartCount identity() {
    return StartCount{-1, 0};
  }
  static __device__ __forceinline__ StartCount combine(const StartCount& x,
                                                       const StartCount& y) {
    return StartCount{max(x.f, y.f), x.cnt + y.cnt};
  }
  static __device__ __forceinline__ bool absorbs(const StartCount&) {
    return false;
  }
};

// a compacted step's: the last group and rank start rows, the unresolved
// rows
struct CompState {
  int g, f, cnt;
};

struct CompOp {
  static __device__ __forceinline__ CompState identity() {
    return CompState{-1, -1, 0};
  }
  static __device__ __forceinline__ CompState combine(const CompState& x,
                                                      const CompState& y) {
    return CompState{max(x.g, y.g), max(x.f, y.f), x.cnt + y.cnt};
  }
  static __device__ __forceinline__ bool absorbs(const CompState&) {
    return false;
  }
};

// The rows before and after a thread's rows, as sa_round_kernel finds
// them (a shuffle inside a warp, shared memory across warps, and the
// rows beside the tile read by its first and last thread): key 0 of the
// row before its first row (*p0), the start bits ``ch`` of its rows and,
// where ``NEXT``, whether the row after its last row starts a rank. With
// ``TIES`` it reads key 1 (``k1``) itself, only for rows whose key 0
// equals a neighbour's: a row whose key 0 differs from both its
// neighbours' starts a rank, and so does the row after it, whatever their
// key 1 (0 there). ``key1`` null: key 1 is 0. Two or three block
// barriers.
template <bool NEXT, bool TIES>
__device__ __forceinline__ void neighbours(const RankArgs& a, const int* src,
                                           const int* k0, int* k1,
                                           long long r0, int* wl0, int* wl1,
                                           int* wf0, int* wf, int* p0,
                                           unsigned* ch, int* next) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = int(max(0ll, min((long long)ITEMS, a.n - r0)));
  const bool last = threadIdx.x == THREADS - 1 && r0 + ITEMS < a.n;
  int q0 = __shfl_up_sync(FULL, k0[ITEMS - 1], 1);
  int x0 = __shfl_down_sync(FULL, k0[0], 1);
  if (lane == 31) wl0[warp] = k0[ITEMS - 1];
  if (TIES && lane == 0) wf0[warp] = k0[0];
  int b0 = 0, a0 = 0;
  if (threadIdx.x == 0 && r0 > 0) b0 = __ldg(a.s0 + r0 - 1);
  if (last) a0 = __ldg(a.s0 + r0 + ITEMS);
  __syncthreads();
  if (lane == 0) q0 = warp ? wl0[warp - 1] : b0;
  if (TIES && lane == 31) x0 = warp + 1 < WARPS ? wf0[warp + 1] : a0;
  if (TIES) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long r = r0 + j;
      const bool tie =
          a.key1 && j < n &&
          ((r > 0 && k0[j] == (j ? k0[j - 1] : q0)) ||
           (r + 1 < a.n && k0[j] == (j + 1 < ITEMS ? k0[j + 1] : x0)));
      k1[j] = tie ? __ldcs(a.key1 + src[j]) : 0;
    }
  }
  int q1 = __shfl_up_sync(FULL, k1[ITEMS - 1], 1);
  if (lane == 31) wl1[warp] = k1[ITEMS - 1];
  int b1 = 0;
  if (threadIdx.x == 0 && r0 > 0 && a.key1 && b0 == k0[0])
    b1 = __ldg(a.key1 + __ldg(a.order + r0 - 1));
  __syncthreads();
  if (lane == 0) q1 = warp ? wl1[warp - 1] : b1;
  *p0 = q0;
  unsigned c = 0;   // bit j: row r0 + j starts a rank
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int v0 = j ? k0[j - 1] : q0, v1 = j ? k1[j - 1] : q1;
    const bool d = (j == 0 && r0 == 0) || k0[j] != v0 || k1[j] != v1;
    if (j < n) c |= unsigned(d) << j;
  }
  *ch = c;
  if (!NEXT) return;
  *next = __shfl_down_sync(FULL, int(c & 1u), 1);
  if (lane == 0) wf[warp] = int(c & 1u);
  int after = 1;
  if (last)
    after = a0 != k0[ITEMS - 1] ||
            (a.key1 && __ldg(a.key1 + __ldg(a.order + r0 + ITEMS)) !=
                           k1[ITEMS - 1]);
  __syncthreads();
  if (lane == 31) *next = warp + 1 < WARPS ? wf[warp + 1] : after;
}

// bit j: row r0 + j is unresolved (not a start followed by a start; the
// row after the last is a start)
__device__ __forceinline__ unsigned unresolved_bits(unsigned ch, int next,
                                                    long long r0, int rows) {
  const int n = int(max(0ll, min((long long)ITEMS, rows - r0)));
  unsigned u = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool nf = r0 + j + 1 >= rows ||
                    (j + 1 < ITEMS ? (ch >> (j + 1) & 1u) != 0 : next != 0);
    if (j < n && !((ch >> j & 1u) && nf)) u |= 1u << j;
  }
  return u;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dense_rank_kernel(const RankArgs a) {
  constexpr bool START = MODE == RANK_START;
  __shared__ int sagg[33];
  __shared__ StartCount cagg[START ? 33 : 1];
  __shared__ int wl0[WARPS], wl1[WARPS], wf0[WARPS], wf[WARPS];
  __shared__ int off[MAX_BINS], at[MAX_BINS];
  __shared__ unsigned s_pos[TILE];
  __shared__ int s_rank[TILE], s_dst[TILE];
  for (int b = threadIdx.x; b < a.bins; b += THREADS) off[b] = 0;
  const int t = take_ticket(a.ticket);   // synchronises the block
  const long long r0 = (long long)t * TILE + (long long)threadIdx.x * ITEMS;
  const int n = int(max(0ll, min((long long)ITEMS, a.n - r0)));
  int src[ITEMS], k0[ITEMS], k1[ITEMS];
  load_items<ITEMS>(a.order, r0, a.n, a.vec, 0, src);
  load_items<ITEMS>(a.s0, r0, a.n, a.vec, 0, k0);
  int p0, next = 1;
  unsigned ch;
  neighbours<START, true>(a, src, k0, k1, r0, wl0, wl1, wf0, wf, &p0, &ch,
                          &next);
  int rk[ITEMS];
  if (START) {
    const unsigned un = unresolved_bits(ch, next, r0, a.n);
    StartCount tot;
    const StartCount ex = block_scan<false, StartCountOp>(
        StartCount{top_row(r0, ch), __popc(un)}, StartCountOp::identity(),
        cagg, &tot);
    StartCount run = StartCountOp::combine(
        lookback<StartCountOp>(a.slots, t, tot), ex);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (ch >> j & 1u) run.f = int(r0) + j;
      rk[j] = run.f;
      if (un >> j & 1u) {
        if (run.cnt < a.cap) {
          a.ti_n[run.cnt] = src[j];
          a.k0_n[run.cnt] = rk[j];
        }
        ++run.cnt;
      }
      if (j < n && r0 + j == a.n - 1) {
        a.top[0] = run.cnt;
        a.top[1] = *a.fault;
      }
    }
  } else {
    int tot;
    const int ex = block_scan<false, SumOp>(__popc(ch), 0, sagg, &tot);
    int run = lookback<SumOp>(a.slots, t, tot) + ex;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      run += ch >> j & 1u;
      rk[j] = run - 1;
      if (j < n && r0 + j == a.n - 1) {
        a.top[0] = rk[j];
        a.top[1] = *a.fault;
      }
    }
  }

  // the binned scatter of (position, rank), as sa_round_kernel's
  int slot[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    slot[j] = j < n && unsigned(src[j]) < unsigned(a.n)
                  ? atomicAdd(&off[src[j] >> a.shift], 1)
                  : -1;
  __syncthreads();
  int cnt[BIN_ITEMS], sum = 0;
#pragma unroll
  for (int q = 0; q < BIN_ITEMS; ++q) {
    const int b = threadIdx.x * BIN_ITEMS + q;
    cnt[q] = b < a.bins ? off[b] : 0;
    sum += cnt[q];
  }
  int rows;
  int o = block_scan<false, SumOp>(sum, 0, sagg, &rows);
#pragma unroll
  for (int q = 0; q < BIN_ITEMS; ++q) {
    const int b = threadIdx.x * BIN_ITEMS + q;
    if (cnt[q]) {
      off[b] = o;
      at[b] = atomicAdd(a.cursors + (long long)b * CURSOR_STRIDE, cnt[q]);
    }
    o += cnt[q];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (slot[j] < 0) continue;
    const int b = src[j] >> a.shift;
    const int base = b << a.shift;
    const int width = min(1 << a.shift, a.n - base);
    const int p = off[b] + slot[j];
    const int g = at[b] + slot[j];
    s_pos[p] = unsigned(src[j] - base) << 1;
    s_rank[p] = rk[j];
    s_dst[p] = g < width ? base + g : -1;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < rows; p += THREADS) {
    const int d = s_dst[p];
    if (d < 0) continue;
    a.st_pos[d] = s_pos[p];
    a.st_rank[d] = s_rank[p];
  }
}

// A compacted round's rank step (RANK_START's ranks): over the u rows of
// the slice of unresolved rows in the order of a stable sort by (key 0,
// key 1) (order[r]: the slice row; key 0 the group's start, sorted; key 1
// and the text position read through the order from the slice, which the
// L2 holds while it is small), with G and F the last group and rank start
// rows at or before r: rank[t] = key 0 + (F - G) (written where F != G:
// key 0 is the rank the row had), sa[key 0 + (r - G)] = t for the rows
// now resolved (the row's place in the whole order: a group's rows are
// contiguous in both; an unresolved row is placed in a later round), and
// the unresolved rows to the next slice. Rows are written in place: the
// round's keys were read before it.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dense_rank_comp_kernel(const RankArgs a) {
  __shared__ CompState cagg[33];
  __shared__ int wl0[WARPS], wl1[WARPS], wf[WARPS];
  const int t = take_ticket(a.ticket);   // synchronises the block
  const long long r0 = (long long)t * TILE + (long long)threadIdx.x * ITEMS;
  const int n = int(max(0ll, min((long long)ITEMS, a.n - r0)));
  int src[ITEMS], k0[ITEMS], k1[ITEMS], tt[ITEMS];
  load_items<ITEMS>(a.order, r0, a.n, a.vec, 0, src);
  load_items<ITEMS>(a.s0, r0, a.n, a.vec, 0, k0);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    k1[j] = j < n ? __ldg(a.key1 + src[j]) : 0;
    tt[j] = j < n ? __ldg(a.ti + src[j]) : 0;
  }
  int p0, next;
  unsigned ch;
  neighbours<true, false>(a, src, k0, k1, r0, wl0, wl1, nullptr, wf, &p0,
                          &ch, &next);
  unsigned gs = 0;   // bit j: row r0 + j starts a group (key 0 differs)
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (j < n && ((j == 0 && r0 == 0) || k0[j] != (j ? k0[j - 1] : p0)))
      gs |= 1u << j;
  const unsigned un = unresolved_bits(ch, next, r0, a.n);
  CompState tot;
  const CompState ex = block_scan<false, CompOp>(
      CompState{top_row(r0, gs), top_row(r0, ch), __popc(un)},
      CompOp::identity(), cagg, &tot);
  CompState run = CompOp::combine(lookback<CompOp>(a.slots, t, tot), ex);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j >= n) break;
    const int r = int(r0) + j;
    if (gs >> j & 1u) run.g = r;
    if (ch >> j & 1u) run.f = r;
    // int32 arithmetic wraps, as torch's does
    const int rank = int(unsigned(k0[j]) + unsigned(run.f - run.g));
    const int place = int(unsigned(k0[j]) + unsigned(r - run.g));
    // a row's rank changes only past its group's first rank run, and its
    // place is final only once it is resolved (a later round places the
    // others)
    if (run.f != run.g && unsigned(tt[j]) < unsigned(a.m))
      a.rank[tt[j]] = rank;
    if (!(un >> j & 1u) && unsigned(place) < unsigned(a.m))
      a.sa[place] = tt[j];
    if (un >> j & 1u) {
      if (run.cnt < a.cap) {
        a.ti_n[run.cnt] = tt[j];
        a.k0_n[run.cnt] = rank;
      }
      ++run.cnt;
    }
    if (r == a.n - 1) {
      a.top[0] = run.cnt;
      a.top[1] = *a.fault;
    }
  }
}

// The next compacted round's key 1 for the slice (ti, *count rows, at
// most cap): rank[t + h] + 1, 0 past the end.
constexpr int KEYS_THREADS = 256;

__global__ void __launch_bounds__(KEYS_THREADS)
    slice_keys_kernel(const int* __restrict__ ti, const int* rank,
                      int* __restrict__ k1, const int* count, int cap,
                      int m, long long h) {
  const long long rows = min(*count, cap);
  for (long long i = blockIdx.x * (long long)KEYS_THREADS + threadIdx.x;
       i < rows; i += (long long)gridDim.x * KEYS_THREADS) {
    const long long at = (long long)__ldg(ti + i) + h;
    k1[i] = at < m ? rank[at] + 1 : 0;
  }
}

// Second level: each bin's staging, in chunks of 4096 rows (2^shift is a
// multiple), sorted by fine bin of 4096 positions into a second staging
// laid over K (dead by then), as the kernel sorted the rows by bin: a
// shared count a fine bin, a scan, one global atomic a fine bin a chunk
// for the run's place, the runs (16 rows long at 256 fine bins) written
// coalesced. A row whose fine bin is full or past the bin is dropped.
constexpr int FINE_SHIFT = 12;
constexpr int FINE = 1 << FINE_SHIFT;        // positions a fine bin
constexpr int MAX_FINE = 1024;               // fine bins a bin (shift <= 22)
constexpr int CHUNK_THREADS = 512;
constexpr int CHUNK_ITEMS = 8;
constexpr int CHUNK = CHUNK_THREADS * CHUNK_ITEMS;
constexpr int FINE_ITEMS = MAX_FINE / CHUNK_THREADS;

struct Stage {        // one staging: bin-major rows, three int32 words
  unsigned* pos;      // the position in the bin << 1 | sing
  int* mid;
  int* full;
};

template <bool MID>
__global__ void __launch_bounds__(CHUNK_THREADS)
    sa_round_fine(const Stage s1, const int* __restrict__ cursors,
                  int* __restrict__ fine_cursors, const Stage s2, int m,
                  int shift) {
  extern __shared__ int smem[];
  int* off = smem;                       // MAX_FINE, then the rows by fine bin
  int* at = off + MAX_FINE;
  unsigned* c_pos = reinterpret_cast<unsigned*>(at + MAX_FINE);
  int* c_dst = reinterpret_cast<int*>(c_pos + CHUNK);
  int* c_full = c_dst + CHUNK;
  int* c_mid = c_full + CHUNK;           // MID only
  __shared__ int sagg[33];
  const int c0 = blockIdx.x * CHUNK;
  const int b = c0 >> shift;
  const int base = b << shift;
  const int width = min(1 << shift, m - base);
  const int n = min(__ldg(cursors + (long long)b * CURSOR_STRIDE), width);
  const int nf = ((width - 1) >> FINE_SHIFT) + 1;
  for (int f = threadIdx.x; f < nf; f += CHUNK_THREADS) off[f] = 0;
  __syncthreads();
  const int r0 = c0 + threadIdx.x * CHUNK_ITEMS;
  unsigned pos[CHUNK_ITEMS];
  int mv[CHUNK_ITEMS], fv[CHUNK_ITEMS], slot[CHUNK_ITEMS];
  if (r0 - base + CHUNK_ITEMS <= n) {
#pragma unroll
    for (int h = 0; h < CHUNK_ITEMS; h += 4) {
      const uint4 p = __ldcs(reinterpret_cast<const uint4*>(s1.pos + r0 + h));
      pos[h] = p.x; pos[h + 1] = p.y; pos[h + 2] = p.z; pos[h + 3] = p.w;
      const int4 f = __ldcs(reinterpret_cast<const int4*>(s1.full + r0 + h));
      fv[h] = f.x; fv[h + 1] = f.y; fv[h + 2] = f.z; fv[h + 3] = f.w;
      if (MID) {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(s1.mid + r0 + h));
        mv[h] = q.x; mv[h + 1] = q.y; mv[h + 2] = q.z; mv[h + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK_ITEMS; ++j) {
      const bool ok = r0 - base + j < n;
      pos[j] = ok ? __ldcs(s1.pos + r0 + j) : ~0u;
      fv[j] = ok ? __ldcs(s1.full + r0 + j) : 0;
      mv[j] = MID && ok ? __ldcs(s1.mid + r0 + j) : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < CHUNK_ITEMS; ++j) {
    const int f = pos[j] == ~0u ? -1 : int(pos[j] >> (1 + FINE_SHIFT));
    slot[j] = f >= 0 && f < nf ? atomicAdd(&off[f], 1) : -1;
  }
  __syncthreads();
  int cnt[FINE_ITEMS], sum = 0;
#pragma unroll
  for (int q = 0; q < FINE_ITEMS; ++q) {
    const int f = threadIdx.x * FINE_ITEMS + q;
    cnt[q] = f < nf ? off[f] : 0;
    sum += cnt[q];
  }
  int rows;
  int o = block_scan<false, SumOp>(sum, 0, sagg, &rows);
  // the fine bins of all bins, numbered along the text
  int* fc = fine_cursors + (base >> FINE_SHIFT);
#pragma unroll
  for (int q = 0; q < FINE_ITEMS; ++q) {
    const int f = threadIdx.x * FINE_ITEMS + q;
    if (cnt[q]) {
      off[f] = o;
      at[f] = atomicAdd(fc + f, cnt[q]);
    }
    o += cnt[q];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CHUNK_ITEMS; ++j) {
    if (slot[j] < 0) continue;
    const int f = int(pos[j] >> (1 + FINE_SHIFT));
    const int p = off[f] + slot[j];
    const int g = at[f] + slot[j];
    const int fbase = base + (f << FINE_SHIFT);
    c_pos[p] = pos[j];
    c_full[p] = fv[j];
    if (MID) c_mid[p] = mv[j];
    c_dst[p] = g < min(FINE, m - fbase) ? fbase + g : -1;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < rows; p += CHUNK_THREADS) {
    const int d = c_dst[p];
    if (d < 0) continue;
    s2.pos[d] = c_pos[p];
    s2.full[d] = c_full[p];
    if (MID) s2.mid[d] = c_mid[p];
  }
}

// Each fine bin of 4096 positions from the second staging into shared
// memory at its rows' positions, then written out in order: the ranks and
// flags (RES; the dense rank writes none) land in whole sectors. A
// position no row reached is not written. The rank history's rank steps
// also write the next round's shifted key (``nxt``: nxt[t] = full[t + h]
// + 1, 0 past the end; each position written once, by the fine bin that
// holds t + h, or past the end by t's).
constexpr int SETTLE_THREADS = 512;
constexpr int SETTLE_ITEMS = FINE / SETTLE_THREADS;   // 8
constexpr unsigned char NONE = 0xff;

struct Next {
  int* nxt;             // null: no shifted key
  long long h;
};

template <bool MID, bool RES>
__global__ void __launch_bounds__(SETTLE_THREADS)
    sa_round_settle(const Stage s2, const int* __restrict__ fine_cursors,
                    int* __restrict__ mid, int* __restrict__ full,
                    unsigned char* __restrict__ res, int m, bool vec,
                    const Next nx) {
  __shared__ int f_full[FINE], f_mid[MID ? FINE : 1];
  __shared__ __align__(8) unsigned char f_res[FINE];   // read 8 at a time
  const int base = blockIdx.x * FINE;
  const int width = min(FINE, m - base);
  const int n = min(__ldg(fine_cursors + blockIdx.x), width);
  for (int i = threadIdx.x; i < FINE; i += SETTLE_THREADS) f_res[i] = NONE;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += SETTLE_THREADS) {
    const unsigned w = __ldcs(s2.pos + base + i);
    const int p = int(w >> 1) & (FINE - 1);
    f_full[p] = __ldcs(s2.full + base + i);
    if (MID) f_mid[p] = __ldcs(s2.mid + base + i);
    f_res[p] = (unsigned char)(w & 1u);
  }
  __syncthreads();
  if (nx.nxt) {
    for (int i = threadIdx.x; i < width; i += SETTLE_THREADS) {
      const long long at = (long long)base + i;
      if (f_res[i] != NONE && at >= nx.h) nx.nxt[at - nx.h] = f_full[i] + 1;
      if (at + nx.h >= m) nx.nxt[at] = 0;
    }
  }
  const int i0 = threadIdx.x * SETTLE_ITEMS;
  if (i0 >= width) return;
  const uint2 rr = *reinterpret_cast<const uint2*>(f_res + i0);
  // every position reached (a flag byte is 0 or 1, NONE otherwise)
  const bool whole = vec && i0 + SETTLE_ITEMS <= width &&
                     ((rr.x | rr.y) & 0xfefefefeu) == 0;
  if (whole) {
#pragma unroll
    for (int h = 0; h < SETTLE_ITEMS; h += 4) {
      st16(full + base + i0 + h, f_full + i0 + h);
      if (MID) st16(mid + base + i0 + h, f_mid + i0 + h);
    }
    if (RES) *reinterpret_cast<uint2*>(res + base + i0) = rr;
  } else {
    for (int j = 0; j < SETTLE_ITEMS && i0 + j < width; ++j) {
      if (f_res[i0 + j] == NONE) continue;
      full[base + i0 + j] = f_full[i0 + j];
      if (MID) mid[base + i0 + j] = f_mid[i0 + j];
      if (RES) res[base + i0 + j] = f_res[i0 + j];
    }
  }
}

// a step's key rows side by side, 4 rows a thread: NR rows, row q int64
// (its high word, then its low word) where bit q of WIDE is set, else
// int32; the words past them 0, KW words a row
constexpr int PACK_THREADS = 256;

template <int NR, unsigned WIDE, int KW>
__global__ void __launch_bounds__(PACK_THREADS)
    sa_round_pack(const void* r0p, const void* r1p, const void* r2p,
                  const void* r3p, int4* __restrict__ K, int R, bool vec) {
  const long long r0 = 4 * ((long long)blockIdx.x * PACK_THREADS +
                            threadIdx.x);
  if (r0 >= R) return;
  const void* rows[4] = {r0p, r1p, r2p, r3p};
  int v[4][KW];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < KW; ++q) v[j][q] = 0;
  const bool whole = vec && r0 + 4 <= R;
  int w = 0;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if (WIDE >> q & 1u) {
      const long long* x = static_cast<const long long*>(rows[q]);
      long long y[4];
      if (whole) {
        ld16(x + r0, y);
        ld16(x + r0 + 2, y + 2);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = r0 + j < R ? __ldg(x + r0 + j) : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j][w] = int(y[j] >> 32);
        v[j][w + 1] = int(y[j]);
      }
      w += 2;
    } else {
      const int* x = static_cast<const int*>(rows[q]);
      int y[4];
      if (whole) {
        ld16(x + r0, y);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = r0 + j < R ? __ldg(x + r0 + j) : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j][w] = y[j];
      w += 1;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (r0 + j < R)
#pragma unroll
      for (int h = 0; h < KW / 4; ++h)
        K[(r0 + j) * (KW / 4) + h] = make_int4(v[j][4 * h], v[j][4 * h + 1],
                                               v[j][4 * h + 2],
                                               v[j][4 * h + 3]);
}

long long tiles_of(long long R) { return (R + TILE - 1) / TILE; }

// the bins' cursors follow the tiles' states, 128-byte aligned
long long cursors_at(long long R) {
  return (lookback_bytes(tiles_of(R), int(sizeof(Starts))) + 127) / 128 *
         128;
}

int bins_of(int m, int shift) { return ((m - 1) >> shift) + 1; }

}  // namespace

extern "C" {

// bytes of scratch (zeroed by the caller) for R rows of m positions in
// bins of 2^shift: the ticket, the count, three state words a tile, and
// one cursor a bin
long long sa_round_scratch_bytes(long long R, int m, int shift) {
  return cursors_at(R) + 4ll * CURSOR_STRIDE * bins_of(m, shift) +
         4ll * ((m + FINE - 1) / FINE);
}

// the byte offset of the unresolved count (int32) in the scratch
long long sa_round_count_offset() { return 4; }

// layout 0: four int32 rows (a round's keys; KW 4); 1: an int64 row and
// an int32 row (the narrow seed's pack and payload; KW 4); 2: three int64
// rows (the wide seed's two packs and payload; KW 8). K: at least R
// rows of 4 x KW bytes, 16-byte aligned; unused rows may be null
int sa_round_pack_launch(int layout, const void* r0, const void* r1,
                         const void* r2, const void* r3, void* K, int R,
                         void* stream) {
  if (R < 1 || layout < 0 || layout > 2 || !aligned16(K))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long quads = (R + 3ll) / 4;
  const int blocks = int((quads + PACK_THREADS - 1) / PACK_THREADS);
  const bool vec = aligned16(r0) && aligned16(r1) &&
                   (layout == 1 || aligned16(r2)) &&
                   (layout != 0 || aligned16(r3));
  int4* k4 = static_cast<int4*>(K);
  if (layout == 0)
    sa_round_pack<4, 0u, 4><<<blocks, PACK_THREADS, 0, s>>>(r0, r1, r2, r3,
                                                            k4, R, vec);
  else if (layout == 1)
    sa_round_pack<2, 1u, 4><<<blocks, PACK_THREADS, 0, s>>>(r0, r1, r2, r3,
                                                            k4, R, vec);
  else
    sa_round_pack<3, 7u, 8><<<blocks, PACK_THREADS, 0, s>>>(r0, r1, r2, r3,
                                                            k4, R, vec);
  return int(cudaGetLastError());
}

// mode 0: a full round (R == m < 2^30; ti, ti_s, rank_u, keep unused);
// 1: a compacted round (lv_in and the staging unused; mid_rank,
// full_rank, resolved, lv_out the caller's copies); 2, 3: the narrow and
// the wide seed (R == m < 2^30; k the seed level; lv_in, mid_rank and
// st_mid unused; full_rank the rank). perm, ti, ti_s, rank_u: R int32;
// K: R + 8 rows of packed key words; keep: R bytes; lv_in, lv_out,
// mid_rank, full_rank and each staging row: m int32; resolved: m bytes;
// 1 <= R <= m < 2^31 - 1; the bins: 2^shift positions each (12 <= shift
// <= 22), at most 1024 of them (kernels.sa_round_bins)
int sa_round_launch(int mode, const void* perm, const void* K,
                    const void* ti, const void* lv_in, void* lv_out,
                    void* mid_rank, void* full_rank, void* resolved,
                    void* st_pos, void* st_mid, void* st_full, void* ti_s,
                    void* rank_u, void* keep, int R, int m, int k, int shift,
                    void* scratch, void* stream) {
  const bool binned = mode != COMP_ROUND;
  if (mode < 0 || mode > 3 || R < 1 || m < R ||
      (binned && (R != m || m >= (1 << 30))) || shift < FINE_SHIFT ||
      shift > FINE_SHIFT + 10 ||
      bins_of(m, shift) > MAX_BINS || !aligned16(K) ||
      (binned && (!aligned16(st_pos) || !aligned16(st_full) ||
                  (mode == FULL_ROUND && !aligned16(st_mid)))))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.perm = static_cast<const int*>(perm);
  a.K = static_cast<const int4*>(K);
  a.ti = static_cast<const int*>(ti);
  a.lv_in = static_cast<const int*>(lv_in);
  a.lv_out = static_cast<int*>(lv_out);
  a.mid_rank = static_cast<int*>(mid_rank);
  a.full_rank = static_cast<int*>(full_rank);
  a.resolved = static_cast<unsigned char*>(resolved);
  a.st_pos = static_cast<unsigned*>(st_pos);
  a.st_mid = static_cast<int*>(st_mid);
  a.st_full = static_cast<int*>(st_full);
  a.ti_s = static_cast<int*>(ti_s);
  a.rank_u = static_cast<int*>(rank_u);
  a.keep = static_cast<unsigned char*>(keep);
  a.R = R;
  a.m = m;
  a.k = k;
  a.shift = shift;
  a.bins = bins_of(m, shift);
  a.vec = aligned16(perm) && aligned16(lv_out) &&
          (mode == COMP_ROUND ? aligned16(ti_s) && aligned16(rank_u)
                               : mode != FULL_ROUND || aligned16(lv_in));
  char* sc = static_cast<char*>(scratch);
  a.ticket = reinterpret_cast<unsigned*>(sc);
  a.count = reinterpret_cast<int*>(sc + 4);
  a.slots = reinterpret_cast<unsigned long long*>(sc + 16);
  a.cursors = reinterpret_cast<int*>(sc + cursors_at(R));
  const int tiles = int(tiles_of(R));
  if (mode == FULL_ROUND)
    sa_round_kernel<FULL_ROUND><<<tiles, THREADS, 0, s>>>(a);
  else if (mode == COMP_ROUND)
    sa_round_kernel<COMP_ROUND><<<tiles, THREADS, 0, s>>>(a);
  else if (mode == SEED_NARROW)
    sa_round_kernel<SEED_NARROW><<<tiles, THREADS, 0, s>>>(a);
  else
    sa_round_kernel<SEED_WIDE><<<tiles, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !binned) return int(err);
  // K is dead once the kernel has run: the second staging goes there
  const long long m4 = (m + 3ll) & ~3ll;
  int* k32 = static_cast<int*>(const_cast<void*>(K));
  const Stage s1{a.st_pos, a.st_mid, a.st_full};
  const Stage s2{reinterpret_cast<unsigned*>(k32), k32 + 2 * m4, k32 + m4};
  int* fine_cursors = a.cursors + (long long)CURSOR_STRIDE * a.bins;
  const int chunks = (m + CHUNK - 1) / CHUNK;
  const int fine_bins = (m + FINE - 1) / FINE;
  const bool vec = aligned16(full_rank) &&
                   (mode != FULL_ROUND || aligned16(mid_rank)) &&
                   (reinterpret_cast<uintptr_t>(resolved) & 7) == 0;
  if (mode == FULL_ROUND) {
    const int smem = (2 * MAX_FINE + 4 * CHUNK) * 4;
    err = cudaFuncSetAttribute(sa_round_fine<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return int(err);
    sa_round_fine<true><<<chunks, CHUNK_THREADS, smem, s>>>(
        s1, a.cursors, fine_cursors, s2, m, shift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    sa_round_settle<true, true><<<fine_bins, SETTLE_THREADS, 0, s>>>(
        s2, fine_cursors, a.mid_rank, a.full_rank, a.resolved, m, vec,
        Next{nullptr, 0});
  } else {
    const int smem = (2 * MAX_FINE + 3 * CHUNK) * 4;
    err = cudaFuncSetAttribute(sa_round_fine<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return int(err);
    sa_round_fine<false><<<chunks, CHUNK_THREADS, smem, s>>>(
        s1, a.cursors, fine_cursors, s2, m, shift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    sa_round_settle<false, true><<<fine_bins, SETTLE_THREADS, 0, s>>>(
        s2, fine_cursors, a.mid_rank, a.full_rank, a.resolved, m, vec,
        Next{nullptr, 0});
  }
  return int(cudaGetLastError());
}

// The doubling rounds' full rank step: dense_rank_kernel in ``mode``
// (RANK_DENSE, RANK_START), then sa_round_fine and sa_round_settle without
// flags. order, s0, key1 (text order, or null) and rank: n int32 (rank
// written at every position); DENSE: nxt (or null), n int32, the next
// round's key 1 at shift h; START: ti_n, k0_n, k1_n, the next slice, cap
// int32 each (1 <= cap; its key 1 at shift h), no nxt; st: 2 * ((n + 3) &
// ~3) int32, the first staging (positions,
// then ranks), st2 the same for the second; 1 <= n < 2^30, bins of 2^shift
// positions as for sa_round_launch; the scratch as
// sa_round_scratch_bytes(n, n, shift), zeroed; fault the sorts' fault
// word. Writes the largest rank (DENSE) or the unresolved count (START)
// and the fault word's copy at scratch + 4 and + 8
// (sa_round_count_offset).
int dense_rank_launch(int mode, const void* order, const void* s0,
                      const void* key1, void* rank, void* nxt, long long h,
                      void* ti_n, void* k0_n, void* k1_n, int cap,
                      void* st, void* st2, int n, int shift, void* scratch,
                      const void* fault, void* stream) {
  const bool start = mode == RANK_START;
  if (mode < RANK_DENSE || mode > RANK_START || n < 1 || n >= (1 << 30) ||
      shift < FINE_SHIFT || shift > FINE_SHIFT + 10 ||
      bins_of(n, shift) > MAX_BINS || !aligned16(st) || !aligned16(st2) ||
      h < 0 || (start && (cap < 1 || !ti_n || !k0_n || !k1_n || nxt)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long m4 = (n + 3ll) & ~3ll;
  RankArgs a{};
  a.order = static_cast<const int*>(order);
  a.s0 = static_cast<const int*>(s0);
  a.key1 = static_cast<const int*>(key1);
  a.ti_n = static_cast<int*>(ti_n);
  a.k0_n = static_cast<int*>(k0_n);
  a.cap = start ? cap : 0;
  a.n = a.m = n;
  a.shift = shift;
  a.bins = bins_of(n, shift);
  a.vec = aligned16(order) && aligned16(s0);
  char* sc = static_cast<char*>(scratch);
  a.ticket = reinterpret_cast<unsigned*>(sc);
  a.top = reinterpret_cast<int*>(sc + 4);
  a.fault = static_cast<const int*>(fault);
  a.slots = reinterpret_cast<unsigned long long*>(sc + 16);
  a.cursors = reinterpret_cast<int*>(sc + cursors_at(n));
  int* s1 = static_cast<int*>(st);
  a.st_pos = reinterpret_cast<unsigned*>(s1);
  a.st_rank = s1 + m4;
  if (start)
    dense_rank_kernel<RANK_START><<<int(tiles_of(n)), THREADS, 0, s>>>(a);
  else
    dense_rank_kernel<RANK_DENSE><<<int(tiles_of(n)), THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  int* s2p = static_cast<int*>(st2);
  const Stage first{a.st_pos, nullptr, a.st_rank};
  const Stage second{reinterpret_cast<unsigned*>(s2p), nullptr, s2p + m4};
  int* fine_cursors = a.cursors + (long long)CURSOR_STRIDE * a.bins;
  const int smem = (2 * MAX_FINE + 3 * CHUNK) * 4;
  err = cudaFuncSetAttribute(sa_round_fine<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  sa_round_fine<false><<<int((n + CHUNK - 1) / CHUNK), CHUNK_THREADS, smem,
                         s>>>(first, a.cursors, fine_cursors, second, n,
                              shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  sa_round_settle<false, false><<<int((n + FINE - 1) / FINE),
                                  SETTLE_THREADS, 0, s>>>(
      second, fine_cursors, nullptr, static_cast<int*>(rank), nullptr, n,
      aligned16(rank), Next{static_cast<int*>(nxt), h});
  err = cudaGetLastError();
  if (err != cudaSuccess || !start) return int(err);
  const int blocks = int(min((cap + KEYS_THREADS - 1ll) / KEYS_THREADS,
                             4096ll));
  slice_keys_kernel<<<blocks, KEYS_THREADS, 0, s>>>(
      a.ti_n, static_cast<const int*>(rank), static_cast<int*>(k1_n), a.top,
      cap, n, h);
  return int(cudaGetLastError());
}

// A compacted round's rank step: dense_rank_comp_kernel over the u sorted
// rows of the slice (perm, s0: u int32; k1, ti: the slice's key 1 and
// text positions, u int32, by slice row), rank and sa: m int32 (written at
// the slice's positions and places), the next slice into ti_n and k0_n
// (cap int32 each; ti_n not ti), then its key 1 at shift h into k1 (h 0:
// not). 1 <= u <= m < 2^30; the scratch as sa_round_scratch_bytes(u, m,
// shift) for any valid shift, zeroed. Writes the unresolved count and the
// fault word's copy at scratch + 4 and + 8.
int dense_rank_comp_launch(const void* perm, const void* s0, void* k1,
                           const void* ti, void* rank, void* sa, void* ti_n,
                           void* k0_n, int cap, long long h, int u, int m,
                           void* scratch, const void* fault, void* stream) {
  if (u < 1 || m < u || m >= (1 << 30) || cap < 0 || h < 0 || ti_n == ti ||
      (cap > 0 && (!ti_n || !k0_n)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RankArgs a{};
  a.order = static_cast<const int*>(perm);
  a.s0 = static_cast<const int*>(s0);
  a.key1 = static_cast<const int*>(k1);
  a.ti = static_cast<const int*>(ti);
  a.rank = static_cast<int*>(rank);
  a.sa = static_cast<int*>(sa);
  a.ti_n = static_cast<int*>(ti_n);
  a.k0_n = static_cast<int*>(k0_n);
  a.cap = cap;
  a.n = u;
  a.m = m;
  a.vec = aligned16(perm) && aligned16(s0);
  char* sc = static_cast<char*>(scratch);
  a.ticket = reinterpret_cast<unsigned*>(sc);
  a.top = reinterpret_cast<int*>(sc + 4);
  a.fault = static_cast<const int*>(fault);
  a.slots = reinterpret_cast<unsigned long long*>(sc + 16);
  dense_rank_comp_kernel<<<int(tiles_of(u)), THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || h == 0 || cap == 0) return int(err);
  const int blocks = int(min((cap + KEYS_THREADS - 1ll) / KEYS_THREADS,
                             4096ll));
  slice_keys_kernel<<<blocks, KEYS_THREADS, 0, s>>>(
      a.ti_n, a.rank, static_cast<int*>(k1), a.top, cap, m, h);
  return int(cudaGetLastError());
}

}  // extern "C"
