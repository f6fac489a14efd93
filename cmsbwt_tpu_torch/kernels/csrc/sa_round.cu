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
// The group-start mode also counts the slice's rows in groups larger
// than C_CAP (below). The largest rank or the unresolved count, the fault
// word and that count go into words the host reads in one copy a round.
//
// The compacted rounds (dense_rank_comp_launch; the counterpart of
// cmsbwt_tpu/index/device.py:80-99, round_k's do_sort, which no JAX
// function runs on the unresolved rows only) take the slice in the order
// the round before wrote it: sorted by key 0, the group's start rank, so
// a group's rows are contiguous and need sorting by key 1 only among
// themselves. comp_round_kernel gives each block the groups whose first
// row falls in its tile of C_TILE slice rows (it finds them from key 0:
// tile_groups), reads key 1 and the text positions in slice order,
// coalesced, sorts each group stably by key 1 in shared memory
// (sort_groups: a count of the smaller keys, a few reads a row for the
// head string's groups of 2-12 rows, where no group of the block has more
// than C_SMALL rows; else a bitonic network over the block's rows, whose
// cost does not grow with the groups' size), writes the changed ranks, the
// resolved rows' places and, through one look-back of the tiles' counts,
// the next slice in sorted order; slice_keys_kernel then gathers the next
// round's key 1 once the ranks have landed. A group of more than C_CAP
// rows (none in the bench's head strings) takes the large-group path
// first: comp_pick_kernel picks its rows, radix_sort sorts them by (key
// 0, key 1) (the wrapper's call) and comp_large_kernel ranks them, its
// unresolved rows handed to the tiles the group spans, in order. A slice
// of C_CAP rows or fewer runs every round left in one block
// (dense_rank_comp_tail_launch, comp_tail_kernel): the slice stays in
// shared memory, each round gathers its own key 1 after a barrier, and
// the host reads once, after the launch. Equal to
// index/device._dense_rank_reference, _comp_rank_reference and
// _comp_tail_reference element for element.
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
  int* g_n;             // compacted: their key 0 before the step
  int* large;           // START, compacted: += the rows the slice holds in
                        //   groups larger than C_CAP
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

// The compacted rounds' shared-memory sort: a block holds the groups
// whose first row falls in its tile of C_TILE slice rows, each at most
// C_CAP rows (the largest group sorted in shared memory; a larger one
// takes the large-group path); C_ROWS rows in all. The cap is
// index/device.COMP_CAP, which the build passes as COMP_CAP. A block
// whose largest group has at most C_SMALL rows sorts by counting, a
// larger one by a bitonic network over all its rows (sort_groups): on
// the H100, on slices of 9.6 M rows, counting is the faster up to groups
// of 128 rows and the slower from 256 (tools/profile_slice.py
// --comp-groups), and the network beats the large-group path at every
// size up to the cap.
#ifndef COMP_CAP
#error "build with -DCOMP_CAP=<index/device.COMP_CAP>"
#endif
constexpr int C_THREADS = 512;
constexpr int C_TILE = 2048;
constexpr int C_CAP = COMP_CAP;
constexpr int C_SMALL = 128;
constexpr int C_ROWS = C_TILE + C_CAP;
constexpr int C_ITEMS = C_ROWS / C_THREADS;   // a thread's rows
constexpr int T_ITEMS = C_CAP / C_THREADS;    // the tail's
static_assert(C_TILE <= C_CAP, "a group inside a tile is never large");
static_assert(C_ROWS % C_THREADS == 0 && C_CAP % C_THREADS == 0,
              "whole rows a thread");
static_assert(C_ROWS <= (1 << 13), "row indexes in 13 bits (sort_groups)");
static_assert(3 * (C_TILE + C_ROWS) * 4 <= 227 * 1024,
              "comp_round_kernel's shared memory");

// Rows of the next slice in groups larger than C_CAP, counted at a row
// that stays unresolved d rows after its run's first row: a run of L >
// C_CAP rows counts L (1 at each d > C_CAP, C_CAP + 1 at d == C_CAP).
__device__ __forceinline__ int big_rows(int d) {
  return d > C_CAP ? 1 : (d == C_CAP ? C_CAP + 1 : 0);
}

// one atomic a warp for a count that is 0 almost everywhere
__device__ __forceinline__ void add_count(int* word, int v) {
  const unsigned b = __ballot_sync(FULL, v != 0);
  if (!b) return;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(FULL, v, d);
  if ((threadIdx.x & 31) == 0) atomicAdd(word, v);
}

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
    int big = 0;
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
        big += big_rows(int(r0) + j - run.f);
      }
      if (j < n && r0 + j == a.n - 1) {
        a.top[0] = run.cnt;
        a.top[1] = *a.fault;
      }
    }
    add_count(a.large, big);
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

// The large-group path's rank step (RANK_START's ranks): over the rows
// of the groups larger than C_CAP, picked from the slice
// (comp_pick_kernel) and sorted stably by (key 0, key 1) on radix_sort
// (order[r]: the picked row; key 1 and the text position read through
// the order), with G and F the last group and rank start rows at or
// before r: rank[t] = key 0 + (F - G) (written where F != G: key 0 is the
// rank the row had), sa[key 0 + (r - G)] = t for the rows now resolved
// (the row's place in the whole order: a group's rows are contiguous in
// both; an unresolved row is placed in a later round), and the
// unresolved rows, with their key 0 before the step, to the large
// groups' part of the next slice (``ti_n``, ``k0_n``, ``g_n``), which
// comp_round_kernel then places. Counts the next slice's rows in groups
// larger than C_CAP into *large.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    comp_large_kernel(const RankArgs a) {
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
  int big = 0;
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
        a.g_n[run.cnt] = k0[j];
      }
      ++run.cnt;
      big += big_rows(r - run.f);
    }
    if (r == a.n - 1) {
      a.top[0] = run.cnt;
      a.top[1] = *a.fault;
    }
  }
  add_count(a.large, big);
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
    k1[i] = (unsigned long long)at < (unsigned long long)m ? rank[at] + 1
                                                            : 0;
  }
}

// ---------------------------------------------------------------------------
// The compacted rounds: comp_pick_kernel, comp_large_kernel (above),
// comp_round_kernel, slice_keys_kernel; comp_tail_kernel
// ---------------------------------------------------------------------------

struct MaxOp {
  static __device__ __forceinline__ int identity() { return -1; }
  static __device__ __forceinline__ int combine(int x, int y) {
    return max(x, y);
  }
  static __device__ __forceinline__ bool absorbs(int) { return false; }
};

// a tile's rows for the next slice, and the faults it found
struct CountFault {
  int cnt, fault;
};

struct CountFaultOp {
  static __device__ __forceinline__ CountFault identity() {
    return CountFault{0, 0};
  }
  static __device__ __forceinline__ CountFault combine(const CountFault& x,
                                                       const CountFault& y) {
    return CountFault{x.cnt + y.cnt, x.fault | y.fault};
  }
  static __device__ __forceinline__ bool absorbs(const CountFault&) {
    return false;
  }
};

// ops/sort.COUNT_FAULT: a count the caller stated was wrong
constexpr int COUNT_FAULT = 1 << 4;
// a place outside [0, m) (m < 2^30): not written
constexpr unsigned NO_PLACE = (1u << 30) - 1;

struct CompArgs {
  const int* ti;        // the slice: text positions, key 0 (the group's
  const int* k0;        //   start rank, nondecreasing: a group's rows are
  int* k1;              //   contiguous) and key 1, u rows each
  int* rank;            // m int32, written at the slice's positions
  int* sa;              // m int32, written at the resolved rows' places
  int* ti_n;            // the next slice (cap rows; not ti, k0)
  int* k0_n;
  int u, m, cap;
  int large;            // the slice's rows in groups larger than C_CAP
  const int* l_ti;      // the large groups' part of the next slice
  const int* l_k0;      //   (comp_large_kernel's ti_n, k0_n, g_n), in
  const int* l_g;       //   sorted order, *l_count rows
  const int* l_count;
  int* p_k0;            // comp_pick_kernel: the large groups' rows
  int* p_k1;
  int* p_ti;
  unsigned* ticket;
  int* top;             // the next slice's rows, the fault word's copy,
                        // the rows in its large groups, the rounds run
  int* fault;           // the sorts' fault word
  unsigned long long* slots;
  long long h;          // the tail: the first round's shift
  int rounds;           // the tail: the most rounds it runs
};

// The first index in [lo, hi) at which the nondecreasing ``v`` exceeds
// ``x`` (hi if none), found by the calling warp in rounds of 32 probes
// that each cut the range 32-fold; every lane gets it.
__device__ __forceinline__ int first_above(const int* __restrict__ v, int lo,
                                           int hi, int x) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const long long i = lo + (long long)lane * step;
    const bool p = i >= hi || __ldg(v + i) > x;
    const unsigned b = __ballot_sync(FULL, p);
    if (!b) {               // every probe at or below x
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(b) - 1;
    if (f == 0) return lo;
    hi = int(min((long long)hi, lo + (long long)f * step));
    lo += (f - 1) * step + 1;
  }
  return lo;
}

// A tile of slice rows [lo, hi) and the groups that cross its edges
// (every group inside it has fewer than C_TILE <= C_CAP rows).
struct TileGroups {
  int lo, hi;
  int first_in;   // the first group start in the tile (hi: none)
  int last_in;    // the last (-1: none)
  int large0;     // the group holding row lo starts before it and is large
  int a0, v0;     //   its first row and key 0
  int large1;     // the group starting at last_in is large
  int v1, b1;     //   its key 0; its end where it is not large
  // comp_round_kernel: the large groups' rows of the next slice that
  // fall to this tile (the j-th unresolved row of a large group of first
  // row a to the tile holding row a + j): n0 from l_* row s0 (before the
  // tile's own groups), n1 from s1 (after them)
  int n0, s0, n1, s1;
  int fault;
};

// Fills *g (shared) for the tile [lo, hi), whose key 0 is in s_k0 (and
// the row before it in ``prev``): group starts by the block, the rest by
// warp 0, whose reads beside the tile go out at once (the row C_CAP + 1
// before the first start, the row C_CAP after the last, the 32 rows
// after the tile: where the last group ends, for the head string's small
// groups); it searches only where a group may be large or runs on. With
// ``placed`` it also finds the large groups' rows in the large path's
// part of the next slice.
__device__ void tile_groups(const CompArgs& a, int lo, int hi,
                            const int* s_k0, int prev, bool placed,
                            TileGroups* g) {
  __shared__ int s_first, s_last;
  if (threadIdx.x == 0) {
    s_first = hi;
    s_last = -1;
  }
  __syncthreads();
  int first = hi, last = -1;
  for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    if (r == 0 || s_k0[r - lo] != (r > lo ? s_k0[r - lo - 1] : prev)) {
      first = min(first, r);
      last = r;
    }
  }
  if (first < hi) {
    atomicMin(&s_first, first);
    atomicMax(&s_last, last);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    TileGroups x;
    x.lo = lo;
    x.hi = hi;
    x.first_in = s_first;
    x.last_in = s_last;
    x.v0 = s_k0[0];
    x.a0 = lo;
    x.large0 = 0;
    x.large1 = 0;
    x.v1 = 0;
    x.b1 = hi;
    x.n0 = x.s0 = x.n1 = x.s1 = 0;
    x.fault = 0;
    const bool cont = x.first_in != lo;   // row lo continues a group
    const bool any = x.first_in < hi;     // a group starts in the tile
    const long long at0 = (long long)x.first_in - C_CAP - 1;
    const long long at1 = (long long)x.last_in + C_CAP;
    int w = 0;
    if (lane == 0 && cont && any && at0 >= 0) w = __ldg(a.k0 + at0);
    if (lane == 1 && any && at1 < a.u) w = __ldg(a.k0 + at1);
    // key 0 < 2^30: INT_MAX past the slice ends every group
    const int after = hi + lane < a.u ? __ldg(a.k0 + hi + lane) : INT_MAX;
    const int w0 = __shfl_sync(FULL, w, 0), w1 = __shfl_sync(FULL, w, 1);
    if (cont) {
      if (any) {
        // large iff it began C_CAP + 1 rows or more before its end
        x.large0 = at0 >= 0 && w0 == x.v0;
        if (x.large0) x.a0 = first_above(a.k0, 0, lo, x.v0 - 1);
      } else {                  // it covers the tile
        x.a0 = first_above(a.k0, 0, lo, x.v0 - 1);
        const int b0 = first_above(a.k0, hi, a.u, x.v0);
        x.large0 = b0 - x.a0 > C_CAP;
      }
    }
    if (any) {
      x.v1 = s_k0[x.last_in - lo];
      x.large1 = at1 < a.u && w1 == x.v1;
      if (!x.large1) {          // it ends by last_in + C_CAP
        const unsigned b = __ballot_sync(FULL, after > x.v1);
        x.b1 = b ? hi + __ffs(b) - 1
                 : first_above(a.k0, hi + 32,
                               int(min((long long)a.u, at1 + 1)), x.v1);
      }
    }
    if (placed && (x.large0 || x.large1)) {
      if (!a.large) {
        x.fault = COUNT_FAULT;    // a large group the caller did not count
      } else {
        const int nl = *a.l_count;
        if (x.large0) {         // rows j in [lo - a0, hi - a0) of its part
          const int s = first_above(a.l_g, 0, nl, x.v0 - 1);
          const int c = first_above(a.l_g, s, nl, x.v0) - s;
          const int j0 = lo - x.a0, j1 = min(c, hi - x.a0);
          x.n0 = max(0, j1 - j0);
          x.s0 = s + j0;
        }
        if (x.large1) {         // rows j in [0, hi - last_in)
          const int s = first_above(a.l_g, 0, nl, x.v1 - 1);
          const int c = first_above(a.l_g, s, nl, x.v1) - s;
          x.n1 = min(c, hi - x.last_in);
          x.s1 = s;
        }
      }
    }
    if (lane == 0) *g = x;
  }
  __syncthreads();
}

// The large-group path's first step: the rows of the slice's groups
// larger than C_CAP, in slice order, into p_k0, p_k1 and p_ti (a.large
// rows; a tile's rows placed by a look-back of their count). A count
// other than a.large ORs COUNT_FAULT into the fault word.
__global__ void __launch_bounds__(C_THREADS)
    comp_pick_kernel(const CompArgs a) {
  __shared__ int s_k0[C_TILE];
  __shared__ int s_prev;
  __shared__ TileGroups g;
  const int t = take_ticket(a.ticket);
  const int lo = t * C_TILE, hi = min(a.u, lo + C_TILE);
  for (int r = lo + threadIdx.x; r < hi; r += C_THREADS)
    s_k0[r - lo] = __ldg(a.k0 + r);
  if (threadIdx.x == 0) s_prev = lo ? __ldg(a.k0 + lo - 1) : 0;
  __syncthreads();
  tile_groups(a, lo, hi, s_k0, s_prev, false, &g);
  // the large rows: before the first group start, from the last one on
  const int e0 = g.large0 ? min(hi, g.first_in) : lo;
  const int b1 = g.large1 ? g.last_in : hi;
  const int cnt = (e0 - lo) + (hi - b1);
  const CountFault pre = lookback<CountFaultOp>(a.slots, t, CountFault{cnt,
                                                                       0});
  if (t == int(gridDim.x) - 1 && threadIdx.x == 0 && pre.cnt + cnt != a.large)
    atomicOr(a.fault, COUNT_FAULT);
  for (int i = threadIdx.x; i < cnt; i += C_THREADS) {
    const int r = i < e0 - lo ? lo + i : b1 + (i - (e0 - lo));
    const int d = pre.cnt + i;
    if (d < a.large) {
      a.p_k0[d] = s_k0[r - lo];
      a.p_k1[d] = __ldg(a.k1 + r);
      a.p_ti[d] = __ldg(a.ti + r);
    }
  }
}

// Each of n rows in shared memory, groups contiguous (``start`` of a
// row: key 0 differs from the row before's, or it is row 0), sorted
// stably by key 1 inside its group: s_k1 (key 1 by row) is rewritten in
// sorted order, s_ts gets each sorted row's text position (``tpos`` of
// the row it came from), s_ge each row's group start G and, at G, the
// group's end << 16. If the block's largest group has at most C_SMALL
// rows, a row's place is G + the rows of its group with a smaller key 1,
// or an equal one and an earlier row: a count, a few reads a row for the
// head string's groups of 2-12 rows, but as many as the group's rows. A
// block with a larger group sorts all its rows at once instead, by (G,
// key 1, row) in one 64-bit word a row, unique, so the order is the
// stable one: a bitonic network over the next power of two (the rows past
// n are +inf and never move), log2(N) (log2(N) + 1) / 2 passes of N / 2
// compare-exchanges, whatever the groups' sizes. Its words lie in s_key,
// over s_ts and s_ge (n 64-bit words; both are rewritten after it). Rows
// are striped over the threads (neighbouring lanes on neighbouring rows:
// one group's keys are read by broadcast); the starts are found by IT
// consecutive rows a thread.
template <int IT, class Start, class TPos>
__device__ __forceinline__ void sort_groups(int n, Start start, TPos tpos,
                                            int* s_k1, int* s_ts,
                                            unsigned* s_ge,
                                            unsigned long long* s_key,
                                            int* sagg) {
  __shared__ int s_largest;
  const int q0 = threadIdx.x * IT;
  unsigned st = 0;
  int top = -1;
#pragma unroll
  for (int x = 0; x < IT; ++x)
    if (q0 + x < n && start(q0 + x)) {
      st |= 1u << x;
      top = q0 + x;
    }
  if (threadIdx.x == 0) s_largest = 0;
  int tot;
  int G = block_scan<false, MaxOp>(top, -1, sagg, &tot);
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    if (st >> x & 1u) G = q0 + x;
    if (q0 + x < n) s_ge[q0 + x] = unsigned(G);
  }
  __syncthreads();
  int largest = 0;
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    const int q = q0 + x;
    if (q >= n) break;
    const bool end = q + 1 == n ||
                     (x + 1 < IT ? (st >> (x + 1) & 1u) != 0 : start(q + 1));
    if (end) {
      const int g0 = int(s_ge[q] & 0xffffu);
      s_ge[g0] |= unsigned(q + 1) << 16;
      largest = max(largest, q + 1 - g0);
    }
  }
  if (largest > C_SMALL) atomicMax(&s_largest, largest);
  __syncthreads();
  int key[IT], pos[IT];
  if (s_largest == 0) {
#pragma unroll
    for (int x = 0; x < IT; ++x) {
      const int i = threadIdx.x + x * C_THREADS;
      pos[x] = -1;
      key[x] = 0;
      if (i < n) {
        const int g0 = int(s_ge[i] & 0xffffu);
        const int g1 = int(s_ge[g0] >> 16);
        const int k = s_k1[i];
        int c = 0;
        for (int j = g0; j < g1; ++j) {
          const int kj = s_k1[j];
          c += kj < k || (kj == k && j < i);
        }
        key[x] = k;
        pos[x] = g0 + c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < IT; ++x) {
      if (pos[x] < 0) continue;
      s_k1[pos[x]] = key[x];
      s_ts[pos[x]] = tpos(threadIdx.x + x * C_THREADS);
    }
    __syncthreads();
    return;
  }
  // the bitonic path: each row's word, (G << 44 | key 1 << 13 | row); key
  // 1 is a rank + 1 or 0, below 2^31
  unsigned long long w[IT];
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    const int i = threadIdx.x + x * C_THREADS;
    w[x] = i < n ? (unsigned long long)(s_ge[i] & 0xffffu) << 44 |
                       (unsigned long long)unsigned(s_k1[i]) << 13 |
                       unsigned(i)
                 : 0ull;
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    const int i = threadIdx.x + x * C_THREADS;
    if (i < n) s_key[i] = w[x];
  }
  __syncthreads();
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  for (int lk = 1; lk <= lg; ++lk) {
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      for (int p = threadIdx.x; p < (1 << (lg - 1)); p += C_THREADS) {
        const int i = (p >> lj << (lj + 1)) | (p & (j - 1));
        const int l = lj == lk - 1 ? i ^ ((2 << lj) - 1) : i + j;
        if (l < n) {
          const unsigned long long ki = s_key[i], kl = s_key[l];
          if (kl < ki) {
            s_key[i] = kl;
            s_key[l] = ki;
          }
        }
      }
      __syncthreads();
    }
  }
  // the sorted words back to s_k1, s_ts and s_ge: the groups are where
  // they were
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    const int q = threadIdx.x + x * C_THREADS;
    if (q < n) w[x] = s_key[q];
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    const int q = threadIdx.x + x * C_THREADS;
    if (q >= n) break;
    s_k1[q] = int(w[x] >> 13 & 0x7fffffffu);
    s_ts[q] = tpos(int(w[x] & 0x1fffu));
    s_ge[q] = unsigned(w[x] >> 44);
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    const int q = threadIdx.x + x * C_THREADS;
    if (q >= n) break;
    const unsigned g0 = unsigned(w[x] >> 44);
    if (q + 1 == n || (s_ge[q + 1] & 0xffffu) != g0)
      atomicOr(s_ge + g0, unsigned(q + 1) << 16);
  }
  __syncthreads();
}

// Over n sorted rows (sort_groups' s_k1 and s_ge), a thread's IT
// consecutive rows from q0: bit x of *fb, the row starts a rank (its key
// 1 differs from the row before's, or it starts its group), of *ub, it is
// unresolved (not a rank start followed by one; a group's end is one).
template <int IT>
__device__ __forceinline__ void rank_starts(int n, const int* s_k1,
                                            const unsigned* s_ge,
                                            unsigned* fb, unsigned* ub) {
  const int q0 = threadIdx.x * IT;
  unsigned f = 0, u = 0;
#pragma unroll
  for (int x = 0; x < IT; ++x) {
    const int q = q0 + x;
    if (q >= n) break;
    const int g0 = int(s_ge[q] & 0xffffu);
    const int g1 = int(s_ge[g0] >> 16);
    const bool s = q == g0 || s_k1[q] != s_k1[q - 1];
    const bool e = q + 1 == g1 || s_k1[q + 1] != s_k1[q];
    f |= unsigned(s) << x;
    u |= unsigned(!(s && e)) << x;
  }
  *fb = f;
  *ub = u;
}

// A compacted round's rank step with no full-width sort. Block t (its
// tile from the ticket) holds the groups whose first row falls in its
// tile's rows [t * C_TILE, (t + 1) * C_TILE) of the slice (tile_groups:
// from the first group start in the tile to the first one at or after
// its end), every one at most C_CAP rows; a larger group is the large
// path's. It reads key 1 and the text positions in slice order
// (coalesced; key 1 is rank[t + h] + 1 as slice_keys_kernel left it
// after the round before), sorts each group stably by key 1 in shared
// memory (sort_groups), and with G and F the last group and rank start
// rows at or before a sorted row r writes rank[t] = key 0 + (F - G) where
// F != G, sa[key 0 + (r - G)] = t for the rows now resolved, and the
// unresolved rows to the next slice. One look-back of the tiles' counts
// places them in sorted order, as the large groups' rows of the next
// slice (the large path's, already sorted: the tiles their groups span
// copy them). The last tile writes the count and the fault word.
//
// What bounds it: bytes, 12 a row read (the slice) and 8 a row of the
// next slice written, 4 a changed rank and a resolved row's place; but
// the ranks land at random text positions (a 32-byte sector moved each
// way for 4 bytes), the largest part of the step on the H100 at 500
// Mchars. The block stores its ranks and places first, striped over its
// lanes (neighbouring sorted rows: the places coalesce), so that they
// drain while it waits on the look-back; then the next slice's rows.
__global__ void __launch_bounds__(C_THREADS, 2)
    comp_round_kernel(const CompArgs a) {
  extern __shared__ int smem[];
  int* s_k0 = smem;                 // the tile's key 0, key 1, positions
  int* s_t1 = s_k0 + C_TILE;
  int* s_tt = s_t1 + C_TILE;
  int* s_k1 = s_tt + C_TILE;        // the held rows' key 1, then sorted
  int* s_ts = s_k1 + C_ROWS;        // the sorted rows' text positions
  unsigned* s_ge = reinterpret_cast<unsigned*>(s_ts + C_ROWS);
  __shared__ int sagg[33];
  __shared__ StartCount fagg[33];
  __shared__ int s_prev;
  __shared__ TileGroups g;
  const int t = take_ticket(a.ticket);
  const int lo = t * C_TILE, hi = min(a.u, lo + C_TILE);
  // the tile's rows at once: the held rows lie in [lo, hi) but for the
  // last group's few rows past it
  for (int r = lo + threadIdx.x; r < hi; r += C_THREADS) {
    s_k0[r - lo] = __ldg(a.k0 + r);
    s_t1[r - lo] = __ldg(a.k1 + r);
    s_tt[r - lo] = __ldg(a.ti + r);
  }
  if (threadIdx.x == 0) s_prev = lo ? __ldg(a.k0 + lo - 1) : 0;
  __syncthreads();
  tile_groups(a, lo, hi, s_k0, s_prev, true, &g);
  // the held rows [s, e)
  const int s = g.first_in;
  const int n = s < hi ? (g.large1 ? g.last_in : g.b1) - s : 0;
  const int v1 = g.v1;
  auto key0 = [&](int i) {
    return s + i < hi ? s_k0[s + i - lo] : v1;
  };
  for (int i = threadIdx.x; i < n; i += C_THREADS)
    s_k1[i] = s + i < hi ? s_t1[s + i - lo] : __ldg(a.k1 + s + i);
  __syncthreads();
  sort_groups<C_ITEMS>(
      n, [&](int i) { return i == 0 || key0(i) != key0(i - 1); },
      [&](int i) {
        return s + i < hi ? s_tt[s + i - lo] : __ldg(a.ti + s + i);
      },
      s_k1, s_ts, s_ge, reinterpret_cast<unsigned long long*>(s_ts), sagg);
  unsigned fb, ub;
  rank_starts<C_ITEMS>(n, s_k1, s_ge, &fb, &ub);
  const int q0 = threadIdx.x * C_ITEMS;
  StartCount own;
  const StartCount ex = block_scan<false, StartCountOp>(
      StartCount{top_row(q0, fb), __popc(ub)}, StartCountOp::identity(), fagg,
      &own);
  // the held groups' rows: each row's new rank (over its key 1) and what
  // it writes (over its s_ge word, which only its own thread reads now):
  // its place, or bit 31 and its row in the tile's part of the next
  // slice; bit 30: its rank changed
  int F = ex.f, c = ex.cnt;
#pragma unroll
  for (int x = 0; x < C_ITEMS; ++x) {
    const int q = q0 + x;
    if (q >= n) break;
    const int g0 = int(s_ge[q] & 0xffffu);
    if (fb >> x & 1u) F = q;
    const int k = key0(q);
    // int32 arithmetic wraps, as torch's does
    s_k1[q] = int(unsigned(k) + unsigned(F - g0));
    unsigned o = F != g0 ? 1u << 30 : 0u;
    if (ub >> x & 1u) {
      o |= 1u << 31 | unsigned(c++);
    } else {
      const unsigned place = unsigned(k) + unsigned(q - g0);
      o |= place < unsigned(a.m) ? place : NO_PLACE;
    }
    s_ge[q] = o;
  }
  __syncthreads();
  // written by neighbouring lanes for neighbouring sorted rows: the
  // places and the next slice's rows coalesce; the ranks land at random.
  // The ranks and places first: they need no prefix, so their stores
  // drain while the tile waits on its look-back.
  for (int q = threadIdx.x; q < n; q += C_THREADS) {
    const unsigned o = s_ge[q];
    const int tq = s_ts[q];
    if ((o >> 30 & 1u) && unsigned(tq) < unsigned(a.m)) a.rank[tq] = s_k1[q];
    if (!(o >> 31) && (o & NO_PLACE) != NO_PLACE) a.sa[o & NO_PLACE] = tq;
  }
  const CountFault agg{g.n0 + own.cnt + g.n1, g.fault};
  const CountFault pre = lookback<CountFaultOp>(a.slots, t, agg);
  if (t == int(gridDim.x) - 1 && threadIdx.x == 0) {
    a.top[0] = pre.cnt + agg.cnt;
    a.top[1] = *a.fault | pre.fault | agg.fault;
    a.top[3] = 1;
  }
  const int base = pre.cnt + g.n0;
  for (int q = threadIdx.x; q < n; q += C_THREADS) {
    const unsigned o = s_ge[q];
    const int d = base + int(o & 0xffffu);
    if ((o >> 31) && d < a.cap) {
      a.ti_n[d] = s_ts[q];
      a.k0_n[d] = s_k1[q];
    }
  }
  // the large groups' rows that fall to this tile, before and after
  const int d0 = pre.cnt, d1 = pre.cnt + g.n0 + own.cnt;
  for (int i = threadIdx.x; i < g.n0 + g.n1; i += C_THREADS) {
    const int j = i < g.n0 ? g.s0 + i : g.s1 + (i - g.n0);
    const int d = i < g.n0 ? d0 + i : d1 + (i - g.n0);
    if (d < a.cap) {
      a.ti_n[d] = __ldg(a.l_ti + j);
      a.k0_n[d] = __ldg(a.l_k0 + j);
    }
  }
}

// Every round from a slice of u <= C_CAP rows until none is left (or
// ``rounds`` have run), in one block: the slice stays in shared memory;
// a round gathers its key 1, rank[t + h] + 1 (0 past m; the ranks the
// round before wrote: plain loads after the barrier), sorts each group in
// shared memory, writes the ranks and places as comp_round_kernel does,
// keeps its unresolved rows in sorted order as the next round's slice and
// waits at a barrier before that round reads the ranks. Writes the count
// left (0 once converged), the fault word's copy and the rounds run; a
// slice left when the rounds run out goes to ti_n, k0_n.
__global__ void __launch_bounds__(C_THREADS, 1)
    comp_tail_kernel(const CompArgs a) {
  extern __shared__ int smem[];
  int* s_ti = smem;                 // the slice: text positions, key 0
  int* s_k0 = s_ti + C_CAP;
  int* s_k1 = s_k0 + C_CAP;         // a round's key 1, then sorted
  int* s_ts = s_k1 + C_CAP;         // the sorted rows' text positions
  unsigned* s_ge = reinterpret_cast<unsigned*>(s_ts + C_CAP);
  __shared__ int sagg[33];
  __shared__ StartCount fagg[33];
  int u = a.u;
  for (int i = threadIdx.x; i < u; i += C_THREADS) {
    s_ti[i] = __ldg(a.ti + i);
    s_k0[i] = __ldg(a.k0 + i);
  }
  long long h = a.h;
  int rounds = 0;
  const int q0 = threadIdx.x * T_ITEMS;
  while (u > 0 && rounds < a.rounds) {
    for (int i = threadIdx.x; i < u; i += C_THREADS) {
      const long long at = (long long)s_ti[i] + h;
      s_k1[i] = (unsigned long long)at < (unsigned long long)a.m
                    ? a.rank[at] + 1
                    : 0;
    }
    __syncthreads();
    sort_groups<T_ITEMS>(
        u, [&](int i) { return i == 0 || s_k0[i] != s_k0[i - 1]; },
        [&](int i) { return s_ti[i]; }, s_k1, s_ts, s_ge,
        reinterpret_cast<unsigned long long*>(s_ts), sagg);
    unsigned fb, ub;
    rank_starts<T_ITEMS>(u, s_k1, s_ge, &fb, &ub);
    StartCount tot;
    const StartCount ex = block_scan<false, StartCountOp>(
        StartCount{top_row(q0, fb), __popc(ub)}, StartCountOp::identity(),
        fagg, &tot);
    int F = ex.f, c = ex.cnt;
    int keep_t[T_ITEMS], keep_r[T_ITEMS];
#pragma unroll
    for (int x = 0; x < T_ITEMS; ++x) {
      keep_t[x] = keep_r[x] = 0;
      const int q = q0 + x;
      if (q >= u) break;
      const int g0 = int(s_ge[q] & 0xffffu);
      if (fb >> x & 1u) F = q;
      const int tq = s_ts[q], k = s_k0[q];
      const int rank = int(unsigned(k) + unsigned(F - g0));
      if (F != g0 && unsigned(tq) < unsigned(a.m)) a.rank[tq] = rank;
      if (ub >> x & 1u) {
        keep_t[x] = tq;
        keep_r[x] = rank;
      } else {
        const int place = int(unsigned(k) + unsigned(q - g0));
        if (unsigned(place) < unsigned(a.m)) a.sa[place] = tq;
      }
    }
    __syncthreads();   // every read of the slice and every rank written
#pragma unroll
    for (int x = 0; x < T_ITEMS; ++x) {
      if (q0 + x >= u) break;
      if (ub >> x & 1u) {
        s_ti[c] = keep_t[x];
        s_k0[c] = keep_r[x];
        ++c;
      }
    }
    u = tot.cnt;
    ++rounds;
    h <<= 1;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.top[0] = u;
    a.top[1] = *a.fault;
    a.top[2] = 0;
    a.top[3] = rounds;
  }
  for (int i = threadIdx.x; i < min(u, a.cap); i += C_THREADS) {
    a.ti_n[i] = s_ti[i];
    a.k0_n[i] = s_k0[i];
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

long long comp_tiles(long long u) { return (u + C_TILE - 1) / C_TILE; }

// the compacted round's scratch: the byte offset of the tiles' states of
// comp_round_kernel (0), comp_pick_kernel (1), comp_large_kernel (2)
long long comp_slots_at(int which, long long u) {
  const long long states = 16 * comp_tiles(u);   // CountFault
  return 64 + which * states;
}

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
  a.large = reinterpret_cast<int*>(sc + 12);
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

// The compacted rounds' scratch (zeroed by the caller): the round's
// ticket (0), the four words the host reads (4: the next slice's rows,
// the fault word's copy, its rows in large groups, the rounds run), the
// pick's ticket (20), the large step's (24) and its count and fault copy
// (28), then the tiles' states of comp_round_kernel, comp_pick_kernel and
// comp_large_kernel.
long long dense_rank_comp_scratch_bytes(long long u) {
  return (comp_slots_at(2, u) + 24 * tiles_of(u) + 127) / 128 * 128;
}

// The compacted round's tile, and the largest group a block sorts by
// counting (for the checks at their edges).
int dense_rank_comp_tile() { return C_TILE; }
int dense_rank_comp_small() { return C_SMALL; }

// The large-group path's pick (run before its sort when large > 0): the
// rows of the slice (ti, k0, k1: u int32 each, key 0 nondecreasing) in
// groups larger than C_CAP, in slice order, into p_k0, p_k1, p_ti (large
// int32 each). A count other than ``large`` ORs COUNT_FAULT into fault.
int dense_rank_comp_pick_launch(const void* ti, const void* k0,
                                const void* k1, int u, int large, void* p_k0,
                                void* p_k1, void* p_ti, void* scratch,
                                void* fault, void* stream) {
  if (u < 1 || large < 1 || large > u || !p_k0 || !p_k1 || !p_ti)
    return int(cudaErrorInvalidValue);
  CompArgs a{};
  a.ti = static_cast<const int*>(ti);
  a.k0 = static_cast<const int*>(k0);
  a.k1 = static_cast<int*>(const_cast<void*>(k1));
  a.u = u;
  a.large = large;
  a.p_k0 = static_cast<int*>(p_k0);
  a.p_k1 = static_cast<int*>(p_k1);
  a.p_ti = static_cast<int*>(p_ti);
  char* sc = static_cast<char*>(scratch);
  a.ticket = reinterpret_cast<unsigned*>(sc + 20);
  a.fault = static_cast<int*>(fault);
  a.slots = reinterpret_cast<unsigned long long*>(sc + comp_slots_at(1, u));
  comp_pick_kernel<<<int(comp_tiles(u)), C_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// A compacted round's rank step: the slice (ti, k0, k1: u int32 each, key
// 0 nondecreasing, groups contiguous, key 1 the round's), rank and sa (m
// int32, written at the slice's positions and the resolved rows'
// places), the next slice into ti_n and k0_n (cap int32 each, not ti or
// k0; cap >= u), then its key 1 at shift h into k1 (h 0: not). With
// large > 0 rows in groups larger than C_CAP, first their step
// (comp_large_kernel) on the picked rows (p_k1, p_ti, large int32 each)
// in the order l_perm of their stable sort by (key 0, key 1), l_s0 the
// sorted key 0, into l_ti, l_k0, l_g (large int32 each). 1 <= u <= m <
// 2^30; the scratch as dense_rank_comp_scratch_bytes(u), zeroed (the
// pick's too); fault the sorts' fault word.
int dense_rank_comp_launch(const void* ti, const void* k0, void* k1,
                           void* rank, void* sa, int m, void* ti_n,
                           void* k0_n, int cap, int u, int large,
                           const void* l_perm, const void* l_s0,
                           const void* p_k1, const void* p_ti, void* l_ti,
                           void* l_k0, void* l_g, long long h, void* scratch,
                           void* fault, void* stream) {
  if (u < 1 || m < u || m >= (1 << 30) || cap < u || h < 0 || large < 0 ||
      large > u || ti_n == ti || k0_n == k0 || !ti_n || !k0_n ||
      (large && (!l_perm || !l_s0 || !p_k1 || !p_ti || !l_ti || !l_k0 ||
                 !l_g)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  cudaError_t err;
  if (large) {
    RankArgs r{};
    r.order = static_cast<const int*>(l_perm);
    r.s0 = static_cast<const int*>(l_s0);
    r.key1 = static_cast<const int*>(p_k1);
    r.ti = static_cast<const int*>(p_ti);
    r.rank = static_cast<int*>(rank);
    r.sa = static_cast<int*>(sa);
    r.ti_n = static_cast<int*>(l_ti);
    r.k0_n = static_cast<int*>(l_k0);
    r.g_n = static_cast<int*>(l_g);
    r.large = reinterpret_cast<int*>(sc + 12);
    r.cap = large;
    r.n = large;
    r.m = m;
    r.vec = aligned16(l_perm) && aligned16(l_s0);
    r.ticket = reinterpret_cast<unsigned*>(sc + 24);
    r.top = reinterpret_cast<int*>(sc + 28);
    r.fault = static_cast<const int*>(fault);
    r.slots = reinterpret_cast<unsigned long long*>(sc + comp_slots_at(2, u));
    comp_large_kernel<<<int(tiles_of(large)), THREADS, 0, s>>>(r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  CompArgs a{};
  a.ti = static_cast<const int*>(ti);
  a.k0 = static_cast<const int*>(k0);
  a.k1 = static_cast<int*>(k1);
  a.rank = static_cast<int*>(rank);
  a.sa = static_cast<int*>(sa);
  a.ti_n = static_cast<int*>(ti_n);
  a.k0_n = static_cast<int*>(k0_n);
  a.u = u;
  a.m = m;
  a.cap = cap;
  a.large = large;
  a.l_ti = static_cast<const int*>(l_ti);
  a.l_k0 = static_cast<const int*>(l_k0);
  a.l_g = static_cast<const int*>(l_g);
  a.l_count = reinterpret_cast<const int*>(sc + 28);
  a.ticket = reinterpret_cast<unsigned*>(sc);
  a.top = reinterpret_cast<int*>(sc + 4);
  a.fault = static_cast<int*>(fault);
  a.slots = reinterpret_cast<unsigned long long*>(sc + comp_slots_at(0, u));
  const int smem = 3 * (C_TILE + C_ROWS) * 4;
  err = cudaFuncSetAttribute(comp_round_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  comp_round_kernel<<<int(comp_tiles(u)), C_THREADS, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || h == 0) return int(err);
  const int blocks = int(min((cap + KEYS_THREADS - 1ll) / KEYS_THREADS,
                             4096ll));
  slice_keys_kernel<<<blocks, KEYS_THREADS, 0, s>>>(
      a.ti_n, a.rank, static_cast<int*>(k1), a.top, cap, m, h);
  return int(cudaGetLastError());
}

// The compacted rounds' tail: every round from the slice (ti, k0: u <=
// C_CAP int32 each, as dense_rank_comp_launch takes them; its key 1
// gathered here, round by round, at shifts h, 2h, ...) until none is
// left or ``rounds`` have run, in one block; rank and sa as there; a slice
// left then into ti_n, k0_n (cap int32 each). The scratch as
// dense_rank_comp_scratch_bytes(u), zeroed; its words at 4 as there.
int dense_rank_comp_tail_launch(const void* ti, const void* k0, void* rank,
                                void* sa, int m, void* ti_n, void* k0_n,
                                int cap, int u, long long h, int rounds,
                                void* scratch, void* fault, void* stream) {
  if (u < 1 || u > C_CAP || m < u || m >= (1 << 30) || h < 1 ||
      rounds < 1 || cap < 0 || (cap && (!ti_n || !k0_n)))
    return int(cudaErrorInvalidValue);
  CompArgs a{};
  a.ti = static_cast<const int*>(ti);
  a.k0 = static_cast<const int*>(k0);
  a.rank = static_cast<int*>(rank);
  a.sa = static_cast<int*>(sa);
  a.ti_n = static_cast<int*>(ti_n);
  a.k0_n = static_cast<int*>(k0_n);
  a.u = u;
  a.m = m;
  a.cap = cap;
  a.top = reinterpret_cast<int*>(static_cast<char*>(scratch) + 4);
  a.fault = static_cast<int*>(fault);
  a.h = h;
  a.rounds = rounds;
  const int smem = 5 * C_CAP * 4;
  cudaError_t err = cudaFuncSetAttribute(
      comp_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  comp_tail_kernel<<<1, C_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
