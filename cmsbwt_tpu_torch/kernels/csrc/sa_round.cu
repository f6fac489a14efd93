// sa_round — the rank step of one round of the joint suffix sort's prefix
// doubling, after that round's sort, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program that
// cmsbwt_tpu/ops/joint_sa.py runs after each round's lax.sort, a full
// round's (:244-266) and a compacted round's (:307-341), which the port
// ran as a dozen torch passes (change flags, running maxima, inversions).
// Equal to cmsbwt_tpu_torch/ops/joint_sa._round_ranks_reference element for
// element.
//
// Over R rows sorted by four int32 keys (perm[r]: the source row of sorted
// row r; key 0 the group, the rank or INT_MAX for a compacted round's dead
// rows; keys 1-3 the ranks + 1 at three shifts), per sorted row r:
//   g(r)     key 0 differs from row r-1's, or r == 0: a group starts;
//   mid(r)   keys 0-1 differ: a mid-level group starts;
//   full(r)  any key differs: a full-level group starts;
//   G, M, F  the last g, mid and full start row at or before r;
//   sing(r)  full(r) and full(r+1), true past the end: a singleton.
// A full round (R = m, perm[r] the text position t):
//   mid_rank[t] = M, full_rank[t] = F, resolved[t] = sing(r),
//   lv_out[r] = lv_in[r], or where that is 0: k+1 at a mid start, k+2 at
//   a full start.
// A compacted round (R = U; t = ti[perm[r]]; live: key 0 != INT_MAX):
//   rank_u = key 0 + (F - G) (and key 0 + (M - G) for the mid level); at
//   live rows mid_rank[t], full_rank[t] and resolved[t] are set, and
//   lv_out[key 0 + (M - G)] = k+1 at a mid start that is no group start,
//   lv_out[rank_u] = k+2 at a full start that is no mid start; the carried
//   slice: ti_s[r] = t, rank_u[r], keep[r] = live and not sing(r).
// Both count the rows that stay unresolved (live and not sing) into one
// word, which the caller reads once a round.
//
// What bounds it on this card: bytes. A full round reads perm, lv and the
// keys of each row and writes lv, the two rank rows and the flags: 37 B a
// row, 2.8 ms at m = 252 M. But the keys are read through perm and the
// ranks written through it, on random rows, and a random access moves a
// 32-byte sector for its 4 bytes unless L2 holds the sector: what the
// card takes is the count of those random sectors.
//
// Design: three launches, all from one C call: sa_round_pack, then
// sa_round_kernel, a single-pass scan with decoupled look-back
// (tile_scan.cuh's lookback) of (G, M, F) under max over tiles of 2048
// rows, 256 threads of 8 consecutive rows, then, for a full round,
// sa_round_unpack.
//  * Random sectors, two a row in a full round: sa_round_pack lays the
//    four key rows side by side, in order (K, 16 bytes a row: one gathered
//    sector, not four; a torch.stack of the rows, which writes at a
//    16-byte stride, took ~25 ms a full round at m = 252 M on the H100),
//    and the three
//    text-order results travel as one 64-bit word (M << 31 | F << 1 |
//    sing: ranks < 2^30, the JAX package's packed inversion payload),
//    scattered once; sa_round_unpack then splits the words into the
//    three rows, in order: two random sectors a row where four gathers
//    and three scatters would move seven. A compacted round writes its
//    live rows straight into copies of rank and resolved.
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
//  * A scatter position outside [0, m) is not written (the algorithm makes
//    none; the plain version raises on one).
//
// Plain C interface (bound with ctypes): sa_round_launch launches the
// kernels on the given stream and returns the first cudaGetLastError()
// that is not 0; it allocates nothing (the caller passes
// sa_round_scratch_bytes(R) bytes of zeroed scratch: the ticket, the count
// and the tiles' states; R x 16 bytes for K; a full round's m words; a
// compacted round's mid_rank, full_rank, resolved and lv_out as copies of
// rank, rank, resolved and lv) and does not synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;   // blocks an SM holds: caps the registers
constexpr int DEAD = INT_MAX;   // key 0 of a compacted round's dead rows

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

struct Keys {
  int k0, k1, k2, k3;
};

struct Args {
  const int* perm;
  const int4* K;        // the four keys of each source row
  const int* ti;        // compacted: the text position of each source row
  const int* lv_in;     // full: split levels, SA order
  int* lv_out;
  int* mid_rank;        // compacted: text order
  int* full_rank;
  unsigned char* resolved;
  long long* words;     // full: M << 31 | F << 1 | sing, text order
  int* ti_s;            // compacted: the carried slice, sorted order
  int* rank_u;
  unsigned char* keep;
  int R, m, k;
  bool vec;             // perm, lv and the slice are 16-byte aligned
  unsigned* ticket;
  int* count;
  unsigned long long* slots;
};

__device__ __forceinline__ Keys gather(const Args& a, int src) {
  const int4 w = __ldg(a.K + src);
  return Keys{w.x, w.y, w.z, w.w};
}

__device__ __forceinline__ bool differ(const Keys& x, const Keys& y) {
  return x.k0 != y.k0 || x.k1 != y.k1 || x.k2 != y.k2 || x.k3 != y.k3;
}

__device__ __forceinline__ Keys shfl_up_keys(const Keys& x) {
  return Keys{__shfl_up_sync(FULL, x.k0, 1), __shfl_up_sync(FULL, x.k1, 1),
              __shfl_up_sync(FULL, x.k2, 1), __shfl_up_sync(FULL, x.k3, 1)};
}

__device__ __forceinline__ int top_row(long long r0, unsigned bits) {
  return bits ? int(r0) + 31 - __clz(bits) : -1;
}

template <bool COMP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    sa_round_kernel(const Args a) {
  __shared__ Starts wagg[33];
  __shared__ Keys wlast[WARPS];   // each warp's last row's keys
  __shared__ int wfirst[WARPS];   // each warp's first row's full flag
  __shared__ int tile_count;
  if (threadIdx.x == 0) tile_count = 0;
  const int t = take_ticket(a.ticket);   // synchronises the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)t * TILE + (long long)threadIdx.x * ITEMS;
  // this thread's rows; a thread with rows follows threads with all theirs
  const int n = int(max(0ll, min((long long)ITEMS, a.R - r0)));
  int src[ITEMS];
  load_items<ITEMS>(a.perm, r0, a.R, a.vec, 0, src);
  Keys key[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    key[j] = j < n ? gather(a, src[j]) : Keys{0, 0, 0, 0};

  // the row before this thread's first row
  Keys prev = shfl_up_keys(key[ITEMS - 1]);
  if (lane == 31) wlast[warp] = key[ITEMS - 1];
  Keys before{0, 0, 0, 0};
  if (threadIdx.x == 0 && r0 > 0) before = gather(a, __ldg(a.perm + r0 - 1));
  __syncthreads();
  if (lane == 0) prev = warp ? wlast[warp - 1] : before;

  // bit j: row r0 + j starts a group, a mid group, a full group
  unsigned fg = 0, fm = 0, ff = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const Keys& c = key[j];
    const Keys& p = j ? key[j - 1] : prev;
    const bool top = j == 0 && r0 == 0;
    const bool dg = top || c.k0 != p.k0;
    const bool dm = dg || c.k1 != p.k1;
    const bool df = dm || c.k2 != p.k2 || c.k3 != p.k3;
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
    after = differ(gather(a, __ldg(a.perm + r0 + ITEMS)), key[ITEMS - 1]);

  const Starts agg{top_row(r0, fg), top_row(r0, fm), top_row(r0, ff)};
  Starts tot;
  const Starts ex = block_scan<false, StartsOp>(agg, StartsOp::identity(),
                                                wagg, &tot);
  Starts run = StartsOp::combine(lookback<StartsOp>(a.slots, t, tot), ex);
  if (lane == 31) next_full = warp + 1 < WARPS ? wfirst[warp + 1] : after;

  int lvv[ITEMS], tis[ITEMS], rku[ITEMS];
  if (!COMP) load_items<ITEMS>(a.lv_in, r0, a.R, a.vec, 0, lvv);
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
    if (COMP) {
      const int g0 = key[j].k0;
      const bool live = g0 != DEAD;
      // int32 arithmetic wraps, as torch's does
      const int mid = int(unsigned(g0) + unsigned(run.mid - run.g));
      const int full = int(unsigned(g0) + unsigned(run.full - run.g));
      const int at = __ldg(a.ti + src[j]);
      if (live) {
        if (unsigned(at) < unsigned(a.m)) {
          a.mid_rank[at] = mid;
          a.full_rank[at] = full;
          a.resolved[at] = sing;
        }
        if (dm && !dg && unsigned(mid) < unsigned(a.m))
          a.lv_out[mid] = a.k + 1;
        if (df && !dm && unsigned(full) < unsigned(a.m))
          a.lv_out[full] = a.k + 2;
      }
      tis[j] = at;
      rku[j] = full;
      a.keep[r] = live && !sing;
      unresolved += live && !sing;
    } else {
      const int at = src[j];
      if (unsigned(at) < unsigned(a.m))
        a.words[at] = (static_cast<long long>(run.mid) << 31) |
                      (static_cast<long long>(run.full) << 1) | sing;
      if (lvv[j] == 0) lvv[j] = dm ? a.k + 1 : (df ? a.k + 2 : 0);
      unresolved += !sing;
    }
  }
  if (COMP) {
    store_items<ITEMS>(a.ti_s, r0, a.R, a.vec, tis);
    store_items<ITEMS>(a.rank_u, r0, a.R, a.vec, rku);
  } else {
    store_items<ITEMS>(a.lv_out, r0, a.R, a.vec, lvv);
  }

  unresolved = __reduce_add_sync(FULL, unresolved);
  if (lane == 0 && unresolved) atomicAdd(&tile_count, unresolved);
  __syncthreads();
  if (threadIdx.x == 0 && tile_count) atomicAdd(a.count, tile_count);
}

// a full round's words, in text order, into its three rows: 4 rows a
// thread, 16-byte loads and stores where they are whole and aligned
constexpr int UNPACK_THREADS = 256;

__global__ void __launch_bounds__(UNPACK_THREADS)
    sa_round_unpack(const long long* __restrict__ words, int* __restrict__ mid,
                    int* __restrict__ full, unsigned char* __restrict__ res,
                    int m, bool vec) {
  const long long r0 = 4 * ((long long)blockIdx.x * UNPACK_THREADS +
                            threadIdx.x);
  if (r0 >= m) return;
  long long w[4];
  int mv[4], fv[4];
  unsigned char rv[4];
  const bool whole = vec && r0 + 4 <= m;
  if (whole) {
    ld16(words + r0, w);
    ld16(words + r0 + 2, w + 2);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!whole) w[j] = r0 + j < m ? __ldg(words + r0 + j) : 0;
    mv[j] = int(w[j] >> 31);
    fv[j] = int((w[j] >> 1) & ((1ll << 30) - 1));
    rv[j] = (unsigned char)(w[j] & 1);
  }
  if (whole) {
    st16(mid + r0, mv);
    st16(full + r0, fv);
    *reinterpret_cast<uchar4*>(res + r0) = make_uchar4(rv[0], rv[1], rv[2],
                                                       rv[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r0 + j < m) {
        mid[r0 + j] = mv[j];
        full[r0 + j] = fv[j];
        res[r0 + j] = rv[j];
      }
  }
}

// the four key rows side by side, 4 rows a thread: 16-byte loads of each
// row and 16-byte stores of K where they are whole and aligned
constexpr int PACK_THREADS = 256;

__global__ void __launch_bounds__(PACK_THREADS)
    sa_round_pack(const int* __restrict__ k0, const int* __restrict__ k1,
                  const int* __restrict__ k2, const int* __restrict__ k3,
                  int4* __restrict__ K, int R, bool vec) {
  const long long r0 = 4 * ((long long)blockIdx.x * PACK_THREADS +
                            threadIdx.x);
  if (r0 >= R) return;
  const int* rows[4] = {k0, k1, k2, k3};
  int v[4][4];
  const bool whole = vec && r0 + 4 <= R;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (whole) {
      ld16(rows[q] + r0, v[q]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[q][j] = r0 + j < R ? __ldg(rows[q] + r0 + j) : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (r0 + j < R) K[r0 + j] = make_int4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

long long tiles_of(long long R) { return (R + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// bytes of scratch (zeroed by the caller) for R rows: the ticket, the
// count, and three state words a tile
long long sa_round_scratch_bytes(long long R) {
  return lookback_bytes(tiles_of(R), int(sizeof(Starts)));
}

// the byte offset of the unresolved count (int32) in the scratch
long long sa_round_count_offset() { return 4; }

// comp: 0 for a full round (R == m < 2^30; ti, ti_s, rank_u, keep unused;
// words: m int64 of scratch), 1 for a compacted round (lv_in, words
// unused); perm, k0-k3, ti, ti_s, rank_u: R int32; K: R x 16 bytes of
// scratch, 16-byte aligned; keep: R bytes; lv_in, lv_out, mid_rank,
// full_rank: m int32; resolved: m bytes; 1 <= R <= m < 2^31 - 1; k: the
// round's level
int sa_round_launch(int comp, const void* perm, const void* k0,
                    const void* k1, const void* k2, const void* k3, void* K,
                    const void* ti, const void* lv_in, void* lv_out,
                    void* mid_rank, void* full_rank, void* resolved,
                    void* words, void* ti_s, void* rank_u, void* keep, int R,
                    int m, int k, void* scratch, void* stream) {
  if (R < 1 || m < R || (!comp && (R != m || m >= (1 << 30))) ||
      !aligned16(K))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long quads = (R + 3ll) / 4;
  sa_round_pack<<<int((quads + PACK_THREADS - 1) / PACK_THREADS),
                  PACK_THREADS, 0, s>>>(
      static_cast<const int*>(k0), static_cast<const int*>(k1),
      static_cast<const int*>(k2), static_cast<const int*>(k3),
      static_cast<int4*>(K), R,
      aligned16(k0) && aligned16(k1) && aligned16(k2) && aligned16(k3));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  Args a;
  a.perm = static_cast<const int*>(perm);
  a.K = static_cast<const int4*>(K);
  a.ti = static_cast<const int*>(ti);
  a.lv_in = static_cast<const int*>(lv_in);
  a.lv_out = static_cast<int*>(lv_out);
  a.mid_rank = static_cast<int*>(mid_rank);
  a.full_rank = static_cast<int*>(full_rank);
  a.resolved = static_cast<unsigned char*>(resolved);
  a.words = static_cast<long long*>(words);
  a.ti_s = static_cast<int*>(ti_s);
  a.rank_u = static_cast<int*>(rank_u);
  a.keep = static_cast<unsigned char*>(keep);
  a.R = R;
  a.m = m;
  a.k = k;
  a.vec = aligned16(perm) && (comp ? aligned16(ti_s) && aligned16(rank_u)
                                   : aligned16(lv_in) && aligned16(lv_out));
  a.ticket = static_cast<unsigned*>(scratch);
  a.count = reinterpret_cast<int*>(static_cast<char*>(scratch) + 4);
  a.slots = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + 16);
  const int tiles = int(tiles_of(R));
  if (comp) {
    sa_round_kernel<true><<<tiles, THREADS, 0, s>>>(a);
    return int(cudaGetLastError());
  }
  sa_round_kernel<false><<<tiles, THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const bool vec = aligned16(words) && aligned16(mid_rank) &&
                   aligned16(full_rank) &&
                   (reinterpret_cast<uintptr_t>(resolved) & 3) == 0;
  const long long mquads = (m + 3ll) / 4;
  sa_round_unpack<<<int((mquads + UNPACK_THREADS - 1) / UNPACK_THREADS),
                    UNPACK_THREADS, 0, s>>>(
      static_cast<const long long*>(words), static_cast<int*>(mid_rank),
      static_cast<int*>(full_rank), static_cast<unsigned char*>(resolved), m,
      vec);
  return int(cudaGetLastError());
}

}  // extern "C"
