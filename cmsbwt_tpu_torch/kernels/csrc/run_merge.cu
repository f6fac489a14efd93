// run_merge — runs_emit's run kernel for Hopper (sm_90a): the bucket
// sums that set the lanes' offsets (bucket_sums) and the run list's merge
// and compaction after the sort by offset (run_merge). Two entry points,
// one single-pass look-back scan each (tile_scan.cuh).
//
// Replaces no Pallas kernel: it is the counterpart of two XLA programs of
// runs_emit_dev (cmsbwt_tpu/engine/device_merge.py):
//
// bucket_sums — the three accumulating scatters (:596-599, :668-670).
// Over the h_pad class lanes in SA-walk order (bucket_rank int32, bid
// int32, m_c int32; the first nec valid, m_c 0 beyond), with
// br0 = bucket_rank on a valid lane and 0 on a pad lane:
//   hb_at[br0]   += m_c      (int32[n_pad], every lane)
//   ncls_at[br0] += 1        (int32[n_pad], every lane: index 0 also
//                             counts the h_pad - nec pad lanes)
//   hb_b[bid]    += m_c      (int32[h_pad], valid lanes, bid clamped)
// Equal to _bucket_sums_reference (cmsbwt_tpu_torch/engine/
// device_merge.py) element for element; it writes every slot of its
// outputs once, zeros included, so nothing need be zeroed first. torch's
// accumulating index_put_ sorts its indices and sums each run of one
// index serially, and every pad lane goes to index 0. No atomic is
// needed: the valid lanes come sorted by bucket_rank (class_ranks_dev
// sorts the classes by it first), so each bucket is one contiguous
// segment of lanes, bid is its index (bucket_lanes: the cumsum of the
// starts), and each sum is a segmented sum. A valid lane whose
// bucket_rank falls below its predecessor's breaks that order: the
// kernel sets bit 0 of the fault word (bit 1 for a rank outside [0,
// n_pad), whose stores it skips; bit 2 for a valid lane whose bid is not
// the count of segment starts up to it less one), keeps every store
// inside its outputs, and the caller raises. Bit 2 is the price of
// writing every slot once: hb_b's slot of a bucket is its index among the
// segments, so a bid that does not count them cannot be honoured.
//
// run_merge — the end of runs_emit_dev (:694-716): the group flags from
// each lane's neighbours, the int64 cumsum, the packed (row << 32 | exc)
// cummax of the group starts, and the compaction of the groups' last
// lanes. Over L lanes sorted by offset (k int32, len int32, chr int32), a
// lane is valid when k < INT_MAX and len > 0; a group is a maximal
// stretch of consecutive valid lanes of one char. Per group, in lane
// order, it writes
//   out_len[g] = the sum of its lanes' len (int32),
//   out_chr[g] = its char (uint8),
// and n_runs = the number of groups. Equal to _run_merge_reference
// element for element.
//
// Design: one launch each, scanning FORWARD with tile_scan.cuh's
// single-pass look-back: a block takes its tile from the ticket, loads its
// lanes once, folds them, publishes the fold, takes the state of every
// lane before the tile from the look-back, and scans its lanes from it.
//
// bucket_sums: 256 threads of 16 consecutive lanes (4096-lane tiles); its
// state is (m_c sum and lane count since the segment's start, whether a
// segment started): a tile where a segment starts publishes its inclusive
// state at once (it absorbs), and a tile whose 32 lanes before it hold a
// segment start takes its prefix from them (the sums since that start)
// and does not look back. Each warp loads its part of bucket_rank, bid
// and m_c with coalesced 16-byte vectors (64 B a thread in flight per
// array) and hands its threads their consecutive lanes through a swizzled
// shared tile, as running_fill.cu does. The outputs are staged: a tile
// owns the ranks between its first lane's predecessor's and its last
// lane's (exclusive), and the buckets between theirs; every bucket of
// those ranks starts and ends in the tile, and every other rank there
// holds none. The tile zeroes up to BS_RANKS of those ranks in shared
// memory (the rest, past a long rank gap, in device memory), its
// segments' last lanes put their sums there (and their bucket sums, at
// their index in the tile's starts), and the block stores both
// coalesced. The two buckets a tile shares with its neighbours are stored
// by their last lanes directly, and every block zeroes a share of the
// ranks past the last lane's and of the buckets past the last one. Each
// valid lane's bid is checked against its
// predecessor's: bid(r) = bid(r - 1) + start(r), from bid(-1) = -1.
//
// run_merge: 1024 threads of 8 lanes (8192-lane tiles); its state is (len
// since the group's start, whether a group started, groups ended so far):
// a group's last lane writes its sum at its index among the groups, and
// the last tile's inclusive count is n_runs. A lane's neighbours come from
// the neighbouring lanes by shuffle, across warps and tiles by 4-byte
// loads.
//
// What bounds them on this card: bytes. bucket_sums must read 12 B per
// valid lane (bucket_rank, bid, m_c) and write its three outputs (8 B per
// reference row and 4 B per class); it reads each valid lane once.
// run_merge reads 12 B per lane and writes 5 B per group; it reads each
// lane once. Its tiles wait on their look-back (the group count adds up
// over every tile), and that wait, not the bytes, sets its time: larger
// tiles wait less per lane (tools/lookback_variants.py).
//
// Plain C interface (bound with ctypes): each *_launch returns
// cudaGetLastError() after its launch; it launches on the given stream,
// allocates nothing (scratch of *_scratch_bytes bytes, zeroed by the
// caller: run_merge's group count is the int32 at byte
// run_merge_count_offset() of it, bucket_sums' fault word the int32 at
// byte bucket_sums_fault_offset()) and does not synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int ITEMS = 8;
// run_merge: 1024 threads, tiles of 8192 lanes (its group count has no
// absorbing state, so each tile waits on its look-back: larger tiles wait
// less per lane)
constexpr int RM_THREADS = 1024;
constexpr int RM_TILE = RM_THREADS * ITEMS;
// bucket_sums: 256 threads of 16 lanes, tiles of 4096 lanes, 3 blocks an
// SM; a tile's outputs are staged in shared memory (dynamic: 48 KB) and
// stored coalesced: up to BS_RANKS of its ranks and all of its buckets
constexpr int BS_THREADS = 256;
constexpr int BS_ITEMS = 16;
constexpr int BS_TILE = BS_THREADS * BS_ITEMS;
constexpr int BS_NV = BS_ITEMS / 4;   // 16-byte vectors per thread per array
constexpr int BS_MIN_BLOCKS = 3;   // caps its registers at 85
constexpr int BS_RANKS = 4096;
constexpr int BS_GAP_SERIAL = 64;   // longer rank gaps past the stage go to
constexpr int BS_GAPS = 32;         // the block, up to BS_GAPS of them
constexpr int BS_SMEM = (2 * BS_RANKS + BS_TILE) * 4;
static_assert(BS_THREADS * BS_NV * 16 <= 2 * BS_RANKS * 4,
              "the lane transposes fit in the rank stage");

// ---------------------------------------------------------------------------
// bucket_sums
// ---------------------------------------------------------------------------

struct Bkt {
  unsigned s;  // m_c since the segment's start (mod 2^32, as int32 adds)
  unsigned c;  // lanes since the segment's start
  int reset;   // a segment started
};
struct BktOp {
  static __device__ __forceinline__ Bkt identity() { return Bkt{0u, 0u, 0}; }
  static __device__ __forceinline__ Bkt combine(const Bkt& x, const Bkt& y) {
    return Bkt{y.reset ? y.s : x.s + y.s, y.reset ? y.c : x.c + y.c,
               x.reset | y.reset};
  }
  // a tile where a segment starts hides every lane before it
  static __device__ __forceinline__ bool absorbs(const Bkt& y) {
    return y.reset != 0;
  }
};

// Bkt with the segments started (the tile's own scan: a segment's bucket
// index is the tile's first plus the starts before it in the tile)
struct BktN {
  Bkt b;
  int n;
};
struct BktNOp {
  static __device__ __forceinline__ BktN identity() {
    return BktN{BktOp::identity(), 0};
  }
  static __device__ __forceinline__ BktN combine(const BktN& x,
                                                 const BktN& y) {
    return BktN{BktOp::combine(x.b, y.b), x.n + y.n};
  }
};

// the warp's part of one int32 lane array, lane l taking vector i * 32 + l
// (rows at or past ``rows`` read as 0)
__device__ __forceinline__ void bs_load(const int* __restrict__ src,
                                        long long base, int q0, int rows,
                                        bool vec, int4* w) {
#pragma unroll
  for (int i = 0; i < BS_NV; ++i) {
    const long long vb = base + (long long)(q0 + i * 32) * 4;
    if (vec && vb + 4 <= rows) {
      w[i] = __ldg(reinterpret_cast<const int4*>(src + vb));
    } else {
      int e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = vb + j < rows ? __ldg(src + vb + j)
                                                       : 0;
      w[i] = make_int4(e[0], e[1], e[2], e[3]);
    }
  }
}

// this thread's BS_ITEMS consecutive lanes of the vectors a warp loaded
__device__ __forceinline__ void bs_transpose(int4* buf, int q0,
                                             const int4* w, int* v) {
#pragma unroll
  for (int i = 0; i < BS_NV; ++i) buf[swz<BS_NV>(q0 + i * 32)] = w[i];
  __syncwarp();
#pragma unroll
  for (int u = 0; u < BS_NV; ++u) {
    const int4 x = buf[swz<BS_NV>(threadIdx.x * BS_NV + u)];
    v[4 * u] = x.x; v[4 * u + 1] = x.y; v[4 * u + 2] = x.z;
    v[4 * u + 3] = x.w;
  }
  __syncwarp();   // buf is reused by the next array
}

// 4 (fault bit 2) unless each of the thread's valid lanes has the bid of
// the lane before it plus its start bit (``starts``; bid(-1) = -1): the
// vectors of bid a warp loaded, read back by thread as bs_transpose does,
// one vector at a time
__device__ __forceinline__ int bid_check(int4* buf, int q0, const int4* w,
                                         unsigned starts, int r0, int nv,
                                         const int* __restrict__ bid_s) {
#pragma unroll
  for (int i = 0; i < BS_NV; ++i) buf[swz<BS_NV>(q0 + i * 32)] = w[i];
  __syncwarp();
  int first = 0, prev = 0, bad = 0;
#pragma unroll
  for (int u = 0; u < BS_NV; ++u) {
    const int4 x = buf[swz<BS_NV>(threadIdx.x * BS_NV + u)];
    const int e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * u + k;
      if (j == 0)
        first = e[0];
      else if (r0 + j < nv && e[k] != prev + int((starts >> j) & 1u))
        bad = 4;
      prev = e[k];
    }
  }
  __syncwarp();   // buf is reused by the next array
  // the thread's first lane against the lane before it
  int before = __shfl_up_sync(FULL, prev, 1);
  if ((threadIdx.x & 31) == 0)
    before = r0 == 0 ? -1 : (r0 - 1 < nv ? __ldg(bid_s + r0 - 1) : 0);
  if (r0 < nv && first != before + int(starts & 1u)) bad = 4;
  return bad;
}

// a[lo, hi) = 0 by the block's threads, 16-byte stores where aligned
__device__ __forceinline__ void zero_span(int* __restrict__ a, long long lo,
                                          long long hi) {
  if (lo >= hi) return;
  const long long v0 = min((lo + 3) & ~3ll, hi), v1 = max(hi & ~3ll, v0);
  if (threadIdx.x < v0 - lo) a[lo + threadIdx.x] = 0;
  if (threadIdx.x < hi - v1) a[v1 + threadIdx.x] = 0;
  for (long long i = v0 + 4ll * threadIdx.x; i < v1; i += 4ll * blockDim.x)
    *reinterpret_cast<int4*>(a + i) = make_int4(0, 0, 0, 0);
}

// The block's share of the ranks past the last valid lane's, [r0, n_pad)
// (index 0 counts the pad lanes), and of the buckets past the last one,
// [b0, h_pad): a contiguous chunk of each per block (the outputs are
// 16-byte aligned).
__device__ __forceinline__ void tail_zeros(int* __restrict__ hb_at,
                                           int* __restrict__ ncls_at,
                                           int* __restrict__ hb_b,
                                           long long r0, long long b0,
                                           int n_pad, int h_pad, int pad) {
  r0 = max(r0, 0ll);
  const long long rc = (max(n_pad - r0, 0ll) + gridDim.x - 1) / gridDim.x;
  const long long bc = (max(h_pad - b0, 0ll) + gridDim.x - 1) / gridDim.x;
  const long long rlo = r0 + rc * blockIdx.x, blo = b0 + bc * blockIdx.x;
  const long long rhi = min(rlo + rc, (long long)n_pad);
  zero_span(hb_at, rlo, rhi);
  zero_span(ncls_at, max(rlo, 1ll), rhi);
  if (threadIdx.x == 0 && rlo == 0 && rhi > 0) ncls_at[0] = pad;
  zero_span(hb_b, blo, min(blo + bc, (long long)h_pad));
}

// ranks [lo, hi) hold no bucket (they are not 0: the tile that owns rank
// 0 stages it); threads k, k + step, ... of the range
__device__ __forceinline__ void zero_ranks(int* __restrict__ hb_at,
                                           int* __restrict__ ncls_at,
                                           int lo, int hi, int k, int step) {
  for (int i = lo + k; i < hi; i += step) {
    hb_at[i] = 0;
    ncls_at[i] = 0;
  }
}

// The lanes come in bucket order, so a tile [lo, hi) of lanes owns the
// ranks [A, B) = [rank(lo - 1) + 1, rank(hi - 1)) and the buckets
// (J0, J0 + S) = (bid(lo - 1), bid(lo - 1) + its S segment starts): every
// bucket of those ranks starts and ends in the tile, and every other rank
// there holds none. The tile stages them in shared memory, zeros and sums,
// and stores them coalesced. The two buckets it shares with its
// neighbours, of ranks rank(lo - 1) and rank(hi - 1), are stored by their
// last lanes directly; the ranks past the last lane's and the buckets past
// the last one are zeroed by every block, a share each.
__global__ void __launch_bounds__(BS_THREADS, BS_MIN_BLOCKS)
    bs_scan(const int* __restrict__ br_s, const int* __restrict__ bid_s,
            const int* __restrict__ mc_s, int nec, int lane_tiles, bool vec,
            int h_pad, int n_pad, unsigned* __restrict__ ticket,
            unsigned long long* __restrict__ slots, int* __restrict__ hb_at,
            int* __restrict__ ncls_at, int* __restrict__ hb_b) {
  extern __shared__ __align__(16) unsigned char bs_smem[];
  int4* buf = reinterpret_cast<int4*>(bs_smem);   // the lane transposes
  int* s_hb = reinterpret_cast<int*>(bs_smem);    // then the rank window
  int* s_nc = s_hb + BS_RANKS;
  int* s_b = s_nc + BS_RANKS;                     // and the tile's buckets
  __shared__ BktN wagg[33];
  __shared__ int2 gaps[BS_GAPS];
  __shared__ int n_gaps;
  __shared__ Bkt halo;
  __shared__ bool halo_known;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = max(nec, 0);
  const int pad = h_pad - nv;
  const int t = take_ticket(ticket);
  const bool lanes = t < lane_tiles;   // block-uniform
  // lanes are int32 indices: nec <= h_pad < 2^31
  const int lo = t * BS_TILE;
  const int q0 = warp * 32 * BS_NV + lane;
  // every block zeroes its share of the tails: the ranks past the last
  // valid lane's and the buckets past the last one (bid[nv - 1] + 1
  // buckets)
  tail_zeros(hb_at, ncls_at, hb_b,
             nv > 0 ? __ldg(br_s + nv - 1) + 1ll : 0ll,
             nv > 0 ? min(max(__ldg(bid_s + nv - 1), 0), h_pad - 1) + 1 : 0,
             n_pad, h_pad, pad);
  if (!lanes) return;
  int br[BS_ITEMS], mc[BS_ITEMS];
  int4 w[BS_NV];
  bs_load(br_s, lo, q0, nv, vec, w);
  bs_transpose(buf, q0, w, br);
  const int hi = min(lo + BS_TILE, nv);
  const int r0 = lo + threadIdx.x * BS_ITEMS;
  // the tile's ranks [A, B) and its first bucket J0 + 1 (clamped: a
  // stray rank or bid faults, and no store leaves the outputs)
  const int A = min(max(lo == 0 ? 0 : __ldg(br_s + lo - 1) + 1, 0), n_pad);
  const int B = min(max(__ldg(br_s + hi - 1), A), n_pad);
  const int J0 = min(max(lo == 0 ? -1 : __ldg(bid_s + lo - 1), -1),
                     h_pad - 1);
  // the lane before the thread's first and after its last; then the
  // lanes that start a segment and those that end one, as bit masks
  int prv = __shfl_up_sync(FULL, br[BS_ITEMS - 1], 1);
  int nxt = __shfl_down_sync(FULL, br[0], 1);
  if (lane == 0 && r0 > 0 && r0 - 1 < nv) prv = __ldg(br_s + r0 - 1);
  if (lane == 31 && r0 + BS_ITEMS < nv) nxt = __ldg(br_s + r0 + BS_ITEMS);
  int fault = 0;
  unsigned starts = 0u, ends = 0u;
#pragma unroll
  for (int j = 0; j < BS_ITEMS; ++j) {
    const int r = r0 + j;
    const int p = j > 0 ? br[j - 1] : prv;
    const int nx = j + 1 < BS_ITEMS ? br[j + 1] : nxt;
    if (r < nv) {
      if (r > 0 && br[j] < p) fault |= 1;
      starts |= unsigned(r == 0 || p != br[j]) << j;
      ends |= unsigned(r + 1 == nv || nx != br[j]) << j;
    }
  }
  bs_load(bid_s, lo, q0, nv, vec, w);
  fault |= bid_check(buf, q0, w, starts, r0, nv, bid_s);
  bs_load(mc_s, lo, q0, nv, vec, w);
  bs_transpose(buf, q0, w, mc);
  BktN acc = BktNOp::identity();
#pragma unroll
  for (int j = 0; j < BS_ITEMS; ++j) {
    const int start = (starts >> j) & 1u;
    if (r0 + j < nv)
      acc = BktNOp::combine(acc, BktN{Bkt{unsigned(mc[j]), 1u, start},
                                      start});
  }
  // the halo: the 32 lanes before the tile give its prefix — the sums
  // since the last segment start among them — unless none starts there
  if (warp == 0) {
    const int q = lo - 32 + lane;
    const int bq = q >= 0 ? __ldg(br_s + q) : 0;
    int bp = __shfl_up_sync(FULL, bq, 1);
    if (lane == 0 && q > 0) bp = __ldg(br_s + q - 1);
    const unsigned st = __ballot_sync(FULL, q >= 0 && (q == 0 || bp != bq));
    const int k = st ? 31 - __clz(st) : 32;   // the last start
    const unsigned m = lane >= k && q >= 0 ? unsigned(__ldg(mc_s + q)) : 0u;
    unsigned s_sum = m;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1)
      s_sum += __shfl_xor_sync(FULL, s_sum, d);
    if (lane == 0) {
      halo_known = lo > 0 && st != 0u;
      halo = Bkt{s_sum, unsigned(32 - k), 1};
    }
  }
  BktN tot;
  const BktN ex = block_scan<false, BktNOp>(acc, BktNOp::identity(), wagg,
                                            &tot);
  const Bkt st0 = BktOp::combine(
      lookback<BktOp>(slots, t, tot.b, halo_known, halo), ex.b);
  const int S = tot.n;
  // ranks [A, W) are staged; past them (a tile whose ranks span more
  // than BS_RANKS: long rank gaps) the sums are stored directly and each
  // segment's first lane zeroes the gap before its rank, a long gap by
  // the whole block
  const int W = min(B, A + BS_RANKS);
  for (int i = threadIdx.x; i < W - A; i += BS_THREADS) {
    s_hb[i] = 0;
    s_nc[i] = A + i == 0 ? pad : 0;
  }
  if (threadIdx.x == 0) n_gaps = 0;
  __syncthreads();
  Bkt st = st0;
  int n = ex.n;
#pragma unroll
  for (int j = 0; j < BS_ITEMS; ++j) {
    const bool start = (starts >> j) & 1u;
    if (r0 + j < hi)
      st = BktOp::combine(st, Bkt{unsigned(mc[j]), 1u, int(start)});
    n += start;
    if (start && W < B) {
      const int p = r0 + j == 0 ? -1 : j > 0 ? br[j - 1] : prv;
      const int g0 = max(p + 1, W);
      const int g1 = min(br[j], B);
      if (g1 - g0 > BS_GAP_SERIAL) {
        const int g = atomicAdd(&n_gaps, 1);
        if (g < BS_GAPS) gaps[g] = make_int2(g0, g1);
        else zero_ranks(hb_at, ncls_at, g0, g1, 0, 1);
      } else {
        zero_ranks(hb_at, ncls_at, g0, g1, 0, 1);
      }
    }
    if (!((ends >> j) & 1u)) continue;
    // the segment's last lane: its bucket is J0 + n
    const int b = br[j];
    const unsigned cnt = st.c + (b == 0 ? unsigned(pad) : 0u);
    if (b >= A && b < W) {
      s_hb[b - A] = int(st.s);
      s_nc[b - A] = int(cnt);
    } else if (b < 0 || b >= n_pad) {
      fault |= 2;
      continue;
    } else {
      hb_at[b] = int(st.s);
      ncls_at[b] = int(cnt);
    }
    if (b >= A && b < B && n >= 1 && n <= BS_TILE)
      s_b[n - 1] = int(st.s);
    else
      hb_b[min(max(J0 + n, 0), h_pad - 1)] = int(st.s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W - A; i += BS_THREADS) {
    hb_at[A + i] = s_hb[i];
    ncls_at[A + i] = s_nc[i];
  }
  for (int g = 0; g < min(n_gaps, BS_GAPS); ++g)
    zero_ranks(hb_at, ncls_at, gaps[g].x, gaps[g].y, threadIdx.x,
               BS_THREADS);
  // the buckets J0 + 1 .. J0 + S - 1 (J0 + S is the last lane's)
  const int nb = min(S - 1, h_pad - 1 - J0);
  for (int i = threadIdx.x; i < nb; i += BS_THREADS)
    hb_b[J0 + 1 + i] = s_b[i];
  if (fault) atomicOr(reinterpret_cast<int*>(ticket) + 2, fault);
}

// ---------------------------------------------------------------------------
// run_merge
// ---------------------------------------------------------------------------

struct Grp {
  long long s;  // len since the group's start
  int reset;    // a group started (or an invalid lane passed)
  int cnt;      // groups ended
};
struct GrpOp {
  static __device__ __forceinline__ Grp identity() { return Grp{0, 0, 0}; }
  static __device__ __forceinline__ Grp combine(const Grp& x, const Grp& y) {
    return Grp{y.reset ? y.s : x.s + y.s, x.reset | y.reset, x.cnt + y.cnt};
  }
  // the group count adds up over every tile: nothing is hidden
  static __device__ __forceinline__ bool absorbs(const Grp&) { return false; }
};

// this thread's 8 lanes r0 + j, with the lane before and the lane after
struct Lanes {
  int k[ITEMS], len[ITEMS], chr[ITEMS];
  bool prv_valid, nxt_valid;
  int prv_chr, nxt_chr;
};

__device__ __forceinline__ bool valid_lane(int k, int len) {
  return k < INT_MAX && len > 0;
}

__device__ __forceinline__ void load_lanes(const int* __restrict__ k_s,
                                           const int* __restrict__ len_s,
                                           const int* __restrict__ chr_s,
                                           long long r0, int L, bool vec,
                                           Lanes& w) {
  load_items<ITEMS>(k_s, r0, L, vec, INT_MAX, w.k);
  load_items<ITEMS>(len_s, r0, L, vec, 0, w.len);
  load_items<ITEMS>(chr_s, r0, L, vec, -1, w.chr);
  const int lane = threadIdx.x & 31;
  const bool first_ok = valid_lane(w.k[0], w.len[0]);
  const bool last_ok = valid_lane(w.k[ITEMS - 1], w.len[ITEMS - 1]);
  w.prv_valid = __shfl_up_sync(FULL, int(last_ok), 1) != 0;
  w.prv_chr = __shfl_up_sync(FULL, w.chr[ITEMS - 1], 1);
  w.nxt_valid = __shfl_down_sync(FULL, int(first_ok), 1) != 0;
  w.nxt_chr = __shfl_down_sync(FULL, w.chr[0], 1);
  if (lane == 0) {
    w.prv_valid = r0 > 0 && r0 - 1 < L
                  && valid_lane(__ldg(k_s + r0 - 1), __ldg(len_s + r0 - 1));
    w.prv_chr = w.prv_valid ? __ldg(chr_s + r0 - 1) : -1;
  }
  if (lane == 31) {
    w.nxt_valid = r0 + ITEMS < L
                  && valid_lane(__ldg(k_s + r0 + ITEMS),
                                __ldg(len_s + r0 + ITEMS));
    w.nxt_chr = w.nxt_valid ? __ldg(chr_s + r0 + ITEMS) : -1;
  }
}

// lane r0 + j's element; *last: it ends a group
__device__ __forceinline__ Grp element(const Lanes& w, int j, long long r0,
                                       int L, bool* last) {
  const bool ok = r0 + j < L && valid_lane(w.k[j], w.len[j]);
  // the neighbours inside the thread; rows past L read as invalid
  const bool pv = j > 0 ? valid_lane(w.k[j - 1], w.len[j - 1]) : w.prv_valid;
  const int pc = j > 0 ? w.chr[j - 1] : w.prv_chr;
  const bool nv = j + 1 < ITEMS ? r0 + j + 1 < L
                                      && valid_lane(w.k[j + 1], w.len[j + 1])
                                : w.nxt_valid;
  const int nc = j + 1 < ITEMS ? w.chr[j + 1] : w.nxt_chr;
  const bool first = ok && (!pv || pc != w.chr[j]);
  *last = ok && (!nv || nc != w.chr[j]);
  if (!ok) return Grp{0, 1, 0};
  return Grp{(long long)w.len[j], int(first), int(*last)};
}

__global__ void __launch_bounds__(RM_THREADS)
    rm_scan(const int* __restrict__ k_s, const int* __restrict__ len_s,
            const int* __restrict__ chr_s, int L, int tiles, bool vec,
            unsigned* __restrict__ ticket,
            unsigned long long* __restrict__ slots, int* __restrict__ out_len,
            unsigned char* __restrict__ out_chr) {
  __shared__ Grp wagg[33];
  const int t = take_ticket(ticket);
  const long long r0 = (long long)t * RM_TILE
                       + (long long)threadIdx.x * ITEMS;
  Lanes w;
  load_lanes(k_s, len_s, chr_s, r0, L, vec, w);
  Grp acc = GrpOp::identity();
  bool last;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    acc = GrpOp::combine(acc, element(w, j, r0, L, &last));
  Grp tot;
  const Grp ex = block_scan<false, GrpOp>(acc, GrpOp::identity(), wagg,
                                          &tot);
  const Grp carry = lookback<GrpOp>(slots, t, tot);
  if (t == tiles - 1 && threadIdx.x == 0)   // n_runs
    reinterpret_cast<int*>(ticket)[1] = GrpOp::combine(carry, tot).cnt;
  Grp st = GrpOp::combine(carry, ex);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    st = GrpOp::combine(st, element(w, j, r0, L, &last));
    if (last) {
      out_len[st.cnt - 1] = int(st.s);
      out_chr[st.cnt - 1] = (unsigned char)w.chr[j];
    }
  }
}

}  // namespace

extern "C" {

// bytes of scratch (zeroed by the caller) for nec valid lanes
long long bucket_sums_scratch_bytes(int nec) {
  return lookback_bytes(((long long)max(nec, 1) + BS_TILE - 1) / BS_TILE,
                        sizeof(Bkt));
}

// byte offset in the scratch of the fault word (int32: bit 0, a valid
// lane's bucket_rank below its predecessor's; bit 1, one outside
// [0, n_pad); bit 2, a valid lane whose bid is not the count of segment
// starts up to it less one)
long long bucket_sums_fault_offset() { return 8; }

// br_s, bid_s, mc_s: int32[h_pad] (the first nec lanes valid, their
// bucket_rank never falling and bid their bucket's index; m_c 0 beyond);
// hb_at, ncls_at: int32[n_pad], hb_b: int32[h_pad], every slot written
// (nothing need be zeroed), 16-byte aligned; scratch zeroed; 1 <= h_pad,
// n_pad <= INT_MAX - 8192, nec <= h_pad
int bucket_sums_launch(const int* br_s, const int* bid_s, const int* mc_s,
                       int nec, int h_pad, int n_pad, int* hb_at,
                       int* ncls_at, int* hb_b, void* scratch,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_pad < 1 || n_pad < 1 || nec > h_pad || h_pad > INT_MAX - BS_TILE
      || n_pad > INT_MAX - BS_TILE || !aligned16(hb_at)
      || !aligned16(ncls_at) || !aligned16(hb_b))
    return int(cudaErrorInvalidValue);
  const int lane_tiles = (max(nec, 0) + BS_TILE - 1) / BS_TILE;
  // the blocks past the lane tiles only zero their share of the tails
  const int blocks = max(lane_tiles,
                         (max(h_pad, n_pad) + BS_TILE - 1) / BS_TILE);
  const bool vec = aligned16(br_s) && aligned16(bid_s) && aligned16(mc_s);
  // the stage's 48 KB of dynamic shared memory
  const cudaError_t e = cudaFuncSetAttribute(
      bs_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, BS_SMEM);
  if (e != cudaSuccess) return int(e);
  bs_scan<<<blocks, BS_THREADS, BS_SMEM, s>>>(
      br_s, bid_s, mc_s, nec, lane_tiles, vec, h_pad, n_pad,
      static_cast<unsigned*>(scratch),
      reinterpret_cast<unsigned long long*>(static_cast<char*>(scratch)
                                            + 16),
      hb_at, ncls_at, hb_b);
  return int(cudaGetLastError());
}

// bytes of scratch (zeroed by the caller) for L lanes
long long run_merge_scratch_bytes(int L) {
  return lookback_bytes(((long long)L + RM_TILE - 1) / RM_TILE,
                        sizeof(Grp));
}

// byte offset in the scratch of the groups' count (int32)
long long run_merge_count_offset() { return 4; }

// k_s, len_s, chr_s: int32[L]; out_len: int32[L], out_chr: uint8[L] (the
// first n_runs written); scratch zeroed; 1 <= L < INT_MAX
int run_merge_launch(const int* k_s, const int* len_s, const int* chr_s,
                     int L, int* out_len, unsigned char* out_chr,
                     void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || L == INT_MAX) return int(cudaErrorInvalidValue);
  const int tiles = (L + RM_TILE - 1) / RM_TILE;
  const bool vec = aligned16(k_s) && aligned16(len_s) && aligned16(chr_s);
  rm_scan<<<tiles, RM_THREADS, 0, s>>>(
      k_s, len_s, chr_s, L, tiles, vec, static_cast<unsigned*>(scratch),
      reinterpret_cast<unsigned long long*>(static_cast<char*>(scratch)
                                            + 16),
      out_len, out_chr);
  return int(cudaGetLastError());
}

}  // extern "C"
