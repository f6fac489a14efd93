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
// device_merge.py) element for element, on outputs the caller zeroed.
// torch's accumulating index_put_ sorts its indices and sums each run of
// one index serially, and every pad lane goes to index 0. No atomic is
// needed: the valid lanes come sorted by bucket_rank (class_ranks_dev
// sorts the classes by it first), so each bucket is one contiguous
// segment of lanes, and each sum is a segmented sum that the segment's
// last lane stores with plain stores. A valid lane whose bucket_rank
// falls below its predecessor's breaks that order: the kernel sets bit 0
// of the fault word (bit 1 for a rank outside [0, n_pad), whose stores it
// skips), and the caller raises.
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
// single-pass look-back over tiles of 8 consecutive lanes per thread
// (bucket_sums: 256 threads, 2048 lanes; run_merge: 1024 threads, 8192): a block takes its tile from the ticket, loads
// its lanes once into registers, folds them, publishes the fold, takes
// the state of every lane before the tile from the look-back, and scans
// its lanes from it. bucket_sums' state is (m_c sum and lane count since
// the segment's start, whether a segment started): a tile where a segment
// starts publishes its inclusive state at once (it absorbs), and a
// segment's last lane stores its sums. run_merge's is (len since the group's start, whether a
// group started, groups ended so far): a group's last lane writes its sum
// at its index among the groups, and the last tile's inclusive count is
// n_runs. A lane's neighbours come from the neighbouring lanes by
// shuffle, across warps and tiles by 4-byte loads.
//
// What bounds them on this card: bytes. bucket_sums must read 8 B per
// lane (bucket_rank, m_c) and write its three outputs (8 B per reference
// row and 4 B per class, zeroed by the caller); it reads each valid lane
// once and bid at each segment's end. run_merge reads 12 B per lane and
// writes 5 B per group; it reads each lane once. Its tiles wait on their
// look-back (the group count adds up over every tile), and that wait,
// not the bytes, sets its time: larger tiles wait less per lane
// (tools/lookback_variants.py).
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
// bucket_sums: 256 threads, tiles of 2048 lanes; run_merge: 1024 threads,
// tiles of 8192 lanes (its group count has no absorbing state, so each
// tile waits on its look-back: larger tiles wait less per lane)
constexpr int BS_THREADS = 256;
constexpr int BS_TILE = BS_THREADS * ITEMS;
constexpr int RM_THREADS = 1024;
constexpr int RM_TILE = RM_THREADS * ITEMS;

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

__global__ void __launch_bounds__(BS_THREADS)
    bs_scan(const int* __restrict__ br_s, const int* __restrict__ bid_s,
            const int* __restrict__ mc_s, int nec, int tiles, bool vec,
            int h_pad, int n_pad, Lookback<Bkt> lb, int* __restrict__ hb_at,
            int* __restrict__ ncls_at, int* __restrict__ hb_b) {
  __shared__ Bkt wagg[33];
  const int lane = threadIdx.x & 31;
  const int t = take_ticket(lb.ticket);
  const long long r0 = (long long)t * BS_TILE
                       + (long long)threadIdx.x * ITEMS;
  int br[ITEMS], mc[ITEMS];
  load_items<ITEMS>(br_s, r0, nec, vec, 0, br);
  load_items<ITEMS>(mc_s, r0, nec, vec, 0, mc);
  // the lane before the thread's first and after its last
  int prv = __shfl_up_sync(FULL, br[ITEMS - 1], 1);
  int nxt = __shfl_down_sync(FULL, br[0], 1);
  if (lane == 0 && r0 > 0 && r0 - 1 < nec) prv = __ldg(br_s + r0 - 1);
  if (lane == 31 && r0 + ITEMS < nec) nxt = __ldg(br_s + r0 + ITEMS);
  Bkt el[ITEMS];
  int fault = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long r = r0 + j;
    const int p = j > 0 ? br[j - 1] : prv;
    const bool start = r == 0 || p != br[j];
    if (r < nec && r > 0 && br[j] < p) fault |= 1;
    el[j] = r < nec ? Bkt{unsigned(mc[j]), 1u, int(start)}
                    : BktOp::identity();
  }
  Bkt acc = BktOp::identity();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) acc = BktOp::combine(acc, el[j]);
  Bkt tot;
  const Bkt ex = block_scan<false, BktOp>(acc, BktOp::identity(), wagg,
                                          &tot);
  Bkt st = BktOp::combine(lookback<BktOp>(lb, t, tot), ex);
  const unsigned pad = unsigned(h_pad - max(nec, 0));
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long r = r0 + j;
    st = BktOp::combine(st, el[j]);
    const int n = j + 1 < ITEMS ? br[j + 1] : nxt;
    if (r < nec && (r + 1 == nec || n != br[j])) {
      // the segment's last lane
      const int b = br[j];
      if (b < 0 || b >= n_pad) {
        fault |= 2;
      } else {
        hb_at[b] = int(st.s);
        ncls_at[b] = int(st.c + (b == 0 ? pad : 0u));
        const int k = min(max(__ldg(bid_s + r), 0), h_pad - 1);
        hb_b[k] = int(st.s);
      }
    }
  }
  // no valid lane of rank 0 (with the lanes in order: the first lane's
  // rank is not 0): index 0 counts the pad lanes alone
  if (t == 0 && threadIdx.x == 0 && (nec <= 0 || br[0] != 0))
    ncls_at[0] = int(pad);
  if (fault) atomicOr(lb.head + 1, fault);
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
            Lookback<Grp> lb, int* __restrict__ out_len,
            unsigned char* __restrict__ out_chr) {
  __shared__ Grp wagg[33];
  const int t = take_ticket(lb.ticket);
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
  const Grp carry = lookback<GrpOp>(lb, t, tot);
  if (t == tiles - 1 && threadIdx.x == 0)
    lb.head[0] = GrpOp::combine(carry, tot).cnt;   // n_runs
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
  return lookback_bytes<Bkt>(((long long)max(nec, 1) + BS_TILE - 1)
                             / BS_TILE);
}

// byte offset in the scratch of the fault word (int32: bit 0, a valid
// lane's bucket_rank below its predecessor's; bit 1, one outside
// [0, n_pad))
long long bucket_sums_fault_offset() { return 8; }

// br_s, bid_s, mc_s: int32[h_pad] (the first nec lanes valid; m_c 0
// beyond); hb_at, ncls_at: int32[n_pad], hb_b: int32[h_pad], all zeroed;
// scratch zeroed; h_pad >= 1, n_pad >= 1, nec <= h_pad
int bucket_sums_launch(const int* br_s, const int* bid_s, const int* mc_s,
                       int nec, int h_pad, int n_pad, int* hb_at,
                       int* ncls_at, int* hb_b, void* scratch,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_pad < 1 || n_pad < 1 || nec > h_pad)
    return int(cudaErrorInvalidValue);
  const int tiles = (max(nec, 1) + BS_TILE - 1) / BS_TILE;
  const bool vec = aligned16(br_s) && aligned16(mc_s);
  bs_scan<<<tiles, BS_THREADS, 0, s>>>(br_s, bid_s, mc_s, nec, tiles, vec,
                                    h_pad, n_pad,
                                    lookback_at<Bkt>(scratch, tiles), hb_at,
                                    ncls_at, hb_b);
  return int(cudaGetLastError());
}

// bytes of scratch (zeroed by the caller) for L lanes
long long run_merge_scratch_bytes(int L) {
  return lookback_bytes<Grp>(((long long)L + RM_TILE - 1) / RM_TILE);
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
  rm_scan<<<tiles, RM_THREADS, 0, s>>>(k_s, len_s, chr_s, L, tiles, vec,
                                    lookback_at<Grp>(scratch, tiles),
                                    out_len, out_chr);
  return int(cudaGetLastError());
}

}  // extern "C"
