// run_merge — the run list's merge and compaction after the sort by
// offset, fused, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program at
// the end of runs_emit_dev (cmsbwt_tpu/engine/device_merge.py:694-716):
// the group flags from each lane's neighbours, the int64 cumsum, the
// packed (row << 32 | exc) cummax of the group starts, and the compaction
// of the groups' last lanes. Over L lanes sorted by offset (k int32, len
// int32, chr int32), a lane is valid when k < INT_MAX and len > 0; a
// group is a maximal stretch of consecutive valid lanes of one char. Per
// group, in lane order, it writes
//   out_len[g] = the sum of its lanes' len (int32),
//   out_chr[g] = its char (uint8),
// and n_runs = the number of groups. Equal to _run_merge_reference
// (cmsbwt_tpu_torch/engine/device_merge.py) element for element.
//
// Design: the three launches of tile_scan.cuh over tiles of 2048 lanes,
// 256 threads of 8 consecutive lanes each, scanning FORWARD with the
// state (len since the group's start, whether a group started, groups
// ended so far). The reduce launch folds a tile, the carry launch gives
// each tile the state of every lane before it (carry[tiles] holds n_runs),
// and the emit launch scans its tile again from its carry: a group's
// last lane writes its sum at its index among the groups. A lane's
// neighbours come from the neighbouring lanes by shuffle, across warps
// and tiles by 4-byte loads.
//
// What bounds it on this card: bytes. The function reads 12 B per lane
// and writes 5 B per group; this design reads the lanes twice.
//
// Plain C interface (bound with ctypes): run_merge_launch returns
// cudaGetLastError() after its launches; it launches on the given stream,
// allocates nothing (scratch of run_merge_scratch_bytes(L) bytes; the
// groups' count is the int32 at run_merge_count_offset(L) in it) and does
// not synchronise.

#include <cstddef>

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // 2048 lanes

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

__device__ __forceinline__ Grp fold(const Lanes& w, long long r0, int L) {
  Grp acc = GrpOp::identity();
  bool last;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    acc = GrpOp::combine(acc, element(w, j, r0, L, &last));
  return acc;
}

__global__ void __launch_bounds__(THREADS)
    rm_reduce(const int* __restrict__ k_s, const int* __restrict__ len_s,
              const int* __restrict__ chr_s, int L, bool vec,
              Grp* __restrict__ agg) {
  __shared__ Grp wagg[33];
  const long long r0 = (long long)blockIdx.x * TILE
                       + (long long)threadIdx.x * ITEMS;
  Lanes w;
  load_lanes(k_s, len_s, chr_s, r0, L, vec, w);
  Grp tot;
  block_scan<false, GrpOp>(fold(w, r0, L), GrpOp::identity(), wagg, &tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(THREADS)
    rm_emit(const int* __restrict__ k_s, const int* __restrict__ len_s,
            const int* __restrict__ chr_s, int L, bool vec,
            const Grp* __restrict__ carry, int* __restrict__ out_len,
            unsigned char* __restrict__ out_chr) {
  __shared__ Grp wagg[33];
  const long long r0 = (long long)blockIdx.x * TILE
                       + (long long)threadIdx.x * ITEMS;
  Lanes w;
  load_lanes(k_s, len_s, chr_s, r0, L, vec, w);
  Grp tot;
  Grp st = block_scan<false, GrpOp>(fold(w, r0, L), carry[blockIdx.x],
                                    wagg, &tot);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    bool last;
    st = GrpOp::combine(st, element(w, j, r0, L, &last));
    if (last) {
      out_len[st.cnt - 1] = int(st.s);
      out_chr[st.cnt - 1] = (unsigned char)w.chr[j];
    }
  }
}

}  // namespace

extern "C" {

// bytes of scratch for L lanes: each tile's aggregate and carry, and the
// total
long long run_merge_scratch_bytes(int L) {
  const long long tiles = ((long long)L + TILE - 1) / TILE;
  return (2 * tiles + 1) * (long long)sizeof(Grp);
}

// byte offset in the scratch of the groups' count (int32)
long long run_merge_count_offset(int L) {
  const long long tiles = ((long long)L + TILE - 1) / TILE;
  return 2 * tiles * (long long)sizeof(Grp) + offsetof(Grp, cnt);
}

// k_s, len_s, chr_s: int32[L]; out_len: int32[L], out_chr: uint8[L] (the
// first n_runs written); 1 <= L < INT_MAX
int run_merge_launch(const int* k_s, const int* len_s, const int* chr_s,
                     int L, int* out_len, unsigned char* out_chr,
                     void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || L == INT_MAX) return int(cudaErrorInvalidValue);
  const int tiles = (L + TILE - 1) / TILE;
  Grp* agg = static_cast<Grp*>(scratch);
  Grp* carry = agg + tiles;
  const bool vec = aligned16(k_s) && aligned16(len_s) && aligned16(chr_s);
  rm_reduce<<<tiles, THREADS, 0, s>>>(k_s, len_s, chr_s, L, vec, agg);
  carry_kernel<false, GrpOp, Grp>
      <<<1, CARRY_THREADS, 0, s>>>(agg, carry, tiles);
  rm_emit<<<tiles, THREADS, 0, s>>>(k_s, len_s, chr_s, L, vec, carry,
                                     out_len, out_chr);
  return int(cudaGetLastError());
}

}  // extern "C"
