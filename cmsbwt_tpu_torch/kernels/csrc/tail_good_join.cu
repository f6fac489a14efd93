// tail_good_join — the tail-positioning join's pass after its sort, fused,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program of
// tail_good_dev from the join's sort on
// (cmsbwt_tpu/engine/device_merge.py:426-488): two packed reverse cummins
// (the nearest at-or-after target's row, bucket pos and class), the
// reverse cummin of the (k1, k2) run ends, the exact / good tests, the
// good path's credit by cumsum differences at the target rows, and the
// exact rows' keys. Over J = h_pad + p_pad sorted rows (k1 int32, k2f
// int64 with the target flag in bit 0, i int32, pay int32), per row r:
//   T(r)    = the first row t >= r with k2f[t] & 1 (a target), else none;
//   e(r)    = the first row e >= r with e == J - 1 or (k1, k2f >> 1)
//             changing from e to e + 1;
//   in      = row r is a query and T(r) exists and k1[T(r)] == k1[r] <
//             INT_MAX;
//   exact   = in and T(r) <= e(r);  good = in and not exact;
//   f_cls[r] = i[T(r)], or INT_MAX with no target;
//   ekey[r]  = i[r] if exact, else INT_MAX;
//   counter[pay[t]] += sum of pay[r] over the good rows with T(r) = t
//                      (for 0 <= pay[t] < counter_len);
//   stats = (number of exact rows, sum of pay over them).
// Equal to _tail_good_join_reference
// (cmsbwt_tpu_torch/engine/device_merge.py) element for element.
//
// Design: the three launches of tile_scan.cuh over tiles of 2048 rows,
// 256 threads of 8 consecutive rows each, scanning BACKWARD with the
// state (first target row, its k1, its class; first run-end row) — "the
// later row in scan order wins". The reduce launch folds a tile into that
// state, the carry launch gives each tile the state of every row after
// it, and the emit launch scans its tile again from that carry and
// writes f_cls and ekey. The credit needs no per-row atomic: all good
// queries of one target lie contiguously before it (same bucket, smaller
// k2), so the emit launch also runs a FORWARD segmented sum of the good
// rows' pay inside its tile (reset at each target) and credits each
// target of the tile once with the sum before it; the good rows after the
// tile's last target belong to the first target after the tile (the
// carry's), which the tile credits with one atomic. The exact count and
// pay sum take one atomic per block. A row's next row (for the run end)
// comes from the next lane by shuffle, across warps and tiles by a 4- and
// an 8-byte load.
//
// What bounds it on this card: bytes. The function reads 20 B per row and
// writes 8 (f_cls, ekey) plus the counter; this design reads k1 and k2f
// twice (reduce and emit), 40 B per row in all.
//
// Plain C interface (bound with ctypes): tail_good_join_launch returns
// cudaGetLastError() after its launches; it launches on the given stream,
// allocates nothing (scratch of tail_good_join_scratch_bytes(J) bytes; the
// caller zeroes counter and stats) and does not synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // 2048 rows
constexpr int NONE = INT_MAX;          // no such row

// the nearest target at or after a row, and the nearest run end
struct Fill {
  int t_row, t_k1, t_cls;
  int e_row;
};
struct FillOp {
  static __device__ __forceinline__ Fill identity() {
    return Fill{NONE, 0, 0, NONE};
  }
  // y comes later in the backward scan (an earlier row): it wins
  static __device__ __forceinline__ Fill combine(const Fill& x,
                                                 const Fill& y) {
    const bool yt = y.t_row != NONE;
    return Fill{yt ? y.t_row : x.t_row, yt ? y.t_k1 : x.t_k1,
                yt ? y.t_cls : x.t_cls,
                y.e_row != NONE ? y.e_row : x.e_row};
  }
};

// the good rows' pay since the last target (mod 2^32, as the int32
// counter adds it)
struct Seg {
  unsigned s;
  int reset;
};
struct SegOp {
  static __device__ __forceinline__ Seg identity() { return Seg{0u, 0}; }
  static __device__ __forceinline__ Seg combine(const Seg& x, const Seg& y) {
    return Seg{y.reset ? y.s : x.s + y.s, x.reset | y.reset};
  }
};

// this thread's 8 rows r0 + j: k1, k2f, and the next row's (k1, k2f >> 1)
// for the last one
struct Rows {
  int k1[ITEMS];
  long long k2[ITEMS];
  int k1_next;
  long long k2_next;
};

__device__ __forceinline__ void load_rows(const int* __restrict__ k1s,
                                          const long long* __restrict__ k2fs,
                                          long long r0, int J, bool vec,
                                          Rows& w) {
  load_items<ITEMS>(k1s, r0, J, vec, INT_MAX, w.k1);
  load_items<ITEMS>(k2fs, r0, J, vec, 0LL, w.k2);
  const int lane = threadIdx.x & 31;
  w.k1_next = __shfl_down_sync(FULL, w.k1[0], 1);
  w.k2_next = __shfl_down_sync(FULL, w.k2[0], 1);
  if (lane == 31 && r0 + ITEMS < J) {
    w.k1_next = __ldg(k1s + r0 + ITEMS);
    w.k2_next = __ldg(k2fs + r0 + ITEMS);
  }
}

// row r0 + j's element of the backward scan (cls: its class, read only
// for a target)
__device__ __forceinline__ Fill element(const Rows& w, int j, long long r0,
                                        int J, int cls) {
  const long long r = r0 + j;
  if (r >= J) return FillOp::identity();
  const int k1n = j + 1 < ITEMS ? w.k1[j + 1] : w.k1_next;
  const long long k2n = j + 1 < ITEMS ? w.k2[j + 1] : w.k2_next;
  const bool change = r + 1 >= J || k1n != w.k1[j]
                      || (k2n >> 1) != (w.k2[j] >> 1);
  const bool target = (w.k2[j] & 1) != 0;
  return Fill{target ? int(r) : NONE, target ? w.k1[j] : 0,
              target ? cls : 0, change ? int(r) : NONE};
}

__global__ void __launch_bounds__(THREADS)
    tg_reduce(const int* __restrict__ k1s, const long long* __restrict__ k2fs,
              const int* __restrict__ is, int J, bool vec,
              Fill* __restrict__ agg) {
  __shared__ Fill wagg[33];
  const long long r0 = (long long)blockIdx.x * TILE
                       + (long long)threadIdx.x * ITEMS;
  Rows w;
  load_rows(k1s, k2fs, r0, J, vec, w);
  Fill acc = FillOp::identity();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int j = ITEMS - 1 - q;
    const bool target = r0 + j < J && (w.k2[j] & 1) != 0;
    acc = FillOp::combine(acc, element(w, j, r0, J,
                                       target ? __ldg(is + r0 + j) : 0));
  }
  Fill tot;
  block_scan<true, FillOp>(acc, FillOp::identity(), wagg, &tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(THREADS)
    tg_emit(const int* __restrict__ k1s, const long long* __restrict__ k2fs,
            const int* __restrict__ is, const int* __restrict__ pay_s, int J,
            bool vec, const Fill* __restrict__ carry, int* __restrict__ f_cls,
            int* __restrict__ ekey, int* __restrict__ counter,
            int counter_len, unsigned long long* __restrict__ stats) {
  __shared__ Fill wf[33];
  __shared__ Seg ws[33];
  __shared__ unsigned long long red[2][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * TILE
                       + (long long)threadIdx.x * ITEMS;
  Rows w;
  load_rows(k1s, k2fs, r0, J, vec, w);
  int cls[ITEMS], pay[ITEMS];
  load_items<ITEMS>(is, r0, J, vec, 0, cls);
  load_items<ITEMS>(pay_s, r0, J, vec, 0, pay);

  // backward: the nearest target and run end of every row
  Fill acc = FillOp::identity();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int j = ITEMS - 1 - q;
    acc = FillOp::combine(acc, element(w, j, r0, J, cls[j]));
  }
  const Fill tile_carry = carry[blockIdx.x];
  Fill ftot;
  Fill st = block_scan<true, FillOp>(acc, tile_carry, wf, &ftot);
  int fc[ITEMS], ek[ITEMS];
  unsigned good[ITEMS];
  bool target[ITEMS];
  unsigned long long n_exact = 0, members = 0;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int j = ITEMS - 1 - q;
    st = FillOp::combine(st, element(w, j, r0, J, cls[j]));
    const bool row = r0 + j < J;
    const bool has = st.t_row != NONE;
    const bool tgt = row && (w.k2[j] & 1) != 0;
    const bool in = row && !tgt && has && st.t_k1 == w.k1[j]
                    && w.k1[j] < INT_MAX;
    const bool exact = in && st.t_row <= st.e_row;
    fc[j] = has ? st.t_cls : INT_MAX;
    ek[j] = exact ? cls[j] : INT_MAX;
    good[j] = in && !exact ? unsigned(pay[j]) : 0u;
    target[j] = tgt;
    n_exact += exact;
    members += exact ? (unsigned long long)(long long)pay[j] : 0ull;
  }
  store_items<ITEMS>(f_cls, r0, J, vec, fc);
  store_items<ITEMS>(ekey, r0, J, vec, ek);

  // forward, inside the tile: each target's credit is the good pay since
  // the previous target
  Seg sacc = SegOp::identity();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    sacc = SegOp::combine(sacc, Seg{good[j], int(target[j])});
  Seg stot;
  Seg sx = block_scan<false, SegOp>(sacc, SegOp::identity(), ws, &stot);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (target[j] && sx.s != 0u && pay[j] >= 0 && pay[j] < counter_len)
      atomicAdd(counter + pay[j], int(sx.s));
    sx = SegOp::combine(sx, Seg{good[j], int(target[j])});
  }
  // the good rows after the tile's last target: the first target after
  // the tile (the tile's carry) takes them
  if (threadIdx.x == 0 && stot.s != 0u && tile_carry.t_row != NONE) {
    const int p = __ldg(pay_s + tile_carry.t_row);
    if (p >= 0 && p < counter_len) atomicAdd(counter + p, int(stot.s));
  }

  // the exact rows' count and pay sum: one atomic per block
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    n_exact += __shfl_down_sync(FULL, n_exact, d);
    members += __shfl_down_sync(FULL, members, d);
  }
  if (lane == 0) {
    red[0][warp] = n_exact;
    red[1][warp] = members;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) {
      a += red[0][k];
      b += red[1][k];
    }
    if (a) atomicAdd(stats, a);
    if (b) atomicAdd(stats + 1, b);
  }
}

}  // namespace

extern "C" {

// bytes of scratch for J rows: each tile's aggregate and carry, and the
// total
long long tail_good_join_scratch_bytes(int J) {
  const long long tiles = ((long long)J + TILE - 1) / TILE;
  return (2 * tiles + 1) * (long long)sizeof(Fill);
}

// k1s, is, pay_s: int32[J]; k2fs: int64[J]; f_cls, ekey: int32[J] out;
// counter: int32[counter_len], zeroed, credited; stats: uint64[2], zeroed
// (exact rows, their pay sum); 1 <= J < INT_MAX
int tail_good_join_launch(const int* k1s, const long long* k2fs,
                          const int* is, const int* pay_s, int J,
                          int* f_cls, int* ekey, int* counter,
                          int counter_len, unsigned long long* stats,
                          void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J < 1 || J == INT_MAX) return int(cudaErrorInvalidValue);
  const int tiles = (J + TILE - 1) / TILE;
  Fill* agg = static_cast<Fill*>(scratch);
  Fill* carry = agg + tiles;
  const bool vec = aligned16(k1s) && aligned16(k2fs) && aligned16(is)
                   && aligned16(pay_s) && aligned16(f_cls)
                   && aligned16(ekey);
  tg_reduce<<<tiles, THREADS, 0, s>>>(k1s, k2fs, is, J, vec, agg);
  carry_kernel<true, FillOp, Fill>
      <<<1, CARRY_THREADS, 0, s>>>(agg, carry, tiles);
  tg_emit<<<tiles, THREADS, 0, s>>>(k1s, k2fs, is, pay_s, J, vec, carry,
                                     f_cls, ekey, counter, counter_len,
                                     stats);
  return int(cudaGetLastError());
}

}  // extern "C"
