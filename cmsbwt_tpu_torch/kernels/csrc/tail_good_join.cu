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
// Design: one launch, the single-pass look-back scan of tile_scan.cuh
// over tiles of 4096 rows, 256 threads of 16 consecutive rows each (a
// launch bound of two blocks per SM caps the registers at 128), scanning
// BACKWARD with the state (first target row, its k1, its class; first
// run-end row) — "the later row in scan order wins". The ticket hands out
// tiles from the last to the first. A block loads its rows' k1, k2f, i
// and pay once into registers, folds them into its tile's state and
// publishes it. The state of every row after the tile is that of the
// first target and the first run end after it: the block reads a halo of
// the 64 rows after the tile beside its own rows, and when the halo holds
// both (targets are ~7% of the rows) or reaches the last row, the tile
// has its prefix without waiting on any other tile and publishes its
// inclusive state at once; else it looks back. A tile with a target and a
// run end also publishes its state as inclusive at once (it hides every
// row after it), so a look-back ends at its first tile. The block then
// scans its rows from the prefix and writes f_cls and ekey. The credit
// needs no per-row atomic: all good queries of one target lie
// contiguously before it (same bucket, smaller k2), so the block also
// runs a FORWARD segmented sum of the good rows' pay inside its tile
// (reset at each target) and credits each target of the tile once with
// the sum before it; the good rows after the tile's last target belong to
// the first target after the tile (the prefix names it), which the tile
// credits with one atomic. The exact count and pay sum take one atomic per
// block. A row's next row (for the run end) comes from the next lane by
// shuffle, across warps and tiles by a 4- and an 8-byte load.
//
// What bounds it on this card: bytes. The function reads 20 B per row and
// writes 8 (f_cls, ekey) plus the counter; this design reads each row
// once (single pass: 28 B per row moved), plus 64 halo rows, one state
// (its words packed with their flags) per tile and 12 B per warp of next
// rows. Its time beyond the
// bound is the tiles' fixed waits (ticket, loads, publishing), measured
// against variants by tools/lookback_variants.py.
//
// Plain C interface (bound with ctypes): tail_good_join_launch returns
// cudaGetLastError() after its launches; it launches on the given stream,
// allocates nothing (scratch of tail_good_join_scratch_bytes(J) bytes; the
// caller zeroes the scratch, counter and stats) and does not
// synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // 4096 rows
constexpr int NONE = INT_MAX;          // no such row
constexpr int HALO = 64;               // rows read after the tile

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
  // a tile with a target and a run end hides every row after it
  static __device__ __forceinline__ bool absorbs(const Fill& y) {
    return y.t_row != NONE && y.e_row != NONE;
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

// this thread's ITEMS rows r0 + j: k1, k2f, and the next row's (k1,
// k2f >> 1) for the last one
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

// row r0 + j's element of the backward scan (cls: its class)
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

__global__ void __launch_bounds__(THREADS, 2)
    tg_scan(const int* __restrict__ k1s, const long long* __restrict__ k2fs,
            const int* __restrict__ is, const int* __restrict__ pay_s, int J,
            int tiles, bool vec, unsigned* __restrict__ ticket,
            unsigned long long* __restrict__ slots, int* __restrict__ f_cls,
            int* __restrict__ ekey, int* __restrict__ counter,
            int counter_len, unsigned long long* __restrict__ stats) {
  __shared__ Fill wf[33];
  __shared__ Seg ws[33];
  __shared__ unsigned long long red[2][THREADS / 32];
  __shared__ int halo_t[HALO / 32][4], halo_e[HALO / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // backward: scan order's first tile is the last one
  const int t = take_ticket(ticket);
  const long long hi = (long long)(tiles - t) * TILE;  // the row after it
  const long long r0 = hi - TILE + (long long)threadIdx.x * ITEMS;
  // the halo: the first HALO rows after the tile, loaded with the tile
  const long long hr = hi + threadIdx.x;
  const bool in_halo = threadIdx.x < HALO && hr < J;
  int hk1 = 0, hk1n = 0, hcls = 0, hpay = 0;
  long long hk2 = 0, hk2n = 0;
  if (in_halo) {
    hk1 = __ldg(k1s + hr);
    hk2 = __ldg(k2fs + hr);
    hcls = __ldg(is + hr);
    hpay = __ldg(pay_s + hr);
    if (hr + 1 < J) {
      hk1n = __ldg(k1s + hr + 1);
      hk2n = __ldg(k2fs + hr + 1);
    }
  }
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
  // the halo's first target and first run end, per warp
  if (threadIdx.x < HALO) {
    const bool tgt = in_halo && (hk2 & 1) != 0;
    const bool end = in_halo && (hr + 1 >= J || hk1n != hk1
                                 || (hk2n >> 1) != (hk2 >> 1));
    const unsigned bt = __ballot_sync(FULL, tgt);
    const unsigned be = __ballot_sync(FULL, end);
    const int ft = bt ? __ffs(bt) - 1 : 0, fe = be ? __ffs(be) - 1 : 0;
    const int t_k1 = __shfl_sync(FULL, hk1, ft);
    const int t_cls = __shfl_sync(FULL, hcls, ft);
    const int t_pay = __shfl_sync(FULL, hpay, ft);
    if (lane == 0) {
      halo_t[warp][0] = bt ? int(hi) + warp * 32 + ft : NONE;
      halo_t[warp][1] = t_k1;
      halo_t[warp][2] = t_cls;
      halo_t[warp][3] = t_pay;
      halo_e[warp] = be ? int(hi) + warp * 32 + fe : NONE;
    }
  }
  Fill ftot;
  const Fill ex = block_scan<true, FillOp>(acc, FillOp::identity(), wf,
                                           &ftot);
  // the state of every row after the tile: its first target and first run
  // end. The halo holds both for nearly every tile (targets are ~7% of the
  // rows), or shows there are none before the last row; else the
  // look-back finds them.
  Fill pre = FillOp::identity();
  int pre_pay = 0;
#pragma unroll
  for (int k = 0; k < HALO / 32; ++k) {
    if (pre.t_row == NONE && halo_t[k][0] != NONE) {
      pre.t_row = halo_t[k][0];
      pre.t_k1 = halo_t[k][1];
      pre.t_cls = halo_t[k][2];
      pre_pay = halo_t[k][3];
    }
    if (pre.e_row == NONE) pre.e_row = halo_e[k];
  }
  const bool covers = hi + HALO >= J;
  const bool known = (pre.t_row != NONE || covers)
                     && (pre.e_row != NONE || covers);
  const Fill tile_carry = lookback<FillOp>(slots, t, ftot, known, pre);
  Fill st = FillOp::combine(tile_carry, ex);
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
  // the tile (named by the look-back's state) takes them
  if (threadIdx.x == 0 && stot.s != 0u && tile_carry.t_row != NONE) {
    const int p = known ? pre_pay : __ldg(pay_s + tile_carry.t_row);
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

// bytes of scratch for J rows (zeroed by the caller): the look-back's
// ticket and per-tile states
long long tail_good_join_scratch_bytes(int J) {
  return lookback_bytes(((long long)J + TILE - 1) / TILE, sizeof(Fill));
}

// k1s, is, pay_s: int32[J]; k2fs: int64[J]; f_cls, ekey: int32[J] out;
// counter: int32[counter_len], zeroed, credited; stats: uint64[2], zeroed
// (exact rows, their pay sum); scratch zeroed; 1 <= J < INT_MAX
int tail_good_join_launch(const int* k1s, const long long* k2fs,
                          const int* is, const int* pay_s, int J,
                          int* f_cls, int* ekey, int* counter,
                          int counter_len, unsigned long long* stats,
                          void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J < 1 || J == INT_MAX) return int(cudaErrorInvalidValue);
  const int tiles = (J + TILE - 1) / TILE;
  const bool vec = aligned16(k1s) && aligned16(k2fs) && aligned16(is)
                   && aligned16(pay_s) && aligned16(f_cls)
                   && aligned16(ekey);
  tg_scan<<<tiles, THREADS, 0, s>>>(k1s, k2fs, is, pay_s, J, tiles, vec,
                                    static_cast<unsigned*>(scratch),
                                    reinterpret_cast<unsigned long long*>(
                                        static_cast<char*>(scratch) + 16),
                                    f_cls, ekey, counter, counter_len,
                                    stats);
  return int(cudaGetLastError());
}

}  // extern "C"
