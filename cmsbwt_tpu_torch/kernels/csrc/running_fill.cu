// running_fill — the inclusive running max or min of a 1-D int32 or int64
// array, forward or reverse, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA scans
// jax.lax.cummax / jax.lax.cummin and of _rev_fill_min
// (cmsbwt_tpu/engine/device_merge.py:57-64), which the device merge runs
// as its fills (fixup_dev, class_ranks_dev, tail_exact_dev,
// runs_emit_dev), and of the row-blocked running max of the dense scan's
// _fill_ell and the sharded merge's local scans. torch runs a 1-D
// cummax / cummin in a single block.
//   forward: out[r] = op(v[0..r]);  reverse: out[r] = op(v[r..m-1]).
// Equal to running_fill_reference (cmsbwt_tpu_torch/ops/fill.py) element
// for element.
//
// Design: the three launches of tile_scan.cuh (reduce, carry, emit) over
// tiles of 4096 rows, 256 threads of 16 consecutive rows each. Reverse is
// the same scan run backward (tiles, warps, lanes and items from the
// last), so no flipped copy is made. A thread loads its 16 rows by 16-byte
// vectors when the arrays are 16-byte aligned (element loads otherwise)
// and writes its outputs from registers the same way.
//
// What bounds it on this card: bytes. The function needs 2 x the array's
// bytes (read once, written once: 16 B per int64 row); this design reads
// the array twice (reduce and emit), 1.5 x that, plus 2 states per tile.
//
// Plain C interface (bound with ctypes): running_fill_launch returns
// cudaGetLastError() after its launches; it launches on the given stream,
// allocates nothing (the caller passes running_fill_scratch_bytes(m,
// elem) bytes of scratch) and does not synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // 4096 rows

template <class T> struct Lim;
template <> struct Lim<int> {
  static constexpr int lo = INT_MIN, hi = INT_MAX;
};
template <> struct Lim<long long> {
  static constexpr long long lo = LLONG_MIN, hi = LLONG_MAX;
};

template <class T, bool MIN>
struct FillOp {
  static __device__ __forceinline__ T identity() {
    return MIN ? Lim<T>::hi : Lim<T>::lo;
  }
  static __device__ __forceinline__ T combine(const T& x, const T& y) {
    return MIN ? (y < x ? y : x) : (y > x ? y : x);
  }
};

// this thread's rows and its fold of them in scan order
template <class T, bool MIN, bool BWD>
__device__ __forceinline__ T load_and_fold(const T* __restrict__ in,
                                           long long m, bool vec, T* v) {
  using Op = FillOp<T, MIN>;
  const long long r0 = (long long)blockIdx.x * TILE
                       + (long long)threadIdx.x * ITEMS;
  load_items<ITEMS>(in, r0, m, vec, Op::identity(), v);
  T acc = Op::identity();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q)
    acc = Op::combine(acc, v[BWD ? ITEMS - 1 - q : q]);
  return acc;
}

template <class T, bool MIN, bool BWD>
__global__ void __launch_bounds__(THREADS)
    fill_reduce(const T* __restrict__ in, long long m, bool vec,
                T* __restrict__ agg) {
  using Op = FillOp<T, MIN>;
  __shared__ T wagg[33];
  T v[ITEMS];
  const T acc = load_and_fold<T, MIN, BWD>(in, m, vec, v);
  T tot;
  block_scan<BWD, Op>(acc, Op::identity(), wagg, &tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = tot;
}

template <class T, bool MIN, bool BWD>
__global__ void __launch_bounds__(THREADS)
    fill_emit(const T* __restrict__ in, T* __restrict__ out, long long m,
              bool vec, const T* __restrict__ carry) {
  using Op = FillOp<T, MIN>;
  __shared__ T wagg[33];
  T v[ITEMS];
  const T acc = load_and_fold<T, MIN, BWD>(in, m, vec, v);
  T tot;
  T run = block_scan<BWD, Op>(acc, carry[blockIdx.x], wagg, &tot);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int j = BWD ? ITEMS - 1 - q : q;
    run = Op::combine(run, v[j]);
    v[j] = run;
  }
  const long long r0 = (long long)blockIdx.x * TILE
                       + (long long)threadIdx.x * ITEMS;
  store_items<ITEMS>(out, r0, m, vec, v);
}

template <class T, bool MIN, bool BWD>
cudaError_t launch(const void* in_v, void* out_v, long long m, void* scratch,
                   cudaStream_t s) {
  const T* in = static_cast<const T*>(in_v);
  T* out = static_cast<T*>(out_v);
  const int tiles = int((m + TILE - 1) / TILE);
  T* agg = static_cast<T*>(scratch);
  T* carry = agg + tiles;
  const bool vec = aligned16(in) && aligned16(out);
  fill_reduce<T, MIN, BWD><<<tiles, THREADS, 0, s>>>(in, m, vec, agg);
  carry_kernel<BWD, FillOp<T, MIN>, T>
      <<<1, CARRY_THREADS, 0, s>>>(agg, carry, tiles);
  fill_emit<T, MIN, BWD><<<tiles, THREADS, 0, s>>>(in, out, m, vec, carry);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_dir(const void* in, void* out, long long m, int is_min,
                       int reverse, void* scratch, cudaStream_t s) {
  if (is_min)
    return reverse ? launch<T, true, true>(in, out, m, scratch, s)
                   : launch<T, true, false>(in, out, m, scratch, s);
  return reverse ? launch<T, false, true>(in, out, m, scratch, s)
                 : launch<T, false, false>(in, out, m, scratch, s);
}

}  // namespace

extern "C" {

// bytes of scratch for m rows of elem (4 or 8) bytes: each tile's
// aggregate and carry, and the total
long long running_fill_scratch_bytes(long long m, int elem) {
  const long long tiles = (m + TILE - 1) / TILE;
  return (2 * tiles + 1) * elem;
}

// in, out: m rows of elem bytes (int32 for 4, int64 for 8), 1 <= m <
// 2^31 * TILE; is_min: running min (else max); reverse: from the last row
int running_fill_launch(const void* in, void* out, long long m, int elem,
                        int is_min, int reverse, void* scratch,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || (elem != 4 && elem != 8)) return int(cudaErrorInvalidValue);
  return int(elem == 4
                 ? launch_dir<int>(in, out, m, is_min, reverse, scratch, s)
                 : launch_dir<long long>(in, out, m, is_min, reverse,
                                         scratch, s));
}

}  // extern "C"
