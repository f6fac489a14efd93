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
// What bounds it on this card: bytes. The function needs 2 x the array's
// bytes (read once, written once: 16 B per int64 row).
//
// Design: one launch, each row read once and written once: a single-pass
// scan with decoupled look-back over tiles of 32 KB (8192 int32 or 4096
// int64 rows), 256 threads of 32 or 16 consecutive rows each.
//  * A block takes its tile in scan order from a ticket (tile_scan.cuh's
//    take_ticket), so it only ever waits on tiles whose blocks run.
//    Reverse runs the same scan backward (the last tile first; warps,
//    threads and rows from the last), so no flipped copy is made.
//  * Loads and stores are coalesced: each warp moves its 32 threads' rows
//    (4 KB) as 16-byte vectors, lane l taking vector i * 32 + l, through
//    shared memory, where a thread then reads and writes its own
//    consecutive rows. The shared tile is XOR-swizzled by 16-byte vector
//    (tile_scan.cuh's swz), so neither the warp's vectors nor the
//    threads' rows meet a bank conflict; a warp touches only its own
//    part, so a __syncwarp orders it. Each thread has 128 B of loads in
//    flight, a block its whole tile.
//  * The frame of the tiles is the input's 16-byte alignment: row r is
//    virtual row r + shift (shift = the rows before the first aligned
//    address), so every whole vector is aligned. The vectors that hold
//    rows outside [0, m), as in a view like v[1:], go through element
//    loads; stores are vectors where the output has the input's shift, and
//    element stores otherwise.
//  * The look-back is tile_scan.cuh's lookback: the first warp
//    reads the 32 tiles before its own per round until it meets a
//    published inclusive state, and waits only on the tiles up to it; a
//    tile's state shares 64-bit words with its flag (int32: one word,
//    int64: two), so a round is one trip to L2.
//
// Plain C interface (bound with ctypes): running_fill_launch returns
// cudaGetLastError() after its launch; it launches on the given stream,
// allocates nothing (the caller passes running_fill_scratch_bytes(m,
// elem) bytes of scratch, zeroed: the ticket and the tiles' states) and
// does not synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

// measured on the H100 (tools/lookback_variants.py): 16 KB tiles, 128 or
// 512 threads and 3 blocks an SM were no faster
constexpr int THREADS = 256;
constexpr int TILE_BYTES = 32768;
constexpr int MIN_BLOCKS = 4;   // blocks an SM holds: caps the registers

template <class T>
struct Geo {
  static constexpr int PER = 16 / int(sizeof(T));   // rows per vector
  static constexpr int ITEMS = TILE_BYTES / int(sizeof(T)) / THREADS;
  static constexpr int TILE = THREADS * ITEMS;      // rows per tile
  static constexpr int NV = ITEMS / PER;            // vectors per thread
  static_assert(NV >= 1 && (NV & (NV - 1)) == 0, "whole vectors");
};

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
  // no aggregate hides every value before it in general
  static __device__ __forceinline__ bool absorbs(const T&) { return false; }
};

// ---------------------------------------------------------------------------
// the scan
// ---------------------------------------------------------------------------

__device__ __forceinline__ void to_vec(int4& w, const int* v) {
  w = make_int4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void to_vec(int4& w, const long long* v) {
  const longlong2 x = make_longlong2(v[0], v[1]);
  w = *reinterpret_cast<const int4*>(&x);
}
__device__ __forceinline__ void from_vec(const int4& w, int* v) {
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
__device__ __forceinline__ void from_vec(const int4& w, long long* v) {
  const longlong2 x = *reinterpret_cast<const longlong2*>(&w);
  v[0] = x.x; v[1] = x.y;
}

// in_al / out_al: the input and output shifted back by ``shift`` rows (to
// the 16-byte boundary at or before row 0); vr0: the tile's first virtual
// row; out_vec: the output has the input's shift
template <class T, bool MIN, bool BWD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fill_scan(const T* __restrict__ in_al, T* __restrict__ out_al,
              long long m, int shift, bool out_vec, int tiles,
              unsigned* __restrict__ ticket,
              unsigned long long* __restrict__ slots) {
  using G = Geo<T>;
  using Op = FillOp<T, MIN>;
  constexpr int PER = G::PER, NV = G::NV, ITEMS = G::ITEMS;
  __shared__ __align__(16) int4 buf[THREADS * NV];
  __shared__ T wagg[33];
  const int t = take_ticket(ticket);
  const int tile = BWD ? tiles - 1 - t : t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long vr0 = (long long)tile * G::TILE;
  const long long hi = m + shift;   // virtual rows past the last row
  // the warp's vectors: lane l takes vector i * 32 + l of its part
  const int q0 = warp * 32 * NV + lane;
  int4 w[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const long long vb = vr0 + (long long)(q0 + i * 32) * PER;
    if (vb >= shift && vb + PER <= hi) {
      w[i] = __ldg(reinterpret_cast<const int4*>(in_al + vb));
    } else {
      T e[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j)
        e[j] = vb + j >= shift && vb + j < hi ? __ldg(in_al + vb + j)
                                              : Op::identity();
      to_vec(w[i], e);
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) buf[swz<NV>(q0 + i * 32)] = w[i];
  __syncwarp();
  // this thread's consecutive rows, and their fold in scan order
  T v[ITEMS];
#pragma unroll
  for (int u = 0; u < NV; ++u)
    from_vec(buf[swz<NV>(threadIdx.x * NV + u)], v + u * PER);
  T acc = Op::identity();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q)
    acc = Op::combine(acc, v[BWD ? ITEMS - 1 - q : q]);
  T tot;
  const T ex = block_scan<BWD, Op>(acc, Op::identity(), wagg, &tot);
  T run = Op::combine(lookback<Op>(slots, t, tot), ex);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int j = BWD ? ITEMS - 1 - q : q;
    run = Op::combine(run, v[j]);
    v[j] = run;
  }
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    int4 x;
    to_vec(x, v + u * PER);
    buf[swz<NV>(threadIdx.x * NV + u)] = x;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const long long vb = vr0 + (long long)(q0 + i * 32) * PER;
    const int4 x = buf[swz<NV>(q0 + i * 32)];
    if (out_vec && vb >= shift && vb + PER <= hi) {
      *reinterpret_cast<int4*>(out_al + vb) = x;
    } else {
      T e[PER];
      from_vec(x, e);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (vb + j >= shift && vb + j < hi) out_al[vb + j] = e[j];
    }
  }
}

template <class T>
long long tiles_of(long long m, int shift) {
  return (m + shift + Geo<T>::TILE - 1) / Geo<T>::TILE;
}

template <class T>
int shift_of(const void* p) {
  return int((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

template <class T, bool MIN, bool BWD>
cudaError_t launch(const void* in_v, void* out_v, long long m, void* scratch,
                   cudaStream_t s) {
  const T* in = static_cast<const T*>(in_v);
  T* out = static_cast<T*>(out_v);
  const int shift = shift_of<T>(in);
  const int tiles = int(tiles_of<T>(m, shift));
  unsigned* ticket = static_cast<unsigned*>(scratch);
  auto* slots = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + 16);
  fill_scan<T, MIN, BWD><<<tiles, THREADS, 0, s>>>(
      in - shift, out - shift, m, shift, shift_of<T>(out) == shift, tiles,
      ticket, slots);
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

// bytes of scratch (zeroed by the caller) for m rows of elem bytes: the
// ticket and a 16-byte state per tile (tiles of the worst input shift)
long long running_fill_scratch_bytes(long long m, int elem) {
  const long long tiles = elem == 4 ? tiles_of<int>(m, 3)
                                    : tiles_of<long long>(m, 1);
  return lookback_bytes(tiles, elem);
}

// in, out: m rows of elem bytes (int32 for 4, int64 for 8), 1 <= m,
// fewer than 2^31 tiles; is_min: running min (else max); reverse: from
// the last row
int running_fill_launch(const void* in, void* out, long long m, int elem,
                        int is_min, int reverse, void* scratch,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || (elem != 4 && elem != 8)) return int(cudaErrorInvalidValue);
  if ((elem == 4 ? tiles_of<int>(m, 3) : tiles_of<long long>(m, 1))
      >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  return int(elem == 4
                 ? launch_dir<int>(in, out, m, is_min, reverse, scratch, s)
                 : launch_dir<long long>(in, out, m, is_min, reverse,
                                         scratch, s));
}

}  // extern "C"
