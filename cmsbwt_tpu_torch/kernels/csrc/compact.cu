// compact — a stable partition of the rows 0 .. n-1 by a flag: the rows
// whose flag is set, in order, then the others, in order, as int32 row
// ids, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA sorts that
// the JAX package runs to bring flagged rows to the front
// (jax.lax.sort of where(flag, idx, INT_MAX), cmsbwt_tpu/engine/
// device_merge.py: group_dev :147, head_string_sa_dev :263,
// tail_pairs_count_dev :307, tail_good_dev :488), which the port ran as
// torch.sort. Equal element for element to ops/sort._compact_reference.
//
// The caller passes the count of set flags (every call site has it at
// hand), so the unflagged rows know where they start: row r goes to
// P + (set rows before it in its tile) when set, else to count +
// (unset rows before it). A count that is not the flags' sets bit 4 of
// the caller's fault word (the last tile checks the total; a write that
// would fall past n is dropped), and the caller raises when it reads it.
//
// What bounds it on this card: bytes: the flags read once (1 B a row) and
// the row ids written once (4 B a row).
//
// Design: one launch, a single-pass scan of the set counts with
// decoupled look-back (tile_scan.cuh's take_ticket and lookback, one
// 32-bit state in one 64-bit word) over 4096-row tiles of 256 threads,
// each thread 16 consecutive flags in one 16-byte load. A tile stages its
// row ids in shared memory in output order (set rows first) and writes
// both runs out coalesced.
//
// Plain C interface (bound with ctypes): compact_launch returns
// cudaGetLastError() after its launch; it launches on the given stream,
// allocates nothing (the caller passes compact_scratch_bytes(n) bytes of
// scratch, zeroed: the ticket and the tiles' states) and does not
// synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;   // 4096 rows
constexpr int COUNT_FAULT = 1 << 4;     // ops/sort.COUNT_FAULT

struct Count {
  static __device__ __forceinline__ unsigned identity() { return 0u; }
  static __device__ __forceinline__ unsigned combine(unsigned x, unsigned y) {
    return x + y;
  }
  static __device__ __forceinline__ bool absorbs(unsigned) { return false; }
};

__global__ void __launch_bounds__(THREADS)
compact_kernel(const unsigned char* __restrict__ flag, long long n,
               long long count, int* __restrict__ out,
               unsigned char* __restrict__ scratch, int* __restrict__ fault) {
  __shared__ unsigned srows[TILE];
  __shared__ unsigned wagg[33];
  const int t = take_ticket(reinterpret_cast<unsigned*>(scratch));
  const long long row0 = (long long)t * TILE;
  const int cnt = int(min((long long)TILE, n - row0));
  const int first = threadIdx.x * ITEMS;   // this thread's rows in the tile
  unsigned char f[ITEMS];
  if (aligned16(flag) && first + ITEMS <= cnt) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(flag + row0 + first));
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&w);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) f[i] = b[i];
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      f[i] = first + i < cnt ? __ldg(flag + row0 + first + i) : 0;
  }
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) mine += f[i] != 0;
  unsigned set_in_tile;
  const unsigned ex = block_scan<false, Count>(mine, 0u, wagg, &set_in_tile);
  const unsigned prefix = lookback<Count>(
      reinterpret_cast<unsigned long long*>(scratch + 16), t, set_in_tile);
  // stage in output order: the tile's set rows, then its unset rows
  unsigned s = ex;
  unsigned u = set_in_tile + unsigned(min(first, cnt)) - ex;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (first + i < cnt) {
      const unsigned row = unsigned(row0 + first + i);
      if (f[i])
        srows[s++] = row;
      else
        srows[u++] = row;
    }
  }
  __syncthreads();
  // set rows go to prefix + j, unset rows after all count set ones
  const long long unset_base = count + row0 - prefix - set_in_tile;
  bool bad = false;
  for (int j = threadIdx.x; j < cnt; j += THREADS) {
    const long long pos = unsigned(j) < set_in_tile
                              ? (long long)prefix + j
                              : unset_base + j;
    if (pos < n)
      out[pos] = int(srows[j]);
    else
      bad = true;
  }
  if (threadIdx.x == 0 && row0 + cnt == n &&
      (long long)prefix + set_in_tile != count)
    bad = true;
  if (bad) atomicOr(fault, COUNT_FAULT);
}

}  // namespace

extern "C" {

// bytes of scratch (zeroed by the caller): the ticket and a state a tile
long long compact_scratch_bytes(long long n) {
  return lookback_bytes((n + TILE - 1) / TILE, 4);
}

// flag: n bytes (nonzero = set), 1 <= n < 2^31 - 1; count: the set
// flags; out: n int32 row ids
int compact_launch(const void* flag, long long n, long long count, void* out,
                   void* scratch, void* fault, void* stream) {
  if (n < 1 || n >= (1ll << 31) - 1 || count < 0 || count > n)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_kernel<<<int((n + TILE - 1) / TILE), THREADS, 0, s>>>(
      static_cast<const unsigned char*>(flag), n, count,
      static_cast<int*>(out), static_cast<unsigned char*>(scratch),
      static_cast<int*>(fault));
  return int(cudaGetLastError());
}

}  // extern "C"
