// run_output — the device merge's runs made into the output file's bytes
// on the card, for Hopper (sm_90a): rle_pack writes the .rl_bwt records,
// bwt_expand the .bwt bytes, so that the host only copies them into the
// file (cmsbwt_tpu_torch/io/output.py).
//
// Replaces no Pallas kernel. rle_pack is the counterpart of the JAX
// package's run packing on the device (cmsbwt_tpu/engine/device_merge.py:
// 717-759, runs_emit_dev's one byte a run with its overflow list and
// prefix tiers, decoded on the host at :950-977 and written by
// native/cmsbwt_io.cpp's cms_write_rle): here the card writes the file's
// own records. bwt_expand is the counterpart of the plain writer
// (cmsbwt_tpu/engine/merge.py runs_to_plain, cms_write_plain). Equal byte
// for byte to io/output.rle_pack_reference and bwt_expand_reference.
//
// Input: the run list engine/device_merge.run_merge leaves, run_len
// int32[R] and run_char uint8[R]: every length > 0 and neighbouring
// chars different (the merged invariant). The writers' record rule
// (adjacent equal chars merged, empty runs skipped, the tool's
// prevChar = 0 start) then gives one record a run, and R = 0 the single
// (0, 0) record. Both kernels check what they rely on and OR a bit into
// the caller's fault word: a length <= 0 (LEN_FAULT), a char equal to its
// predecessor's (CHAR_FAULT, rle_pack), lengths whose sum is not the
// collection's sn (SUM_FAULT, bwt_expand); the caller raises, and writes
// no file, when the word is not 0. Out-of-range data never makes a kernel
// read or write outside its arrays.
//
// What bounds them on this card: bytes. rle_pack reads 5 B a run and
// writes 9 (14 B a run); bwt_expand reads 5 B a run and writes sn bytes.
//
// Design. rle_pack: a block of 512 threads stages its 512 records in
// shared memory (each thread its 9 bytes) and stores the 4608 bytes as
// 288 coalesced 16-byte stores; the last tile stores bytes. bwt_expand:
// run_ends_kernel turns the lengths into each run's end (inclusive sum,
// int32: sn < 2^31) in one single-pass scan with decoupled look-back
// (tile_scan.cuh, a 64-bit sum so that a bad list cannot wrap), and
// checks the lengths and their total; bwt_expand_kernel gives each block
// a fixed tile of 16 KB of output: two warps find the tile's first and
// last runs by a 32-way search of the ends, then each thread fills four
// 16-byte vectors (the tile's v * 4096 + 16 * thread bytes, so a warp's
// stores are coalesced), each found by a binary search of the tile's
// runs and written with one 16-byte store. Runs much longer than a tile
// (identical copies) cost one run a tile.
//
// Plain C interface (bound with ctypes): each launch function returns
// cudaGetLastError() after its launches; it launches on the given stream,
// allocates nothing (the caller passes the outputs and zeroed scratch:
// run_output_scratch_bytes(R), whose fault word is at
// run_output_fault_offset(); bwt_expand's ends int32[R]) and does not
// synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int LEN_FAULT = 1;
constexpr int CHAR_FAULT = 2;
constexpr int SUM_FAULT = 4;
constexpr int FAULT_AT = 8;              // byte offset of the fault word

constexpr int PACK_THREADS = 512;
constexpr int REC = 9;                   // uint64 LE length, then the char
constexpr int PACK_TILE = PACK_THREADS * REC;   // 4608 bytes = 288 x 16
static_assert(PACK_TILE % 16 == 0, "whole 16-byte stores a tile");

constexpr int ENDS_THREADS = 256;
constexpr int ENDS_ITEMS = 16;
constexpr int ENDS_TILE = ENDS_THREADS * ENDS_ITEMS;   // 4096 runs

constexpr int EXP_THREADS = 256;
constexpr int EXP_VEC = 4;               // 16-byte vectors a thread
constexpr int EXP_TILE = EXP_THREADS * EXP_VEC * 16;   // 16384 bytes

__global__ void __launch_bounds__(PACK_THREADS)
rle_pack_kernel(const int* __restrict__ len,
                const unsigned char* __restrict__ chr, long long R,
                unsigned char* __restrict__ out, int* __restrict__ fault) {
  __shared__ __align__(16) unsigned char tile[PACK_TILE];
  const long long r0 = (long long)blockIdx.x * PACK_THREADS;
  // R = 0: one (0, 0) record
  const int cnt = R == 0 ? 1 : int(min((long long)PACK_THREADS, R - r0));
  const int i = threadIdx.x;
  int bad = 0;
  if (i < cnt) {
    unsigned long long l = 0;
    unsigned char c = 0;
    if (R > 0) {
      const long long r = r0 + i;
      const int li = __ldg(len + r);
      c = __ldg(chr + r);
      if (li <= 0) bad |= LEN_FAULT;
      if (r > 0 && __ldg(chr + r - 1) == c) bad |= CHAR_FAULT;
      l = static_cast<unsigned long long>(static_cast<long long>(li));
    }
    unsigned char* p = tile + REC * i;
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = static_cast<unsigned char>(l >> (8 * k));
    p[8] = c;
  }
  __syncthreads();
  const long long base = r0 * REC;
  const int bytes = cnt * REC;
  if (bytes == PACK_TILE && aligned16(out)) {
    if (i < PACK_TILE / 16)
      reinterpret_cast<int4*>(out + base)[i] =
          reinterpret_cast<const int4*>(tile)[i];
  } else {
    for (int k = i; k < bytes; k += PACK_THREADS) out[base + k] = tile[k];
  }
  if (bad) atomicOr(fault, bad);
}

struct Sum64 {
  long long v;
};

struct AddOp {
  static __device__ __forceinline__ Sum64 identity() { return Sum64{0}; }
  static __device__ __forceinline__ Sum64 combine(const Sum64& x,
                                                  const Sum64& y) {
    return Sum64{x.v + y.v};
  }
  static __device__ __forceinline__ bool absorbs(const Sum64&) {
    return false;
  }
};

// ends[r] = len[0] + ... + len[r] (the end of run r, one past its last
// byte), clamped to [0, INT_MAX]; fault bits for a length <= 0 and for a
// total other than sn
__global__ void __launch_bounds__(ENDS_THREADS)
run_ends_kernel(const int* __restrict__ len, long long R, long long sn,
                int* __restrict__ ends, unsigned char* __restrict__ scratch) {
  __shared__ Sum64 wagg[33];
  int* fault = reinterpret_cast<int*>(scratch + FAULT_AT);
  const int t = take_ticket(reinterpret_cast<unsigned*>(scratch));
  const long long row0 = (long long)t * ENDS_TILE;
  const long long first = row0 + (long long)threadIdx.x * ENDS_ITEMS;
  const bool vec = aligned16(len) && aligned16(ends);
  int v[ENDS_ITEMS];
  load_items<ENDS_ITEMS>(len, first, R, vec, 0, v);
  long long mine = 0;
  int bad = 0;
#pragma unroll
  for (int j = 0; j < ENDS_ITEMS; ++j) {
    if (first + j < R && v[j] <= 0) bad |= LEN_FAULT;
    mine += v[j];
  }
  Sum64 tile_sum;
  const Sum64 ex = block_scan<false, AddOp>(Sum64{mine}, AddOp::identity(),
                                            wagg, &tile_sum);
  const Sum64 prefix = lookback<AddOp>(
      reinterpret_cast<unsigned long long*>(scratch + 16), t, tile_sum);
  long long run = prefix.v + ex.v;
#pragma unroll
  for (int j = 0; j < ENDS_ITEMS; ++j) {
    run += v[j];
    v[j] = int(run < 0 ? 0 : (run > INT_MAX ? (long long)INT_MAX : run));
  }
  store_items<ENDS_ITEMS>(ends, first, R, vec, v);
  if (threadIdx.x == 0 && row0 + ENDS_TILE >= R &&
      prefix.v + tile_sum.v != sn)
    bad |= SUM_FAULT;
  if (bad) atomicOr(fault, bad);
}

// The first run r in [0, R) with ends[r] > x, or R when there is none:
// a 32-way search by one warp (every lane gets the answer). ends need
// not be sorted for the search to stay inside [0, R].
__device__ __forceinline__ long long warp_upper_bound(
    const int* __restrict__ ends, long long R, long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = R;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (long long)(lane + 1) * step - 1;
    const bool gt = p >= hi || (long long)__ldg(ends + p) > x;
    const unsigned b = __ballot_sync(FULL, gt);
    if (b == 0) {   // every probe up to hi - 1 ends at or before x
      lo = hi;
      break;
    }
    const int f = __ffs(b) - 1;
    hi = min(hi, lo + (long long)(f + 1) * step - 1);
    lo += (long long)f * step;
  }
  return lo;
}

__global__ void __launch_bounds__(EXP_THREADS)
bwt_expand_kernel(const int* __restrict__ ends,
                  const unsigned char* __restrict__ chr, long long R,
                  long long sn, unsigned char* __restrict__ out) {
  __shared__ long long span[2];
  const long long b0 = (long long)blockIdx.x * EXP_TILE;
  const long long b1 = min(b0 + EXP_TILE, sn);   // the tile's end
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long r = warp_upper_bound(ends, R, warp == 0 ? b0 : b1 - 1);
    if ((threadIdx.x & 31) == 0) span[warp] = min(r, R - 1);
  }
  __syncthreads();
  const long long lo = span[0], hi = max(span[0], span[1]);
  const bool vec = aligned16(out);
#pragma unroll
  for (int q = 0; q < EXP_VEC; ++q) {
    const long long p = b0 + ((long long)q * EXP_THREADS + threadIdx.x) * 16;
    if (p >= b1) break;
    // the run holding byte p: the first of the tile's runs ending past it
    long long a = lo, z = hi;
    while (a < z) {
      const long long m = (a + z) >> 1;
      if ((long long)__ldg(ends + m) > p)
        z = m;
      else
        a = m + 1;
    }
    long long r = a;
    long long e = __ldg(ends + r);
    unsigned c = __ldg(chr + r);
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      while (p + k >= e && r < hi) {
        ++r;
        e = __ldg(ends + r);
        c = __ldg(chr + r);
      }
      w[k >> 2] |= c << (8 * (k & 3));
    }
    if (vec && p + 16 <= b1) {
      *reinterpret_cast<uint4*>(out + p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (p + k < b1)
          out[p + k] = static_cast<unsigned char>(w[k >> 2] >> (8 * (k & 3)));
    }
  }
}

}  // namespace

extern "C" {

// bytes of zeroed scratch for R runs: the look-back's ticket, the fault
// word at run_output_fault_offset() and a 64-bit state a tile
long long run_output_scratch_bytes(long long R) {
  return lookback_bytes((R + ENDS_TILE - 1) / ENDS_TILE, 8);
}

long long run_output_fault_offset() { return FAULT_AT; }

// len int32[R], chr uint8[R], 0 <= R < 2^31 - 1; out: 9 * max(R, 1) bytes
int rle_pack_launch(const void* len, const void* chr, long long R, void* out,
                    void* scratch, void* stream) {
  if (R < 0 || R >= (1ll << 31) - 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = R == 0 ? 1 : (R + PACK_THREADS - 1) / PACK_THREADS;
  rle_pack_kernel<<<int(blocks), PACK_THREADS, 0, s>>>(
      static_cast<const int*>(len), static_cast<const unsigned char*>(chr), R,
      static_cast<unsigned char*>(out),
      reinterpret_cast<int*>(static_cast<unsigned char*>(scratch) + FAULT_AT));
  return int(cudaGetLastError());
}

// len int32[R], chr uint8[R], 1 <= R < 2^31 - 1, 1 <= sn < 2^31; ends:
// int32[R] the kernel writes; out: sn bytes
int bwt_expand_launch(const void* len, const void* chr, long long R,
                      long long sn, void* ends, void* out, void* scratch,
                      void* stream) {
  if (R < 1 || R >= (1ll << 31) - 1 || sn < 1 || sn >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  run_ends_kernel<<<int((R + ENDS_TILE - 1) / ENDS_TILE), ENDS_THREADS, 0,
                    s>>>(static_cast<const int*>(len), R, sn,
                         static_cast<int*>(ends), sc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bwt_expand_kernel<<<int((sn + EXP_TILE - 1) / EXP_TILE), EXP_THREADS, 0,
                      s>>>(static_cast<const int*>(ends),
                           static_cast<const unsigned char*>(chr), R, sn,
                           static_cast<unsigned char*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
