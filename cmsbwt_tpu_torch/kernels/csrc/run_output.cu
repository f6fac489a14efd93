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
// 288 coalesced 16-byte stores; the last tile stores bytes. bwt_expand
// cuts the output into tiles of T = 16 KB and runs two kernels, with no
// array of R run ends between them.
//  * tile_starts_kernel: one single-pass look-back scan of the lengths
//    (tile_scan.cuh; a 64-bit sum, so that a bad list cannot wrap;
//    8192 runs a scan tile, loaded coalesced through a swizzled shared
//    tile and read back from it, which frees the registers for six
//    blocks an SM) checks the lengths and their total; each run that
//    covers the first byte of an output tile writes, for that tile, its
//    index and its start (one entry for each tile start it covers):
//    ceil(sn / T) entries.
//  * bwt_expand_kernel: a block of 256 threads an output tile. It reads
//    its entry and the next tile's; each thread loads a slice of the
//    consecutive runs between (at most T + 1 with valid input), eight at
//    a time, and a warp scan of the slices' sums gives each run its bytes
//    [lo, hi) of the tile. A run marks in shared memory its first byte
//    (its char, and a start bit) and the first byte of each 16-byte
//    chunk it covers after it (its char), so that every chunk's first
//    byte holds a char. Each thread then makes 16-byte chunks, four bytes
//    a word: the marked bytes kept by a byte mask made from the start
//    bits, and smeared forward over the unmarked ones, in the word and
//    from the word before; a warp's 16-byte stores are coalesced. A tile
//    inside one run stores its char with no scan.
// Bytes moved: the lengths twice, the chars once, sn written (874 MB at
// 500 Mchars against the 708 MB bound). tools/profile_slice.py
// --expand-variants times the knobs below and takes the parts out.
// Bad input never leads a kernel outside its arrays: a tile whose start
// no run covers (a short sum, a length <= 0) keeps its zeroed entry, and
// bwt_expand_kernel clamps every entry's run to [0, R) and the staged
// span to T + 1 runs; the fault word says the bytes are not the .bwt.
//
// Plain C interface (bound with ctypes): each launch function returns
// cudaGetLastError() after its launches; it launches on the given stream,
// allocates nothing (the caller passes the outputs and zeroed scratch of
// run_output_scratch_bytes(R, sn) bytes: the look-back's, the fault word
// at run_output_fault_offset(), and bwt_expand's tile starts) and does
// not synchronise. bwt_expand_launch launches both of bwt_expand's
// kernels; bwt_expand_starts_launch and bwt_expand_tiles_launch launch
// one each, so that each can be timed alone.

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

// The scan's and the expansion's blocks: SCAN_THREADS threads of
// 4 * SCAN_NV consecutive runs a scan tile, EXP_THREADS threads an output
// tile of EXP_TILE bytes, each loading LOAD_BATCH runs at once; at least
// SCAN_MIN_BLOCKS and EXP_MIN_BLOCKS blocks an SM (registers).
// tools/profile_slice.py --expand-variants times other values.
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_NV = 8;               // 16-byte vectors a thread
constexpr int SCAN_MIN_BLOCKS = 6;
constexpr int SCAN_ITEMS = 4 * SCAN_NV;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;   // 8192 runs

constexpr int EXP_THREADS = 256;
constexpr int EXP_MIN_BLOCKS = 8;
constexpr int EXP_WARPS = EXP_THREADS / 32;
constexpr int EXP_TILE = 16384;          // output bytes a block
constexpr int EXP_VEC = EXP_TILE / 16 / EXP_THREADS;   // 16-byte vectors
static_assert(EXP_VEC * EXP_THREADS * 16 == EXP_TILE, "whole vectors");
// a tile's runs: at most T + 1 with valid input (T one-byte runs and the
// run that covers the next tile's first byte)
constexpr int SPAN_MAX = EXP_TILE + 1;
static_assert((EXP_TILE & (EXP_TILE - 1)) == 0, "a power-of-two tile");
constexpr int LOG_TILE = __builtin_ctz(EXP_TILE);
constexpr int LOAD_BATCH = 8;

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

__device__ __forceinline__ long long clamp_ll(long long x, long long lo,
                                              long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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

// The scan: the start s of every run r from the lengths' 64-bit sums;
// for each output tile b whose first byte b * T the run covers
// (s <= b * T < s + len[r]), starts[b] = (r, s). Fault bits for a
// length <= 0 and for a total other than sn. Its loads are coalesced:
// each warp loads its threads' runs as 16-byte vectors, lane l taking
// vector i * 32 + l, into a swizzled shared tile (tile_scan.cuh's swz),
// from which each thread takes its consecutive runs. The tiles' frame is
// the lengths' 16-byte alignment: run r is virtual row r + shift, and
// len_al the lengths shifted back by ``shift`` rows.
__global__ void __launch_bounds__(SCAN_THREADS, SCAN_MIN_BLOCKS)
tile_starts_kernel(const int* __restrict__ len_al, long long R, int shift,
                   long long sn, int2* __restrict__ starts,
                   unsigned char* __restrict__ scratch) {
  __shared__ __align__(16) int4 buf[SCAN_THREADS * SCAN_NV];
  __shared__ Sum64 wagg[33];
  int* fault = reinterpret_cast<int*>(scratch + FAULT_AT);
  const int t = take_ticket(reinterpret_cast<unsigned*>(scratch));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long vr0 = (long long)t * SCAN_TILE;
  const long long hi = R + shift;   // virtual rows past the last run
  const int q0 = warp * 32 * SCAN_NV + lane;
  int4 w[SCAN_NV];
#pragma unroll
  for (int i = 0; i < SCAN_NV; ++i) {
    const long long vb = vr0 + (long long)(q0 + i * 32) * 4;
    if (vb >= shift && vb + 4 <= hi) {
      w[i] = __ldg(reinterpret_cast<const int4*>(len_al + vb));
    } else {
      int e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = vb + j >= shift && vb + j < hi ? __ldg(len_al + vb + j) : 0;
      w[i] = make_int4(e[0], e[1], e[2], e[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < SCAN_NV; ++i) buf[swz<SCAN_NV>(q0 + i * 32)] = w[i];
  __syncwarp();
  // this thread's consecutive items, read from the shared tile where
  // needed (not held in registers: more blocks an SM); the run of item 0,
  // and the items that are runs (rows outside [0, R) read 0: no tile, no
  // fault)
  const long long first =
      vr0 + (long long)threadIdx.x * SCAN_ITEMS - shift;
  const int ok_lo = int(clamp_ll(-first, 0, SCAN_ITEMS));
  const int ok_hi = int(clamp_ll(R - first, 0, SCAN_ITEMS));
  long long mine = 0;
  int bad = 0;
#pragma unroll
  for (int u = 0; u < SCAN_NV; ++u) {
    const int4 x = buf[swz<SCAN_NV>(threadIdx.x * SCAN_NV + u)];
    const int e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * u + k;
      if (j >= ok_lo && j < ok_hi && e[k] <= 0) bad |= LEN_FAULT;
      mine += e[k];
    }
  }
  Sum64 tile_sum;
  const Sum64 ex = block_scan<false, AddOp>(Sum64{mine}, AddOp::identity(),
                                            wagg, &tile_sum);
  const Sum64 prefix = lookback<AddOp>(
      reinterpret_cast<unsigned long long*>(scratch + 16), t, tile_sum);
  const long long tiles = (sn + EXP_TILE - 1) / EXP_TILE;
  long long s = prefix.v + ex.v;
#pragma unroll
  for (int u = 0; u < SCAN_NV; ++u) {
    const int4 x = buf[swz<SCAN_NV>(threadIdx.x * SCAN_NV + u)];
    const int e4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * u + k, vj = e4[k];
      const long long e = s + vj;
      // some b * T in [s, e): floor((e - 1) / T) > floor((s - 1) / T)
      if (((e - 1) >> LOG_TILE) > ((s - 1) >> LOG_TILE) && vj > 0 &&
          s < sn) {
        long long b = s <= 0 ? 0 : (s + EXP_TILE - 1) / EXP_TILE;
        const long long last = min((e - 1) / EXP_TILE, tiles - 1);
        const int2 entry = make_int2(int(first + j), int(max(s, 0ll)));
        for (; b <= last; ++b) starts[b] = entry;
      }
      s = e;
    }
  }
  if (threadIdx.x == 0 && vr0 + SCAN_TILE >= hi &&
      prefix.v + tile_sum.v != sn)
    bad |= SUM_FAULT;
  if (bad) atomicOr(fault, bad);
}

// One output tile a block (see the file's comment).
__global__ void __launch_bounds__(EXP_THREADS, EXP_MIN_BLOCKS)
bwt_expand_kernel(const int* __restrict__ len,
                  const unsigned char* __restrict__ chr, long long R,
                  long long sn, const int2* __restrict__ starts,
                  unsigned char* __restrict__ out) {
  // the tile's marks: at a run's first byte and at each 16-byte chunk's
  // first byte, the char of the run there (other bytes unset); a bit a
  // byte where a run starts (a chunk's first byte counts as marked)
  __shared__ __align__(16) unsigned char mark[EXP_TILE];
  __shared__ unsigned starts_at[EXP_TILE / 32];
  __shared__ int wtot[EXP_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (sn + EXP_TILE - 1) / EXP_TILE;
  const long long b = blockIdx.x;
  const long long base = b * EXP_TILE;
  const int nbytes = int(min((long long)EXP_TILE, sn - base));
  const bool vec = aligned16(out);
  // the tile's first run and the next tile's: the span between
  const int2 own = __ldg(starts + b);
  const long long r0 = clamp_ll(own.x, 0, R - 1);
  const long long r1 =
      b + 1 < tiles ? clamp_ll(__ldg(starts + b + 1).x, r0, R - 1) : R - 1;
  const int n = int(min(r1 - r0 + 1, (long long)SPAN_MAX));
  // the first run's end in the tile
  const long long first_end = (long long)own.y - base + __ldg(len + r0);
  // a run's length clamped to [0, T + 1], the first as its end in the
  // tile, so that every sum below fits 32 bits
  const int first_len = int(clamp_ll(first_end, 0, SPAN_MAX));
  const auto clamped = [&](int j, int l) {
    return j == 0 ? first_len : min(max(l, 0), SPAN_MAX);
  };
  // each thread a slice of consecutive runs: their lengths summed, the
  // loads of up to LOAD_BATCH runs in flight at once (the last batch's
  // lengths kept: all of them when the slice has at most LOAD_BATCH runs)
  const int per = (n + EXP_THREADS - 1) / EXP_THREADS;
  const int j0 = min((int)threadIdx.x * per, n), j1 = min(j0 + per, n);
  int mine = 0;
  int l[LOAD_BATCH];
  for (int j = j0; j < j1; j += LOAD_BATCH) {
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u)
      l[u] = clamped(j + u, j + u < j1 ? __ldg(len + r0 + j + u) : 0);
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u)
      if (j + u < j1) mine += l[u];
  }
  if (first_end >= nbytes) {   // the tile lies inside one run
    const unsigned char c = __ldg(chr + r0);
    const unsigned w = 0x01010101u * c;
#pragma unroll
    for (int q = 0; q < EXP_VEC; ++q) {
      const int p = (q * EXP_THREADS + threadIdx.x) * 16;
      if (p >= nbytes) break;
      if (vec && p + 16 <= nbytes) {
        *reinterpret_cast<uint4*>(out + base + p) = make_uint4(w, w, w, w);
      } else {
        for (int k = p; k < nbytes && k < p + 16; ++k) out[base + k] = c;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < EXP_TILE / 32; i += EXP_THREADS)
    starts_at[i] = 0u;
  // a warp scan of the slices' sums, the warps' totals through shared
  // memory
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  int run = incl - mine;
  for (int w = 0; w < warp; ++w) run += wtot[w];
  // each run [lo, hi) of the tile marks its first byte and the first
  // byte of every chunk it covers after it (its length kept, or again from
  // L1)
  const auto mark_run = [&](int j, int lj) {
    const int lo = min(run, EXP_TILE);
    run += lj;
    const int hi = min(run, EXP_TILE);
    if (lo < hi) {
      const unsigned char c = __ldg(chr + r0 + j);
      mark[lo] = c;
      atomicOr(starts_at + (lo >> 5), 1u << (lo & 31));
      for (int p = (lo | 15) + 1; p < hi; p += 16) mark[p] = c;
    }
  };
  if (per <= LOAD_BATCH) {
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u)
      if (j0 + u < j1) mark_run(j0 + u, l[u]);
  } else {
    for (int j = j0; j < j1; ++j) mark_run(j, clamped(j, __ldg(len + r0 + j)));
  }
  __syncthreads();
  // each 16-byte chunk from its marks: a byte takes the char of the
  // latest mark at or before it (its first byte is always one). Four
  // bytes a word: the marked bytes kept (a byte mask from the start
  // bits), then smeared forward over the unmarked ones, in the word and
  // from the word before
#pragma unroll
  for (int q = 0; q < EXP_VEC; ++q) {
    const int p = (q * EXP_THREADS + threadIdx.x) * 16;
    if (p >= nbytes) break;
    const uint4 m = *reinterpret_cast<const uint4*>(mark + p);
    const unsigned mw[4] = {m.x, m.y, m.z, m.w};
    const unsigned bits = ((starts_at[p >> 5] >> (p & 16)) & 0xFFFFu) | 1u;
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bit k of the nibble to byte k's low bit (no carries), then 0xFF
      unsigned v =
          (((bits >> (4 * i)) & 0xFu) * 0x00204081u & 0x01010101u) * 0xFFu;
      unsigned x = mw[i] & v;
      x |= (x << 8) & ~v;
      v |= v << 8;
      x |= (x << 16) & ~v;
      v |= v << 16;
      if (i > 0) x |= (0x01010101u * (w[i - 1] >> 24)) & ~v;
      w[i] = x;
    }
    if (vec && p + 16 <= nbytes) {
      *reinterpret_cast<uint4*>(out + base + p) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (p + k < nbytes)
          out[base + p + k] =
              static_cast<unsigned char>(w[k >> 2] >> (8 * (k & 3)));
    }
  }
}

long long scan_tiles(long long R, int shift) {
  return (R + shift + SCAN_TILE - 1) / SCAN_TILE;
}

// the tile starts' offset in the scratch (after the look-back's states,
// sized for the largest shift)
long long starts_offset(long long R) {
  return (lookback_bytes(scan_tiles(R, 3), 8) + 15) & ~15ll;
}

}  // namespace

extern "C" {

// bytes of zeroed scratch for R runs and sn output bytes: the
// look-back's ticket, the fault word at run_output_fault_offset() and a
// 64-bit state a scan tile, then bwt_expand's (run, start) a 16 KB output
// tile (rle_pack: R = sn = 0)
long long run_output_scratch_bytes(long long R, long long sn) {
  return starts_offset(R) + 8 * ((sn + EXP_TILE - 1) / EXP_TILE);
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

static bool expand_args(long long R, long long sn) {
  return R >= 1 && R < (1ll << 31) - 1 && sn >= 1 && sn < (1ll << 31);
}

// bwt_expand's scan alone: the tile starts and the fault word
int bwt_expand_starts_launch(const void* len, long long R, long long sn,
                             void* scratch, void* stream) {
  if (!expand_args(R, sn)) return int(cudaErrorInvalidValue);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const int* l = static_cast<const int*>(len);
  const int shift = int((reinterpret_cast<uintptr_t>(l) & 15) / 4);
  tile_starts_kernel<<<int(scan_tiles(R, shift)), SCAN_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      l - shift, R, shift, sn,
      reinterpret_cast<int2*>(sc + starts_offset(R)), sc);
  return int(cudaGetLastError());
}

// bwt_expand's expansion alone, from the tile starts a scan left in
// ``scratch``
int bwt_expand_tiles_launch(const void* len, const void* chr, long long R,
                            long long sn, void* out, void* scratch,
                            void* stream) {
  if (!expand_args(R, sn)) return int(cudaErrorInvalidValue);
  const unsigned char* sc = static_cast<const unsigned char*>(scratch);
  bwt_expand_kernel<<<int((sn + EXP_TILE - 1) / EXP_TILE), EXP_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(len), static_cast<const unsigned char*>(chr), R,
      sn, reinterpret_cast<const int2*>(sc + starts_offset(R)),
      static_cast<unsigned char*>(out));
  return int(cudaGetLastError());
}

// len int32[R], chr uint8[R], 1 <= R < 2^31 - 1, 1 <= sn < 2^31; out: sn
// bytes
int bwt_expand_launch(const void* len, const void* chr, long long R,
                      long long sn, void* out, void* scratch, void* stream) {
  const int e = bwt_expand_starts_launch(len, R, sn, scratch, stream);
  if (e != 0) return e;
  return bwt_expand_tiles_launch(len, chr, R, sn, out, scratch, stream);
}

}  // extern "C"
