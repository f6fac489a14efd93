// fasta_parse — the collection file's raw bytes parsed into SX on the
// card, for Hopper (sm_90a), where the jump scan reads it
// (cmsbwt_tpu_torch/io/parse.py).
//
// Replaces no Pallas kernel. It is the counterpart of the JAX package's
// host parse (cmsbwt_tpu/io/fasta.py:114-133 parse_collection with the
// native parser native/cmsbwt_io.cpp:23 cms_parse_collection, and the
// validation of :192-204 validate_collection), fused into one C call.
// Equal byte for byte to io/parse.parse_collection_reference.
//
// Semantics (std::getline's, as the reference tool reads the file):
// lines split on '\n' only ('\r' stays a byte of its line); the final
// unterminated line is dropped. An empty line or a line whose first byte
// is '>' counts 1 into charactersRead and appends one separator (2); a
// sequence line counts its length and appends its bytes. The -p cut: the
// first sequence line whose inclusive charactersRead is >= sn_limit - 1
// (uint64; sn_limit = 0 means no cut) keeps take = clamp(len - (cr -
// sn_limit) - 1, 0, len) bytes, and nothing after it counts. At the end a
// separator is appended when the current document holds bytes since the
// last flush. Also reported: the first offset of SX whose byte lies
// outside [3, 128) and is not 2 (validate_collection's test).
//
// What bounds it on this card: bytes. The raw file is read and SX
// written (~1.0 GB at 500 Mchars: 0.30 ms at 3.35 TB/s); the line
// records (8.3 M lines there, 17 B a line) add a few percent.
//
// Design. Positions are int64 throughout (a file may exceed 2^31 bytes).
//  * count_kernel: the file's '\n' count L (16-byte loads, a SIMD compare
//    a word, one atomic a block); the caller reads it to size the line
//    records.
//  * newline_kernel: one single-pass look-back scan (tile_scan.cuh) of
//    the '\n' counts of 16 KB tiles of raw bytes (64 a thread, four
//    16-byte loads) gives each '\n' its line index; nl[i] = the end of
//    line i.
//  * line_kernel: one look-back scan over the lines (2048 a tile, 8 a
//    thread) of charactersRead's increments (1 for an empty or '>' line,
//    the length for a sequence line). Before the cut every line's output
//    offset equals its exclusive charactersRead, so off[i] = that prefix
//    (off[L] the total), flags[i] = 1 for a flushing line, and the first
//    sequence line that reaches the cut is found by an atomicMin (one a
//    block).
//  * finish_kernel (one thread): the cut's take, the total before the
//    EOF separator and that separator, read from the last kept line or
//    two (a sequence line holds at least one byte), never from SX's last
//    byte, which may itself be a 2 inside a line.
//  * copy_kernel: a warp an output range of 2048 bytes: a binary search
//    of off finds its first line; the warp loads 32 lines' records at a
//    time (one a lane, coalesced) and writes each line's bytes, the lanes
//    on consecutive output bytes (coalesced stores); a flushing line
//    writes its 2. Bytes past the total are the EOF separator and the
//    `window` zero bytes that the jump scan's window compares read. Each
//    warp counts the separators it writes and keeps its first bad
//    offset: one atomic each a warp.
// The raw buffer and the output may have any size; out must hold
// F + window bytes (sn <= F).
//
// Plain C interface (bound with ctypes): each launch function returns
// cudaGetLastError() after its launches, launches on the given stream,
// allocates nothing (the caller passes the line records, the zeroed
// scratch of fasta_parse_scratch_bytes(F, L) bytes and the result words)
// and does not synchronise. fasta_parse_count_launch sets the result
// words and counts the lines; fasta_parse_launch runs the rest once the
// caller knows L.

#include <algorithm>

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

// the result words (uint64): set by fasta_parse_count_launch, words
// R_LINES..R_TOTAL to 0, R_CUT and R_BAD to NONE
enum : int {
  R_LINES = 0,   // '\n' count: complete lines
  R_SN = 1,      // SX's length, the EOF separator included
  R_SEPS = 2,    // separators appended (flushes and the EOF one)
  R_TOTAL = 3,   // SX's length before the EOF separator
  R_CUT = 4,     // the cut line, NONE for no cut
  R_BAD = 5,     // the first offset with a byte outside [3, 128), not 2
  R_WORDS = 8
};
constexpr unsigned long long NONE = ~0ull;
constexpr unsigned NL4 = 0x0a0a0a0au;    // '\n' in each byte

constexpr int COUNT_THREADS = 256;
constexpr int COUNT_BLOCKS_PER_SM = 8;
constexpr int NL_THREADS = 256;
constexpr int NL_BYTES = 64;             // raw bytes a thread
constexpr int NL_WORDS = NL_BYTES / 4;
constexpr int NL_TILE = NL_THREADS * NL_BYTES;   // 16 KB
constexpr int LINE_THREADS = 256;
constexpr int LINE_ITEMS = 8;            // lines a thread
constexpr int LINE_TILE = LINE_THREADS * LINE_ITEMS;
constexpr int COPY_THREADS = 256;
constexpr int COPY_WARP_BYTES = 2048;    // output bytes a warp
constexpr int COPY_TILE = COPY_THREADS / 32 * COPY_WARP_BYTES;

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

__device__ __forceinline__ int newlines4(unsigned w) {
  return __popc(__vcmpeq4(w, NL4)) >> 3;
}

__device__ __forceinline__ bool bad_byte(unsigned char v) {
  return (v < 3 || v >= 128) && v != 2;
}

__global__ void __launch_bounds__(COUNT_THREADS)
count_kernel(const unsigned char* __restrict__ raw, long long F,
             unsigned long long* __restrict__ res) {
  __shared__ int part[COUNT_THREADS / 32];
  const long long vecs = F / 16;
  const long long stride = (long long)gridDim.x * COUNT_THREADS;
  int c = 0;
  for (long long v = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x;
       v < vecs; v += stride) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(raw) + v);
    c += newlines4(w.x) + newlines4(w.y) + newlines4(w.z) + newlines4(w.w);
  }
  if (blockIdx.x == 0 && threadIdx.x < F - vecs * 16)
    c += raw[vecs * 16 + threadIdx.x] == '\n';
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int k = 0; k < COUNT_THREADS / 32; ++k) s += part[k];
    if (s) atomicAdd(res + R_LINES, static_cast<unsigned long long>(s));
  }
}

// nl[i]: the offset of the i-th '\n'
__global__ void __launch_bounds__(NL_THREADS)
newline_kernel(const unsigned char* __restrict__ raw, long long F,
               long long* __restrict__ nl, unsigned char* __restrict__ lb) {
  __shared__ Sum64 wagg[33];
  const int t = take_ticket(reinterpret_cast<unsigned*>(lb));
  const long long b0 = (long long)t * NL_TILE +
                       (long long)threadIdx.x * NL_BYTES;
  unsigned m[NL_WORDS];
  if (b0 + NL_BYTES <= F) {
    const uint4* p = reinterpret_cast<const uint4*>(raw + b0);
#pragma unroll
    for (int k = 0; k < NL_WORDS / 4; ++k) {
      const uint4 w = __ldg(p + k);
      m[4 * k] = w.x;
      m[4 * k + 1] = w.y;
      m[4 * k + 2] = w.z;
      m[4 * k + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NL_WORDS; ++k) {
      unsigned w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long b = b0 + 4 * k + j;
        if (b < F) w |= unsigned(raw[b]) << (8 * j);
      }
      m[k] = w;
    }
  }
  int c = 0;
#pragma unroll
  for (int k = 0; k < NL_WORDS; ++k) {
    m[k] = __vcmpeq4(m[k], NL4);
    c += __popc(m[k]) >> 3;
  }
  Sum64 tile;
  const Sum64 ex = block_scan<false, AddOp>(Sum64{c}, AddOp::identity(),
                                            wagg, &tile);
  const Sum64 pre = lookback<AddOp>(
      reinterpret_cast<unsigned long long*>(lb + 16), t, tile);
  long long at = pre.v + ex.v;
#pragma unroll
  for (int k = 0; k < NL_WORDS; ++k) {
    unsigned w = m[k];
    while (w) {
      const int bit = __ffs(w) - 1;        // the low bit of a 0xff byte
      nl[at++] = b0 + 4 * k + (bit >> 3);
      w &= ~(0xffu << bit);
    }
  }
}

// off[i]: line i's exclusive charactersRead, off[L] the total; flags[i]:
// 1 for an empty or '>' line; the first sequence line that reaches the
// cut into res[R_CUT]
__global__ void __launch_bounds__(LINE_THREADS)
line_kernel(const unsigned char* __restrict__ raw,
            const long long* __restrict__ nl, long long L,
            unsigned long long sn_limit, long long* __restrict__ off,
            unsigned char* __restrict__ flags,
            unsigned char* __restrict__ lb,
            unsigned long long* __restrict__ res) {
  __shared__ Sum64 wagg[33];
  __shared__ unsigned long long cut_min;
  const int t = take_ticket(reinterpret_cast<unsigned*>(lb));
  if (threadIdx.x == 0) cut_min = NONE;
  const long long i0 = (long long)t * LINE_TILE +
                       (long long)threadIdx.x * LINE_ITEMS;
  long long inc[LINE_ITEMS];
  bool fl[LINE_ITEMS];
  long long mine = 0;
#pragma unroll
  for (int j = 0; j < LINE_ITEMS; ++j) {
    const long long i = i0 + j;
    inc[j] = 0;
    fl[j] = false;
    if (i < L) {
      const long long start = i ? __ldg(nl + i - 1) + 1 : 0;
      const long long len = __ldg(nl + i) - start;
      fl[j] = len == 0 || __ldg(raw + start) == '>';
      inc[j] = fl[j] ? 1 : len;
    }
    mine += inc[j];
  }
  Sum64 tile;
  const Sum64 ex = block_scan<false, AddOp>(Sum64{mine}, AddOp::identity(),
                                            wagg, &tile);
  const Sum64 pre = lookback<AddOp>(
      reinterpret_cast<unsigned long long*>(lb + 16), t, tile);
  long long run = pre.v + ex.v;
  unsigned long long cut = NONE;
#pragma unroll
  for (int j = 0; j < LINE_ITEMS; ++j) {
    const long long i = i0 + j;
    if (i < L) {
      off[i] = run;
      flags[i] = fl[j];
      run += inc[j];
      if (!fl[j] && sn_limit > 0 && cut == NONE &&
          static_cast<unsigned long long>(run) >= sn_limit - 1)
        cut = static_cast<unsigned long long>(i);
      if (i == L - 1) off[L] = run;
    }
  }
  if (cut != NONE) atomicMin(&cut_min, cut);
  __syncthreads();
  if (threadIdx.x == 0 && cut_min != NONE)
    atomicMin(res + R_CUT, cut_min);
}

__global__ void finish_kernel(const long long* __restrict__ nl,
                              const long long* __restrict__ off,
                              const unsigned char* __restrict__ flags,
                              long long L, unsigned long long sn_limit,
                              unsigned long long* __restrict__ res) {
  long long total = 0;
  bool eof = false;
  const unsigned long long cut = res[R_CUT];
  if (L > 0 && cut != NONE) {
    const long long c = static_cast<long long>(cut);
    const long long start = c ? nl[c - 1] + 1 : 0;
    const long long len = nl[c] - start;
    const unsigned long long cr = static_cast<unsigned long long>(off[c] +
                                                                  len);
    // the reference's int64_t(charactersRead - sn_limit): -1 at least
    const long long over = static_cast<long long>(cr - sn_limit);
    long long take = len - over - 1;
    take = take < 0 ? 0 : (take > len ? len : take);
    total = off[c] + take;
    // a sequence line before the cut line holds at least one byte
    eof = take > 0 || (c > 0 && !flags[c - 1]);
  } else if (L > 0) {
    total = off[L];
    eof = !flags[L - 1];
  }
  res[R_TOTAL] = static_cast<unsigned long long>(total);
  res[R_SN] = static_cast<unsigned long long>(total + eof);
  res[R_SEPS] = eof;
}

__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const unsigned char* __restrict__ raw,
            const long long* __restrict__ nl,
            const long long* __restrict__ off,
            const unsigned char* __restrict__ flags, long long L,
            long long window, long long cap,
            unsigned long long* __restrict__ res,
            unsigned char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long o0 = ((long long)blockIdx.x * (COPY_THREADS / 32) +
                        (threadIdx.x >> 5)) * COPY_WARP_BYTES;
  const long long sn = static_cast<long long>(res[R_SN]);
  const long long total = static_cast<long long>(res[R_TOTAL]);
  const long long lim = min(sn + window, cap);
  if (o0 >= lim) return;
  const long long o1 = min(o0 + COPY_WARP_BYTES, lim);
  const long long hi = min(o1, total);
  long long bad = LLONG_MAX;
  int seps = 0;
  if (o0 < hi) {
    // the line holding o0: the last i in [0, L) with off[i] <= o0 (every
    // line before the cut writes at least one byte, and the lines after
    // it start at or past the total)
    long long lo = 0, up = L - 1;
    while (lo < up) {
      const long long mid = (lo + up + 1) >> 1;
      if (__ldg(off + mid) <= o0) lo = mid;
      else up = mid - 1;
    }
    long long i = lo, pos = o0;
    while (pos < hi) {
      const long long li = i + lane;
      // past the last line: an empty record at the total
      long long l_off = total, l_end = total, l_src = 0;
      int l_fl = 1;
      if (li < L) {
        l_off = __ldg(off + li);
        l_end = min(__ldg(off + li + 1), total);
        l_src = li ? __ldg(nl + li - 1) + 1 : 0;
        l_fl = __ldg(flags + li);
      }
      for (int k = 0; k < 32 && pos < hi; ++k) {
        const long long a = __shfl_sync(FULL, l_off, k);
        const long long e = __shfl_sync(FULL, l_end, k);
        const long long src = __shfl_sync(FULL, l_src, k);
        const int f = __shfl_sync(FULL, l_fl, k);
        const long long b = min(e, hi);
        if (f) {
          if (a >= pos && a < b && lane == 0) {
            out[a] = 2;
            ++seps;
          }
        } else {
          for (long long o = max(a, pos) + lane; o < b; o += 32) {
            const unsigned char v = __ldg(raw + src + (o - a));
            out[o] = v;
            if (bad_byte(v) && o < bad) bad = o;
          }
        }
        pos = max(pos, b);
      }
      i += 32;
    }
  }
  // past the total: the EOF separator, then the window's zero bytes
  for (long long o = max(o0, total) + lane; o < o1; o += 32)
    out[o] = (o == total && sn > total) ? 2 : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    bad = min(bad, __shfl_xor_sync(FULL, bad, d));
    seps += __shfl_xor_sync(FULL, seps, d);
  }
  if (lane == 0) {
    if (seps) atomicAdd(res + R_SEPS, static_cast<unsigned long long>(seps));
    if (bad != LLONG_MAX)
      atomicMin(res + R_BAD, static_cast<unsigned long long>(bad));
  }
}

long long nl_tiles(long long F) { return (F + NL_TILE - 1) / NL_TILE; }
long long line_tiles(long long L) { return (L + LINE_TILE - 1) / LINE_TILE; }
long long line_lb_offset(long long F) {
  return (lookback_bytes(nl_tiles(F), 8) + 15) & ~15ll;
}

}  // namespace

extern "C" {

// bytes of zeroed scratch for a file of F bytes holding L lines: the two
// look-back scans' tickets and tile states
long long fasta_parse_scratch_bytes(long long F, long long L) {
  return line_lb_offset(F) + lookback_bytes(line_tiles(L), 8);
}

long long fasta_parse_result_words() { return R_WORDS; }

// raw: F bytes (16-byte aligned); res: R_WORDS uint64 words, set here,
// with the '\n' count in res[R_LINES]
int fasta_parse_count_launch(const void* raw, long long F, void* res,
                             void* stream) {
  if (F < 0 || (reinterpret_cast<uintptr_t>(raw) & 15))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* r = static_cast<unsigned long long*>(res);
  cudaMemsetAsync(r, 0, 4 * sizeof(unsigned long long), s);
  cudaMemsetAsync(r + 4, 0xff, (R_WORDS - 4) * sizeof(unsigned long long),
                  s);
  if (F > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (F / 16 + COUNT_THREADS - 1) / COUNT_THREADS;
    const long long most = (long long)sms * COUNT_BLOCKS_PER_SM;
    const int blocks = int(std::max(1ll, std::min(want, most)));
    count_kernel<<<blocks, COUNT_THREADS, 0, s>>>(
        static_cast<const unsigned char*>(raw), F, r);
  }
  return int(cudaGetLastError());
}

// After fasta_parse_count_launch: L = res[R_LINES]; nl int64[L], off
// int64[L + 1], flags uint8[L]; scratch: fasta_parse_scratch_bytes(F, L)
// zeroed bytes; out: cap >= F + window bytes, of which the first
// res[R_SN] + window are written (SX, then window zero bytes). sn_limit
// 0: no cut.
int fasta_parse_launch(const void* raw, long long F, long long L,
                       unsigned long long sn_limit, long long window,
                       void* nl, void* off, void* flags, void* scratch,
                       void* res, void* out, long long cap, void* stream) {
  if (F < 0 || L < 0 || L > F || window < 0 || cap < F + window ||
      (reinterpret_cast<uintptr_t>(raw) & 15))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* rw = static_cast<const unsigned char*>(raw);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  long long* nlp = static_cast<long long*>(nl);
  long long* offp = static_cast<long long*>(off);
  unsigned char* flp = static_cast<unsigned char*>(flags);
  unsigned long long* r = static_cast<unsigned long long*>(res);
  if (L > 0) {
    newline_kernel<<<int(nl_tiles(F)), NL_THREADS, 0, s>>>(rw, F, nlp, sc);
    line_kernel<<<int(line_tiles(L)), LINE_THREADS, 0, s>>>(
        rw, nlp, L, sn_limit, offp, flp, sc + line_lb_offset(F), r);
  }
  finish_kernel<<<1, 1, 0, s>>>(nlp, offp, flp, L, sn_limit, r);
  if (cap > 0)
    copy_kernel<<<int((cap + COPY_TILE - 1) / COPY_TILE), COPY_THREADS, 0,
                  s>>>(rw, nlp, offp, flp, L, window, cap, r,
                       static_cast<unsigned char*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
