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
// is '>' (a flushing line) counts 1 into charactersRead and appends one
// separator (2); a sequence line counts its length and appends its bytes.
// The -p cut: the first sequence line whose inclusive charactersRead is
// >= sn_limit - 1 (uint64; sn_limit = 0 means no cut) keeps take =
// clamp(len - (cr - sn_limit) - 1, 0, len) bytes, and nothing after it
// counts. At the end a separator is appended when the current document
// holds bytes since the last flush. Also reported: the first offset of SX
// whose byte lies outside [3, 128) and is not 2 (validate_collection's
// test).
//
// So SX before the cut is an order-preserving compaction of the file: a
// sequence line's bytes are kept and its '\n' dropped, a flushing line's
// bytes are dropped and its '\n' kept as the 2; a line's charactersRead
// before it is exactly its output offset.
//
// What bounds it on this card: bytes. The file is read once and SX
// written once (~1.0 GB at 500 Mchars: 0.30 ms at 3.35 TB/s). What bounds
// this design is instructions (the masks, the scans, the packing), then
// the look-back's latency (PERF.md).
//
// Design: one single-pass stream compaction over 32 KB tiles of raw bytes
// on the decoupled look-back of tile_scan.cuh, then a one-block finish.
// No per-line array goes through HBM and nothing is read back by the host.
//  * parse_tile_kernel: persistent blocks (as many as the card holds) take
//    tiles by ticket. A tile's raw bytes come into shared memory by one
//    TMA bulk copy, issued for the block's next tile as soon as the
//    current tile's prefix is known (a ticket taken earlier would make
//    the tiles after it wait on this tile's look-back), so the copy runs
//    under the current tile's finishing. A tile is ROUNDS rounds of
//    THREADS threads x one 16-byte chunk.
//  * Whether a byte is kept depends on the kind of its line, known
//    locally where the line starts in the chunk; the kind of the line
//    open at the chunk's start comes from the scan. So a range's state is
//    a function of the incoming line's kind (sequence or flushing): its
//    kept bytes and the kind it leaves open, one pair per incoming kind
//    (Fn). A chunk in which a line starts (its previous byte is a '\n', or
//    it is the file's first) fixes the kind it leaves open, so a warp
//    scans its 32 chunks by ballot: a lane's incoming kind is that of the
//    nearest earlier lane where a line starts, or the warp's incoming
//    one, and the lanes' counts are summed under both of the warp's
//    incoming kinds at once (16-bit halves, 512 at most). Warp 0 scans
//    the rounds' warp functions (Fn, 31-bit counts) and the tile's
//    aggregate goes through the look-back (Fn64: 64-bit counts). Tile 0
//    starts a line, so its aggregate and every inclusive state are
//    constant functions: the exclusive prefix gives the tile's output
//    offset O_t and the kind of the line open at its start.
//  * Each chunk, knowing its incoming kind and output offset, packs its
//    kept bytes ('\n' kept as 2) in registers: where at most two bytes
//    are dropped (a sequence line's '\n'), by funnel shifts, and writes
//    the five words they span into a zeroed shared buffer aligned to the
//    16-byte frame of O_t: the words it owns by stores, the words it
//    shares with a neighbour by atomicOr; chunks that drop more (headers,
//    short lines) OR their bytes one by one. The block then stores the
//    tile's output as aligned 16-byte vectors (its two partial ends byte
//    by byte) and zeroes the buffer behind it. The pass writes the bytes
//    of every line, also those past the cut and the unterminated tail:
//    the finish overwrites what SX does not hold, up to sn + window.
//  * The cut, per tile, with P = sn_limit - 1: the earliest kept sequence
//    byte whose output offset o is >= P - 1 decides it. If o == P - 1 the
//    cut line holds output byte P - 1, so total = P and the document
//    holds bytes (the EOF separator); else total = o, the start of the
//    first sequence line after output byte P - 1, which is a separator
//    (or P = 0), and no EOF separator. Proof that total = max(P, the cut
//    line's start offset) as the reference's take gives: the cut line c
//    is the first sequence line with cr_c >= P, take = clamp(P - off_c,
//    0, len_c), so total = off_c + take = max(off_c, P) (cr_c >= P). If
//    output byte P - 1 is a sequence byte, its line has cr >= P and every
//    earlier sequence line ends at or before it, so it is c, off_c <= P -
//    1 and total = P. Otherwise every sequence line up to output byte P -
//    1 ends before it, so c is the first sequence line starting at or
//    after P, and total = off_c = o. Both candidates (2 total, + 1 when
//    there is no EOF separator) grow with the raw position, so the block
//    keeps its first by a shared atomicMin and the file's first is the
//    least raw position (an atomicMax of its complement in zeroed scratch,
//    skipped when an earlier tile already holds a smaller one). The
//    winning tile records its candidate and the flushing lines before it.
//  * Per tile also: the number of '\n' and of flushing lines it ends, and
//    the output offset after its last '\n' with that line's kind; the
//    first bad byte's output offset (a sequence byte outside [3, 128) and
//    not 2), one atomic on its complement in zeroed scratch.
//  * parse_finish_kernel, one block: the last tile with a '\n' gives
//    cr_L, the output offset after the file's last complete line. A cut
//    candidate below cr_L is the cut (a candidate from the unterminated
//    tail is never below it); without one the total is cr_L and the EOF
//    separator is there when the last complete line is a sequence line
//    (read from the lines' kinds, never from SX's last byte, which may be
//    a 2 inside a line). The separators are the flushing lines before the
//    cut (a sum over the tiles before the cut's tile and the count the
//    winning tile recorded) plus the EOF one. Then it writes the EOF
//    separator and the `window` zero bytes, and reports the first bad
//    offset only when it lies below the total.
// Positions are int64 throughout (a file may exceed 2^31 bytes). The
// output must hold F + window bytes (sn <= F: a sequence line drops its
// '\n', a flushing line keeps one byte of at least one).
//
// Plain C interface (bound with ctypes): the launch function returns
// cudaGetLastError() after its launches, launches on the given stream,
// allocates nothing (the caller passes fasta_parse_scratch_bytes(F)
// bytes of scratch, which it need not zero, the result words and the
// output) and does not synchronise.

#include <algorithm>

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

// the result words (uint64), all written by the finish
enum : int {
  R_LINES = 0,   // '\n' count: complete lines
  R_SN = 1,      // SX's length, the EOF separator included
  R_SEPS = 2,    // separators appended (flushes and the EOF one)
  R_TOTAL = 3,   // SX's length before the EOF separator
  R_CUT = 4,     // the raw offset that decided the cut, NONE for no cut
  R_BAD = 5,     // the first offset with a byte outside [3, 128), not 2
  R_WORDS = 8
};
constexpr unsigned long long NONE = ~0ull;
constexpr unsigned NL4 = 0x0a0a0a0au;    // '\n' in each byte
constexpr unsigned GT4 = 0x3e3e3e3eu;    // '>'

constexpr int THREADS = 512;
constexpr int ROUNDS = 4;
constexpr int CHUNK = 16;                     // raw bytes a thread a round
constexpr int ROUND_BYTES = THREADS * CHUNK;
constexpr int TILE = ROUNDS * ROUND_BYTES;    // 32 KB
constexpr int WARPS = THREADS / 32;
constexpr int FIN_THREADS = 1024;
static_assert(TILE < 65536, "a tile's '\\n' and flushing counts fit 16 bits");
static_assert(ROUNDS * WARPS <= 32 || ROUNDS * WARPS % 32 == 0,
              "warp 0 scans the rounds' warp totals, a whole number a lane");

// The scratch: a zeroed head (the look-back's ticket; the cut's and the
// first bad byte's keys, each the complement of a position, 0 for none)
// and the tiles' look-back states, then per tile (not zeroed) the output
// offset after its last '\n' (times 2, + 1 for a flushing line; -1 for
// none), the winning cut candidate's record and its counts.
constexpr long long HEAD = 32;
constexpr int FN64_WORDS = 5;
__host__ __device__ inline long long zeroed_bytes(long long tiles) {
  return (HEAD + 8 * FN64_WORDS * tiles + 15) & ~15ll;
}
struct Cand {
  unsigned long long enc;   // 2 total + (1 when no EOF separator)
  unsigned long long fb;    // flushing lines before the candidate byte
};

// A range's function of the incoming line's kind: ``s`` for an incoming
// sequence line, ``f`` for a flushing one, each the range's kept bytes in
// bits 0-30 and the kind it leaves open (1 flushing) in bit 31 (a tile
// holds fewer than 2^31 bytes).
struct Fn {
  unsigned s, f;
};

__device__ __forceinline__ unsigned branch(const Fn& x, unsigned k) {
  return k ? x.f : x.s;
}

struct FnOp {
  static __device__ __forceinline__ Fn identity() {
    return Fn{0u, 0x80000000u};
  }
  static __device__ __forceinline__ Fn combine(const Fn& x, const Fn& y) {
    const unsigned ys = branch(y, x.s >> 31), yf = branch(y, x.f >> 31);
    return Fn{((x.s & 0x7fffffffu) + (ys & 0x7fffffffu)) | (ys & 0x80000000u),
              ((x.f & 0x7fffffffu) + (yf & 0x7fffffffu)) |
                  (yf & 0x80000000u)};
  }
};

// The same function with 64-bit counts, for the look-back: words 0-1 the
// sequence branch's count, 2-3 the flushing branch's, word 4 the kinds
// left open (bit 0 the sequence branch's, bit 1 the flushing one's).
struct Fn64 {
  unsigned w[FN64_WORDS];
};

__device__ __forceinline__ unsigned long long count64(const Fn64& x,
                                                      unsigned k) {
  // selects, not an index: a runtime index would put x in local memory
  const unsigned lo = k ? x.w[2] : x.w[0], hi = k ? x.w[3] : x.w[1];
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned kind64(const Fn64& x, unsigned k) {
  return (x.w[4] >> k) & 1u;
}

__device__ __forceinline__ Fn64 make64(unsigned long long cs, unsigned ks,
                                       unsigned long long cf, unsigned kf) {
  Fn64 r;
  r.w[0] = unsigned(cs);
  r.w[1] = unsigned(cs >> 32);
  r.w[2] = unsigned(cf);
  r.w[3] = unsigned(cf >> 32);
  r.w[4] = ks | (kf << 1);
  return r;
}

struct Fn64Op {
  static __device__ __forceinline__ Fn64 identity() {
    return make64(0, 0, 0, 1);
  }
  static __device__ __forceinline__ Fn64 combine(const Fn64& x,
                                                 const Fn64& y) {
    const unsigned ks = kind64(x, 0), kf = kind64(x, 1);
    return make64(count64(x, 0) + count64(y, ks), kind64(y, ks),
                  count64(x, 1) + count64(y, kf), kind64(y, kf));
  }
  static __device__ __forceinline__ bool absorbs(const Fn64&) {
    return false;
  }
};

// 0x80 in each byte of x that is 0 (exact: no borrow between bytes)
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// four bits from the high bits of four bytes (bit i: byte i)
__device__ __forceinline__ unsigned nib(unsigned m) {
  return ((m >> 7) * 0x10204080u) >> 28;
}

// 0x08 in byte i of the result where bit i of the nibble n is set
__device__ __forceinline__ unsigned spread8(unsigned n) {
  return ((n * 0x00204081u) & 0x01010101u) << 3;
}

// The chunk's masks: its '\n' bytes, its '\n' and '>' bytes (the kinds a
// line start can have), and whether any byte may be bad (>= 128, or 0
// or 1; bytes past the file's end read as 0 and are sorted out later).
// A warp whose chunks hold no '>' and no such byte (sequence lines: by
// far the most) skips the exact '>' masks: one vote on a cheap test
// (haszero / hasless, exact as a yes or no) a warp.
__device__ __forceinline__ void chunk_masks(const unsigned* w, unsigned* nl,
                                            unsigned* ng, bool* maybe_bad) {
  unsigned a = 0, odd = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a |= nib(zero_bytes(w[k] ^ NL4)) << (4 * k);
    const unsigned y = w[k] ^ GT4;
    odd |= ((w[k] - 0x02020202u) & ~w[k]) | ((y - 0x01010101u) & ~y) | w[k];
  }
  odd &= 0x80808080u;
  *nl = a;
  *ng = a;
  *maybe_bad = false;
  if (__any_sync(FULL, odd != 0)) {
    unsigned b = 0, bad = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      b |= nib(zero_bytes(w[k] ^ GT4)) << (4 * k);
      bad |= (w[k] & 0x80808080u) | zero_bytes(w[k] & 0xfefefefeu);
    }
    *ng = a | b;
    *maybe_bad = bad != 0;
  }
}

// bit i: byte i is bad (outside [3, 128) and not 2)
__device__ __forceinline__ unsigned bad16(const unsigned* w) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    m |= nib((w[k] & 0x80808080u) | zero_bytes(w[k] & 0xfefefefeu))
         << (4 * k);
  return m;
}

// A chunk's kept masks for an incoming sequence line (low half) and an
// incoming flushing one (high half), and whether a line starts in it
// (``starts``): ``nl`` its '\n' bytes, ``ng`` its '\n' and '>' bytes,
// ``vm`` its bytes inside the file, ``st`` whether a line starts at its
// first byte. A line's kind is its first byte's: '\n' (an empty line) or
// '>' flushing; a sequence line keeps its bytes but the '\n', a flushing
// line only its '\n'.
__device__ __forceinline__ unsigned kept_masks(unsigned nl, unsigned ng,
                                               unsigned vm, bool st,
                                               bool* starts) {
  const unsigned sm = ((nl << 1) | unsigned(st)) & 0xffffu;  // line starts
  // each byte in a flushing line that starts in the chunk: the flushing
  // starts filled forward up to the next start
  unsigned v = sm & ng, p = ~sm & 0xffffu;
  v |= (v << 1) & p;
  p &= p << 1;
  v |= (v << 2) & p;
  p &= p << 2;
  v |= (v << 4) & p;
  p &= p << 4;
  v |= (v << 8) & p;
  // the bytes of the line open at the chunk's start
  const unsigned pre = sm ? (sm & (0u - sm)) - 1 : 0xffffu;
  *starts = sm != 0;
  return (~(v ^ nl) & vm) | ((~((v | pre) ^ nl) & vm) << 16);
}

// 128-bit x with byte i removed (the bytes above it one place down)
__device__ __forceinline__ void drop_byte(unsigned* x, int i) {
  unsigned y[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) y[k] = __funnelshift_r(x[k], x[k + 1], 8);
  y[3] = x[3] >> 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = min(max(8 * (i - 4 * k), 0), 32);   // bits kept from x
    const unsigned low = unsigned((1ull << s) - 1);
    x[k] = (x[k] & low) | (y[k] & ~low);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// Tile t's raw bytes into ``dst`` (one thread): the 16-byte aligned body
// by one TMA bulk copy completing on ``bar``, the file's last bytes
// after it by plain loads.
__device__ __forceinline__ void fetch_tile(const unsigned char* raw,
                                           long long F, int t,
                                           unsigned char* dst,
                                           unsigned long long* bar) {
  const long long b0 = (long long)t * TILE;
  const long long n = min((long long)TILE, F - b0);
  const unsigned body = unsigned(n & ~15ll);
  // the buffer's earlier reads (generic proxy) before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(body)
               : "memory");
  if (body)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(raw + b0), "r"(body), "r"(smem_u32(bar))
        : "memory");
  for (int j = int(body); j < n; ++j) dst[j] = raw[b0 + j];
}

constexpr int OBUF = TILE + 32;               // a tile's output, framed
constexpr int SMEM_BYTES = 2 * TILE + OBUF;   // two raw tiles, the output

// A persistent block takes tiles by ticket and, while it works on one,
// has the next one's raw bytes copied into its other buffer.
__global__ void __launch_bounds__(THREADS)
parse_tile_kernel(const unsigned char* __restrict__ raw, long long F,
                  long long cut_q, unsigned char* __restrict__ scratch,
                  long long tiles, unsigned char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* obuf = smem + 2 * TILE;
  unsigned* ow = reinterpret_cast<unsigned*>(obuf);
  __shared__ unsigned long long bars[2];
  __shared__ Fn tot[ROUNDS * WARPS];
  __shared__ Fn s_agg;
  __shared__ unsigned s_fl, s_nl, s_fb;
  __shared__ int s_last, s_craw, s_win, s_next;
  __shared__ unsigned long long s_enc, s_bad;

  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(scratch + 16);
  unsigned long long* slots =
      reinterpret_cast<unsigned long long*>(scratch + HEAD);
  const long long z = zeroed_bytes(tiles);
  long long* last = reinterpret_cast<long long*>(scratch + z);
  Cand* cand = reinterpret_cast<Cand*>(scratch + z + 8 * tiles);
  unsigned* cnt = reinterpret_cast<unsigned*>(scratch + z + 24 * tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the output buffer starts at 0: chunks OR their bytes into it, and the
  // store that empties it puts the 0s back
  for (int v = threadIdx.x; v < OBUF / 16; v += THREADS)
    reinterpret_cast<uint4*>(obuf)[v] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    const int t0 = int(atomicAdd(ticket, 1u));
    s_next = t0;
    if (t0 < tiles) fetch_tile(raw, F, t0, smem, &bars[0]);
  }
  __syncthreads();
  int t = s_next, buf = 0;
  unsigned parity = 0;                           // bit b: buffer b's phase
  while (t < tiles) {
    __syncthreads();                             // s_next read by all
    if (threadIdx.x == 0) {
      s_fl = s_nl = s_fb = 0;
      s_last = -1;
      s_craw = INT_MAX;
      s_win = 0;
      s_enc = s_bad = NONE;
    }
    bar_wait(&bars[buf], (parity >> buf) & 1u);
    parity ^= 1u << buf;
    const unsigned char* rb = smem + buf * TILE;
    const long long b0 = (long long)t * TILE;

    // Each chunk's kept masks, and a warp scan of the round's chunks by
    // ballot: a chunk in which a line starts fixes the kind of the line
    // open after it, so a lane's incoming kind is that of the nearest
    // earlier such lane, or the warp's incoming one; the lanes' counts
    // are summed under both incoming kinds of the warp at once (16-bit
    // halves).
    unsigned km[ROUNDS], nlr[ROUNDS], exc[ROUNDS], info = 0, nls = 0;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int cb = r * ROUND_BYTES + CHUNK * threadIdx.x;  // in the tile
      const long long left = F - b0 - cb;
      const unsigned vm = left >= 16 ? 0xffffu
                          : left > 0 ? (1u << left) - 1 : 0u;
      const uint4 v = *reinterpret_cast<const uint4*>(rb + cb);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      // the byte before the chunk: the previous lane's last, or for lane
      // 0 the tile's byte before it (the file's before the tile's first)
      unsigned prev = __shfl_up_sync(FULL, v.w, 1) >> 24;
      if (lane == 0)
        prev = cb > 0 ? rb[cb - 1] : b0 > 0 ? __ldg(raw + b0 - 1) : '\n';
      unsigned nl, ng;
      bool maybe_bad, starts;
      chunk_masks(w, &nl, &ng, &maybe_bad);
      nl &= vm;
      const unsigned k2 = kept_masks(nl, ng & vm, vm,
                                     b0 + cb == 0 || prev == '\n', &starts);
      nlr[r] = nl | (unsigned(maybe_bad) << 16);
      km[r] = k2;
      nls += __popc(nl);
      const unsigned ks = k2 & 0xffffu, kf = k2 >> 16;
      // the kind of the chunk's last byte's line (a line starts in it)
      const unsigned kout = (~(ks ^ nl) >> 15) & 1u;
      const unsigned B = __ballot_sync(FULL, starts);
      const unsigned prior = B & ((1u << lane) - 1);
      const unsigned kin = __shfl_sync(FULL, kout,
                                       prior ? 31 - __clz(prior) : 0);
      const unsigned cs = __popc(ks), cf = __popc(kf);
      const unsigned mine = prior ? (kin ? cf : cs) * 0x10001u
                                  : cs | (cf << 16);
      unsigned inc = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += y;
      }
      exc[r] = inc - mine;
      info |= ((prior ? 1u : 0u) | (kin << 1)) << (2 * r);
      const unsigned all = __shfl_sync(FULL, inc, 31);
      const unsigned kw = __shfl_sync(FULL, kout, B ? 31 - __clz(B) : 0);
      if (lane == 0)
        tot[r * WARPS + warp] = Fn{(all & 0xffffu) | ((B ? kw : 0u) << 31),
                                   (all >> 16) | ((B ? kw : 1u) << 31)};
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) nls += __shfl_xor_sync(FULL, nls, d);
    if (lane == 0 && nls) atomicAdd(&s_nl, nls);
    __syncthreads();
    if (warp == 0) {
      // the rounds' warp totals in raw order (round-major), PER a lane
      constexpr int NT = ROUNDS * WARPS, PER = (NT + 31) / 32;
      Fn x[PER], acc = FnOp::identity();
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = lane * PER + e;
        x[e] = i < NT ? tot[i] : FnOp::identity();
        acc = FnOp::combine(acc, x[e]);
      }
      Fn all;
      Fn xe = warp_scan<false, FnOp>(acc, &all);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = lane * PER + e;
        if (i < NT) tot[i] = xe;
        xe = FnOp::combine(xe, x[e]);
      }
      if (lane == 0) s_agg = all;
    }
    __syncthreads();
    const Fn agg = s_agg;
    const Fn64 pre = lookback<Fn64Op>(
        slots, t,
        make64(agg.s & 0x7fffffffu, agg.s >> 31, agg.f & 0x7fffffffu,
               agg.f >> 31));
    // the next tile, taken once this one's prefix is known (a ticket taken
    // earlier would wait on this tile's look-back, and the tiles after it
    // on that ticket's aggregate), copied in while this one is finished
    if (threadIdx.x == 0) {
      const int tn = int(atomicAdd(ticket, 1u));
      s_next = tn;
      if (tn < tiles) fetch_tile(raw, F, tn, smem + (buf ^ 1) * TILE,
                                 &bars[buf ^ 1]);
    }
    const long long ot = static_cast<long long>(count64(pre, 0));
    const unsigned kt = kind64(pre, 0);
    const int a = int(ot & 15);                   // ot's place in its frame
    const int kept_t = int(branch(agg, kt) & 0x7fffffffu);

    // each chunk's kept bytes, packed, ORed into the output buffer; the
    // tile's counts, last '\n', cut candidate and first bad byte
    unsigned fls = 0;
    long long mylast = -1;     // after this thread's last '\n', its kind
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const unsigned e = branch(tot[r * WARPS + warp], kt);
      const unsigned xw = e >> 31;                // the warp's incoming kind
      const int loc = int(e & 0x7fffffffu) +
                      int(xw ? exc[r] >> 16 : exc[r] & 0xffffu);
      const unsigned x = (info >> (2 * r)) & 1u ? (info >> (2 * r + 1)) & 1u
                                                : xw;
      const unsigned K = x ? km[r] >> 16 : km[r] & 0xffffu;
      km[r] = K;
      const unsigned nl = nlr[r] & 0xffffu;
      const uint4 v = *reinterpret_cast<const uint4*>(
          rb + r * ROUND_BYTES + CHUNK * threadIdx.x);
      unsigned p[4] = {v.x, v.y, v.z, v.w};
      const unsigned fnl = K & nl;                // '\n' kept: the 2s
      if (fnl) {
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] ^= spread8((fnl >> (4 * k)) & 15u);
      }
      const unsigned D = ~K & 0xffffu;            // dropped bytes
      const int sb = a + loc;
      unsigned bm = 0;
      if (nlr[r] >> 16) {
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
        bm = bad16(w) & K & ~nl;
      }
      if (__popc(D) <= 2) {
        // the dropped bytes taken out, the highest first
        unsigned d = D;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          if (d) {
            const int i = 31 - __clz(d);
            drop_byte(p, i);
            d &= ~(1u << i);
          }
        // the packed bytes at sb: the five words they span ORed into the
        // buffer (plain stores for the words a chunk owns measured no
        // faster)
        const int s = 8 * (sb & 3);
        unsigned* dst = ow + (sb >> 2);
        const unsigned z0 = p[0] << s;
        if (z0) atomicOr(dst, z0);
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const unsigned zk = __funnelshift_l(p[k - 1], p[k], s);
          if (zk) atomicOr(dst + k, zk);
        }
        const unsigned z4 = __funnelshift_l(p[3], 0u, s);
        if (s && z4) atomicOr(dst + 4, z4);
      } else {
        // many bytes dropped (headers, short lines): byte by byte
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if ((K >> j) & 1u) {
            const int o = sb + __popc(K & ((1u << j) - 1));
            const unsigned c = (p[j >> 2] >> (8 * (j & 3))) & 0xffu;
            if (c) atomicOr(ow + (o >> 2), c << (8 * (o & 3)));
          }
      }
      fls += __popc(fnl);
      const long long o = ot + loc;
      const int key = r * THREADS + threadIdx.x;
      // the last chunk with a '\n': the warp's highest lane
      unsigned bal = __ballot_sync(FULL, nl != 0);
      if (bal && lane == 31 - __clz(bal)) atomicMax(&s_last, key);
      if (nl) {
        const int i = 31 - __clz(nl);
        mylast = 2 * (o + __popc(K & ((2u << i) - 1))) + ((K >> i) & 1u);
      }
      // the cut: the chunk's first kept sequence byte at output >= cut_q
      if (cut_q != LLONG_MAX) {
        const long long need = cut_q - o;
        unsigned ge = need < 16 ? K : 0u;
        if (need > 0 && ge) {
#pragma unroll
          for (int k = 0; k < 15; ++k)
            if (k < need) ge &= ge - 1;
        }
        const unsigned sbits = ge & ~nl;
        bal = __ballot_sync(FULL, sbits != 0);
        if (sbits && lane == __ffs(bal) - 1) {
          const int i = __ffs(sbits) - 1;
          const long long pos = o + __popc(K & ((1u << i) - 1));
          atomicMin(&s_enc,
                    pos == cut_q ? 2ull * (pos + 1) : 2ull * pos + 1);
          atomicMin(&s_craw, key * CHUNK + i);
        }
      }
      // the first bad sequence byte
      bal = __ballot_sync(FULL, bm != 0);
      if (bm && lane == __ffs(bal) - 1) {
        const int i = __ffs(bm) - 1;
        atomicMin(&s_bad, static_cast<unsigned long long>(
                              o + __popc(K & ((1u << i) - 1))));
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) fls += __shfl_xor_sync(FULL, fls, d);
    if (lane == 0 && fls) atomicAdd(&s_fl, fls);
    __syncthreads();

    // the tile's output: aligned 16-byte stores, the partial ends
    // byte-wise; each vector read puts the buffer's 0s back
    const long long base = ot - a;
    const int end = a + kept_t;
    for (int vi = threadIdx.x; vi * 16 < end; vi += THREADS) {
      const int lo = vi * 16;
      uint4* sv = reinterpret_cast<uint4*>(obuf) + vi;
      if (lo >= a && lo + 16 <= end) {
        *reinterpret_cast<uint4*>(out + base + lo) = *sv;
      } else {
        for (int j = max(lo, a); j < min(lo + 16, end); ++j)
          out[base + j] = obuf[j];
      }
      *sv = make_uint4(0, 0, 0, 0);
    }
    if (threadIdx.x == 0) {
      cnt[t] = (s_nl << 16) | s_fl;
      if (s_last < 0) last[t] = -1;
      if (s_bad != NONE && ~s_bad > ld_word(keys + 1))
        atomicMax(keys + 1, ~s_bad);
      if (s_craw != INT_MAX) {
        const unsigned long long held = ld_word(keys);
        s_win = held == 0 ||
                static_cast<unsigned long long>(b0 + s_craw) < ~held;
      }
    }
    // the output offset after the tile's last '\n', and its line's kind
    if (s_last >= 0 && s_last % THREADS == int(threadIdx.x))
      last[t] = mylast;
    __syncthreads();
    if (s_win) {
      // the flushing lines before the candidate byte
      const int cc = s_craw / CHUNK, ci = s_craw % CHUNK;
      unsigned fb = 0;
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int c = r * THREADS + threadIdx.x;
        const unsigned f = km[r] & nlr[r] & 0xffffu;
        fb += c < cc ? __popc(f) : c == cc ? __popc(f & ((1u << ci) - 1)) : 0;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) fb += __shfl_xor_sync(FULL, fb, d);
      if (lane == 0 && fb) atomicAdd(&s_fb, fb);
      __syncthreads();
      if (threadIdx.x == 0) {
        cand[t] = Cand{s_enc, s_fb};
        atomicMax(keys, ~static_cast<unsigned long long>(b0 + s_craw));
      }
    }
    t = s_next;
    buf ^= 1;
  }
}

// block reductions of the finish (every thread gets the result)
template <bool MAX>
__device__ __forceinline__ long long block_fold(long long x,
                                                long long* part) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const long long y = __shfl_xor_sync(FULL, x, d);
    x = MAX ? max(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : (MAX ? -1 : 0);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long y = __shfl_xor_sync(FULL, x, d);
      x = MAX ? max(x, y) : x + y;
    }
    if (threadIdx.x == 0) part[32] = x;
  }
  __syncthreads();
  x = part[32];
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(FIN_THREADS)
parse_finish_kernel(const unsigned char* __restrict__ scratch,
                    long long tiles, long long window, long long cap,
                    unsigned long long* __restrict__ res,
                    unsigned char* __restrict__ out) {
  __shared__ long long part[33];
  const unsigned long long* keys =
      reinterpret_cast<const unsigned long long*>(scratch + 16);
  const long long z = zeroed_bytes(tiles);
  const long long* last = reinterpret_cast<const long long*>(scratch + z);
  const Cand* cand = reinterpret_cast<const Cand*>(scratch + z + 8 * tiles);
  const unsigned* cnt =
      reinterpret_cast<const unsigned*>(scratch + z + 24 * tiles);

  // the last tile that holds a '\n', searched from the end a block's
  // width at a time (the unterminated tail's tiles hold none)
  long long lastv = -1;
  for (long long c = tiles - 1; c >= 0; c -= FIN_THREADS) {
    const long long tt = c - threadIdx.x;
    const long long k = block_fold<true>(tt >= 0 && last[tt] >= 0 ? tt : -1,
                                         part);
    if (k >= 0) {
      lastv = last[k];
      break;
    }
  }
  const long long crl = lastv >= 0 ? lastv >> 1 : 0;
  const unsigned long long ck = keys[0];
  long long total = crl, limit = tiles, fb = 0;
  bool eof = lastv >= 0 && !(lastv & 1);
  bool cut = false;
  if (ck) {
    const long long craw = static_cast<long long>(~ck);
    const Cand c = cand[craw / TILE];
    if (static_cast<long long>(c.enc >> 1) < crl) {
      cut = true;
      total = static_cast<long long>(c.enc >> 1);
      eof = !(c.enc & 1);
      limit = craw / TILE;
      fb = static_cast<long long>(c.fb);
    }
  }
  long long nls = 0, fls = 0;
  for (long long tt = threadIdx.x; tt < tiles; tt += FIN_THREADS) {
    const unsigned v = cnt[tt];
    nls += v >> 16;
    if (tt < limit) fls += v & 0xffffu;
  }
  nls = block_fold<false>(nls, part);
  fls = block_fold<false>(fls, part) + fb;
  const long long sn = total + eof;
  if (threadIdx.x == 0) {
    const unsigned long long bk = keys[1];
    const unsigned long long bad = bk ? ~bk : NONE;
    res[R_LINES] = static_cast<unsigned long long>(nls);
    res[R_SN] = static_cast<unsigned long long>(sn);
    res[R_SEPS] = static_cast<unsigned long long>(fls + eof);
    res[R_TOTAL] = static_cast<unsigned long long>(total);
    res[R_CUT] = cut ? ~ck : NONE;
    res[R_BAD] = bad < static_cast<unsigned long long>(total) ? bad : NONE;
    res[6] = res[7] = 0;
  }
  // the EOF separator, then the window's zero bytes
  const long long lim = min(sn + window, cap);
  for (long long o = total + threadIdx.x; o < lim; o += FIN_THREADS)
    out[o] = o == total && eof ? 2 : 0;
}

long long tiles_of(long long F) { return (F + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// bytes of scratch for a file of F bytes (the launch zeroes what needs it)
long long fasta_parse_scratch_bytes(long long F) {
  const long long T = tiles_of(F);
  return zeroed_bytes(T) + 28 * T;
}

long long fasta_parse_result_words() { return R_WORDS; }

long long fasta_parse_tile_bytes() { return TILE; }

// raw: F bytes (16-byte aligned); scratch: fasta_parse_scratch_bytes(F)
// bytes (16-byte aligned); res: R_WORDS uint64 words, all written; out:
// cap >= F + window bytes (16-byte aligned), of which the first res[R_SN]
// + window are written as SX, then window zero bytes (the bytes past
// them are left as the pass wrote them). sn_limit 0: no cut.
int fasta_parse_launch(const void* raw, long long F,
                       unsigned long long sn_limit, long long window,
                       void* scratch, void* res, void* out, long long cap,
                       void* stream) {
  if (F < 0 || window < 0 || cap < F + window || !aligned16(raw) ||
      !aligned16(scratch) || !aligned16(out) ||
      tiles_of(F) > INT_MAX)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long T = tiles_of(F);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaMemsetAsync(sc, 0, zeroed_bytes(T), s);
  // the cut's output offset less one: no cut when sn_limit - 1 exceeds
  // every charactersRead the file can reach (at most F)
  const long long cut_q =
      sn_limit == 0 || sn_limit - 1 > static_cast<unsigned long long>(F)
          ? LLONG_MAX
          : static_cast<long long>(sn_limit) - 2;
  unsigned char* o = static_cast<unsigned char*>(out);
  if (T > 0) {
    // persistent blocks: as many as the card holds at once (asked once a
    // device), at most one a tile
    static int resident[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return int(cudaErrorInvalidDevice);
    if (!resident[dev]) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaError_t e = cudaFuncSetAttribute(
          parse_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_BYTES);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, parse_tile_kernel, THREADS, SMEM_BYTES);
      if (e != cudaSuccess) return int(e);
      resident[dev] = std::max(sms * per_sm, 1);
    }
    const long long grid = std::min(T, static_cast<long long>(resident[dev]));
    parse_tile_kernel<<<int(grid), THREADS, SMEM_BYTES, s>>>(
        static_cast<const unsigned char*>(raw), F, cut_q, sc, T, o);
  }
  parse_finish_kernel<<<1, FIN_THREADS, 0, s>>>(
      sc, T, window, cap, static_cast<unsigned long long*>(res), o);
  return int(cudaGetLastError());
}

}  // extern "C"
