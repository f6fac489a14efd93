// radix_sort — a stable LSD radix sort of up to four keys by their
// significant bits only, returning the permutation as u32 row ids, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA sorts
// jax.lax.sort(..., num_keys=k) that the JAX package runs in its device
// merge (cmsbwt_tpu/engine/device_merge.py: group_dev :132 :175,
// class_ranks_dev :221, rank_heads_dev :286, tail_good_dev :424,
// tail_exact_dev :543, runs_emit_dev :694), in its device index's prefix
// doubling (cmsbwt_tpu/index/device.py :30 :86) and in the jump scan's
// candidate compaction (cmsbwt_tpu/ops/ms_jump.py :374). torch.sort, which
// the port ran there, sorts every bit of its dtype and carries int64
// indices. The permutation equals a stable sort's (ties keep input order)
// element for element: ops/sort._stable_argsort_reference.
//
// Keys (most significant first) are int32 or int64 tensors, each with a
// width ``bits``: a key equal to its pad (INT_MAX for int32, 2^62 for
// int64) maps to the all-ones word of its width, and every other key must
// lie in [0, min(2^bits - 1, pad)), so the mapped words order as the keys
// do. A key outside that range sets bit k (k = the key's place in the
// call) of the caller's fault word; the caller raises when it reads it.
//
// What bounds it on this card: bytes. The floor is one read of every key
// and one write of the permutation; the passes move more: each pass of
// 8-bit digits reads its words and row ids and writes them scattered
// (kernels/__init__.radix_plan lays the passes out: the composite plan
// drops the bits no later pass needs, so no pass gathers).
//
// Where a pass's time went before this design (tools/radix_variants.py
// --sites, every call site's real keys; the design it replaced,
// tools/radix_sort_late_counts.cu): the join's sort at 500 Mchars (493 M
// rows) took 75 ms, a u64 pass 7.7-7.9 ms against 3.5 ms of bytes, a u32
// pass 6.8-7.2 against 2.4; runs_emit's lanes (149 M rows) 2.1-2.3 ms a
// pass against 0.7. Replacing every pad by a uniform word moved no pass
// by more than 0.1 ms: the pads' skew was not the cost, a tile's chain
// was. A tile published its digit counts only after ranking all its rows
// and two block scans, so the tiles after it waited on that whole chain
// in their look-backs; each row held its word in registers (80 registers,
// 3 blocks of 3072 rows an SM); and each tile paid fixed costs per digit
// (its look-back, 2 x 256 published words, 256 global adds of the next
// pass's counts) for only 3072 rows.
//
// Design: Onesweep (Adinets and Merrill, "Onesweep: A Faster Least
// Significant Digit Radix Sort for GPUs", 2022) with CUB's early counts
// (BlockRadixRankMatchEarlyCounts): one histogram launch (radix_hist: the
// first pass's counts and every key's width check), then one launch a
// digit, each a single pass with a decoupled look-back per digit, all
// launched by one C call (radix_sort_run) from a plan of pass records.
// A radix_pass tile of 6144 rows (512 threads x 12 rows, 2 blocks an SM,
// for a pass that stages u64 words; 256 x 24, 3 an SM, for u32 words —
// the fixed costs per digit spread over twice the rows):
//  * takes its place from a ticket (scan order, never blockIdx), and its
//    arrays (the keys in place on the first pass, else the words and row
//    ids the pass before wrote) come into shared memory by 1-D TMA bulk
//    copies completing on an mbarrier (each array's tile lands at its
//    global address's offset mod 16; the few rows before and after the
//    16-byte aligned body are copied by threads), so no register holds a
//    row (48-64 registers);
//  * counts its digits at once (early counts: warp w's rows, round i lane
//    l: row w * 32 * ITEMS + i * 32 + l, add to the warp's own counters,
//    a shared atomic a row) and publishes its per-digit counts (flag AGG,
//    in a 64-bit word beside the flag and the pass, one zeroed scratch for
//    every pass), so the tiles after it wait on load + count, not on its
//    ranking;
//  * one-digit tiles (a digit holds every row: runs of pads, the high
//    digits of narrow keys) skip the ranking: a row's rank is its place;
//  * else it ranks its rows stably, round by round (a ballot per digit
//    bit groups a warp's lanes by digit), each warp starting each digit at
//    its place in the tile (the digits' starts plus the warps' counts
//    before it), and stages only the source row of each rank (2 bytes);
//  * each thread then looks back for its digit over the tiles before
//    (LB_BATCH tiles' words at once) until an inclusive count, publishes
//    its own, and the block writes its rows out in rank order, each
//    digit's run to consecutive addresses, reading words and row ids from
//    the arrays in shared memory, and counts the next pass's digits as it
//    writes them (a shared atomic a row).
// Measured against text-edited variants (tools/radix_variants.py): early
// counts and the one-digit path pay; the votes and __match_any_sync groups
// that would aggregate the counts cost more than the atomics they save
// (Hopper's shared atomics take a round's equal digits at once), and so
// does a radix_hist that counts every pass's digits; the bulk copies
// measure 4-7% a pass faster than per-thread cp.async.
//
// Plain C interface (bound with ctypes): radix_sort_run launches the steps
// it is asked for on the given stream and returns the first
// cudaGetLastError() that is not 0; it allocates nothing (the caller
// passes the ping-pong buffers and radix_sort_scratch_bytes(n) bytes of
// zeroed scratch: the passes' tickets, the digit histograms and the tiles'
// per-digit words) and does not synchronise.

#include <type_traits>

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

// radix_pass's blocks: a pass staging u64 words runs THREADS threads of
// ITEMS rows, MIN_BLOCKS an SM; one staging u32 words THREADS32 of ITEMS32,
// MIN_BLOCKS32 an SM; both tiles the same rows (tools/radix_variants.py
// builds other shapes with -D)
#ifndef RS_THREADS
#define RS_THREADS 512
#endif
#ifndef RS_ITEMS
#define RS_ITEMS 12
#endif
#ifndef RS_MIN_BLOCKS
#define RS_MIN_BLOCKS 2
#endif
#ifndef RS_THREADS32
#define RS_THREADS32 256
#endif
#ifndef RS_ITEMS32
#define RS_ITEMS32 24
#endif
#ifndef RS_MIN_BLOCKS32
#define RS_MIN_BLOCKS32 3
#endif
// tiles' words a digit's look-back reads at once
#ifndef RS_LB_BATCH
#define RS_LB_BATCH 4
#endif
// the digit's width: 8 bits (11 measured 3x slower)
#ifndef RS_RADIX_BITS
#define RS_RADIX_BITS 8
#endif
constexpr int TILE = RS_THREADS * RS_ITEMS;    // 6144 rows
static_assert(RS_THREADS32 * RS_ITEMS32 == TILE,
              "both block shapes take tiles of TILE rows");
constexpr int LB_BATCH = RS_LB_BATCH;
constexpr int RADIX_BITS = RS_RADIX_BITS;
constexpr int UNROLL = 4;             // the item loops' unroll factor
constexpr int MAX_KEYS = 4;
constexpr int MAX_PASSES = 32;
constexpr int PLAN_INTS = 10;               // ints of a pass record
constexpr int HIST_THREADS = 256;
#ifndef RS_HIST_ROWS
#define RS_HIST_ROWS 2
#endif
#ifndef RS_HIST_BLOCKS
#define RS_HIST_BLOCKS 8
#endif
constexpr int HIST_ROWS = RS_HIST_ROWS;     // radix_hist: rows a lane loads
constexpr int HIST_BLOCKS_PER_SM = RS_HIST_BLOCKS;
static_assert(TILE % 4 == 0 && TILE <= 65536,
              "a tile's rows are u16 and its arrays whole 16-byte lines");

typedef unsigned __int128 u128;

// the block of a pass that stages words of type W
template <class W>
struct Shape {
  static constexpr bool WIDE = sizeof(W) == 8;
  static constexpr int THREADS = WIDE ? RS_THREADS : RS_THREADS32;
  static constexpr int ITEMS = WIDE ? RS_ITEMS : RS_ITEMS32;
  static constexpr int MIN_BLOCKS = WIDE ? RS_MIN_BLOCKS : RS_MIN_BLOCKS32;
  static constexpr int WARPS = THREADS / 32;
};

// keys as read in place: each mapped to its word (pad -> all ones) and
// placed at its bit offset in the composite
struct Keys {
  const void* ptr[MAX_KEYS];
  long long pad[MAX_KEYS];
  unsigned long long ones[MAX_KEYS];    // 2^bits - 1: the pad's word
  int orig64[MAX_KEYS];                 // int64 (else int32) key
  int off[MAX_KEYS];                    // its lowest bit in the composite
  int nkeys;
};

struct Hist {
  Keys k;
  unsigned long long limit[MAX_KEYS];   // other keys lie below it
  int src;                              // -1: the composite, else a key
  int shift;                            // the first pass's digit's bit in it
};

// the key a pass writes the words of, gathered through the rows as they
// are written (the per-key plan: the next key, at the last pass of a key)
struct Next {
  const void* key;          // null: none
  int orig64;
  long long pad;
  unsigned long long ones;
  int wide;                 // u64 words (else u32)
  void* out;
};

// a tile's arrays in shared memory (byte offsets in the dynamic shared
// memory): each input array's tile, its row ids', the staged source rows,
// the warps' digit counters, the digits' starts, places and next counts,
// and the mbarrier
struct Layout {
  int in[MAX_KEYS];         // MODE 1: each key; MODE 0: in[0], the words
  int esz[MAX_KEYS];        // bytes of a row of each
  int nin;
  int rows;                 // the row ids (MODE 0)
  int idx;
  int whist;
  int misc;
  int bar;
  int bytes;
};

struct Pass {
  Keys k;                   // MODE 1: the keys composed
  const void* words_in;     // MODE 0: the words the pass before wrote
  const unsigned* rows_in;  // null: the identity
  int dshift;               // the digit's bit in the input
  int drop;                 // the staged word: the input >> drop
  void* words_out;          // null: no words written
  void* vals_out;           // null, or the first key's sorted values
  int vals64;
  long long vals_pad;
  unsigned long long vals_ones;
  Next next;
  int count_shift;          // -1, or the next pass's digit's bit in the
                            // words this pass writes (it counts them)
  unsigned* rows_out;
  int pass;
  long long n;
  unsigned char* scratch;
  Layout lay;
};

__host__ __device__ constexpr long long hist_offset() {
  return 4ll * MAX_PASSES;
}
__host__ __device__ constexpr long long states_offset(int bins) {
  return (hist_offset() + 4ll * MAX_PASSES * bins + 15) / 16 * 16;
}

__device__ __forceinline__ long long load_key(const void* p, int orig64,
                                              long long r) {
  return orig64 ? __ldg(static_cast<const long long*>(p) + r)
                : (long long)__ldg(static_cast<const int*>(p) + r);
}

// the key's word: its pad maps to all ones
__device__ __forceinline__ unsigned long long map_key(long long raw,
                                                      long long pad,
                                                      unsigned long long ones) {
  return raw == pad ? ones : static_cast<unsigned long long>(raw);
}

template <int RB>
__device__ __forceinline__ int digit64(unsigned long long w, int shift) {
  return int((w >> shift) & ((1ull << RB) - 1));
}

template <int RB>
__device__ __forceinline__ int digit128(u128 w, int shift) {
  return int(static_cast<unsigned long long>(w >> shift) & ((1ull << RB) - 1));
}

// the lanes of this warp whose digit equals this lane's (all lanes call)
template <int RB>
__device__ __forceinline__ unsigned peers_of(int d, bool valid) {
  unsigned peers = __ballot_sync(FULL, valid);
  if (!valid) peers = ~peers;
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned m = __ballot_sync(FULL, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// Adds the warp's valid lanes to their digits' counters (all lanes call):
// one shared atomic a lane (Hopper's shared atomics take a round's equal
// digits at once; votes and __match_any_sync groups measured slower,
// tools/radix_variants.py)
template <int RB>
__device__ __forceinline__ void count_add(unsigned* ctr, int d, bool valid) {
  if (valid) atomicAdd(ctr + d, 1u);
}

// ---------------------------------------------------------------------------
// radix_hist: the first pass's digit counts, and the keys' width check
// ---------------------------------------------------------------------------

template <int RB>
__global__ void __launch_bounds__(HIST_THREADS, HIST_BLOCKS_PER_SM)
radix_hist_kernel(Hist h, long long n, unsigned* __restrict__ hist,
                  int* __restrict__ fault) {
  constexpr int BINS = 1 << RB;
  constexpr int HWARPS = HIST_THREADS / 32;
  // [warps][BINS]: each warp's counters
  extern __shared__ unsigned s_hist[];
  for (int i = threadIdx.x; i < HWARPS * BINS; i += HIST_THREADS)
    s_hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned* wh = s_hist + (threadIdx.x >> 5) * BINS;
  int bad = 0;
  // the block's rows are one run; a warp takes 32 x HIST_ROWS consecutive
  // rows a step, all their loads in flight at once (coalesced), and adds
  // the first pass's digit to its counters (count_add)
  constexpr long long SPAN = (long long)HIST_THREADS * HIST_ROWS;
  const long long chunk = (n + gridDim.x * SPAN - 1) / (gridDim.x * SPAN) *
                          SPAN;
  const long long end = min(n, (blockIdx.x + 1) * chunk);
  for (long long base = blockIdx.x * chunk + (threadIdx.x & ~31) * HIST_ROWS;
       base < end; base += SPAN) {
    long long raw[HIST_ROWS][MAX_KEYS];
#pragma unroll
    for (int j = 0; j < HIST_ROWS; ++j) {
      const long long r = base + j * 32 + lane;
#pragma unroll
      for (int q = 0; q < MAX_KEYS; ++q)
        raw[j][q] = q < h.k.nkeys && r < end
                        ? load_key(h.k.ptr[q], h.k.orig64[q], r)
                        : 0;
    }
#pragma unroll
    for (int j = 0; j < HIST_ROWS; ++j) {
      const bool valid = base + j * 32 + lane < end;
      // the composite, and key src's word (no array: it would live in
      // local memory)
      u128 c = 0;
      unsigned long long sel = 0;
#pragma unroll
      for (int q = 0; q < MAX_KEYS; ++q) {
        if (q < h.k.nkeys && valid) {
          bad |= (raw[j][q] != h.k.pad[q] &&
                  (raw[j][q] < 0 ||
                   static_cast<unsigned long long>(raw[j][q]) >=
                       h.limit[q]))
                 << q;
          const unsigned long long w =
              map_key(raw[j][q], h.k.pad[q], h.k.ones[q]);
          c |= u128(w) << h.k.off[q];
          if (q == h.src) sel = w;
        }
      }
      const unsigned long long v =
          h.src < 0 ? static_cast<unsigned long long>(c >> h.shift)
                    : sel >> h.shift;
      count_add<RB>(wh, int(v & (BINS - 1)), valid);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BINS; i += HIST_THREADS) {
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < HWARPS; ++w) c += s_hist[w * BINS + i];
    if (c) atomicAdd(hist + i, c);
  }
  // every thread with a fault ORs its bits (rare)
  if (bad) atomicOr(fault, bad);
}

// ---------------------------------------------------------------------------
// radix_pass: one digit, one launch
// ---------------------------------------------------------------------------

// the tile's count and the pass's global count of a digit, scanned at once
struct Sum2 {
  unsigned tile, global;
};
struct Sum2Op {
  static __device__ __forceinline__ Sum2 identity() { return Sum2{0u, 0u}; }
  static __device__ __forceinline__ Sum2 combine(const Sum2& x,
                                                 const Sum2& y) {
    return Sum2{x.tile + y.tile, x.global + y.global};
  }
};

// a tile's word for one digit: the count below, the pass and status above
__device__ __forceinline__ unsigned long long digit_word(int pass, int status,
                                                         unsigned count) {
  return (static_cast<unsigned long long>((pass << 2) | status) << 32) |
         count;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
}

// a 1-D TMA copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on the mbarrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One array's tile: ``cnt`` rows of ``esz`` bytes from ``src`` into shared
// memory at ``region`` + (src mod 16), so that its 16-byte aligned body
// moves by one bulk copy (thread 0) and the rows before and after it by
// the threads. Returns where row 0 landed.
template <int THREADS>
__device__ __forceinline__ const unsigned char* load_array(
    const unsigned char* src, int esz, int cnt, unsigned char* region,
    unsigned long long* bar, unsigned* tx) {
  const int mis = int(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* dst = region + mis;
  const int head = min(((16 - mis) & 15) / esz, cnt);
  const int body = (cnt - head) * esz & ~15;
  const int tail = head + body / esz;
  if (threadIdx.x == 0 && body) {
    bulk_copy(dst + head * esz, src + head * esz, unsigned(body), bar);
    *tx += unsigned(body);
  }
  for (int k = threadIdx.x; k < head + cnt - tail; k += THREADS) {
    const int r = k < head ? k : tail + k - head;
    if (esz == 8)
      *reinterpret_cast<unsigned long long*>(dst + r * 8) =
          __ldg(reinterpret_cast<const unsigned long long*>(src) + r);
    else
      *reinterpret_cast<unsigned*>(dst + r * 4) =
          __ldg(reinterpret_cast<const unsigned*>(src) + r);
  }
  return dst;
}

// W: the staged word (what words_out and vals_out get); MODE 1: the keys
// read in place and composed, MODE 0: the words of the pass before (u64
// when its rows are 8 bytes)
template <int RB, class W, int MODE>
__global__ void __launch_bounds__(Shape<W>::THREADS, Shape<W>::MIN_BLOCKS)
radix_pass_kernel(Pass a) {
  constexpr int THREADS = Shape<W>::THREADS;
  constexpr int ITEMS = Shape<W>::ITEMS;
  constexpr int WARPS = Shape<W>::WARPS;
  constexpr int BINS = 1 << RB;
  // digits a thread owns (threads past BINS own none)
  constexpr int DPT = BINS >= THREADS ? BINS / THREADS : 1;
  static_assert(BINS < THREADS || BINS % THREADS == 0,
                "threads own whole digits");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Sum2 wagg[33];
  __shared__ int s_one;
  unsigned* whist = reinterpret_cast<unsigned*>(smem + a.lay.whist);
  unsigned* dstart = reinterpret_cast<unsigned*>(smem + a.lay.misc);
  unsigned* gofs = dstart + BINS;
  unsigned* nhist = gofs + BINS;    // the next pass's digit counts
  unsigned short* sidx = reinterpret_cast<unsigned short*>(smem + a.lay.idx);
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(smem + a.lay.bar);

  unsigned* tickets = reinterpret_cast<unsigned*>(a.scratch);
  const unsigned* ghist = reinterpret_cast<const unsigned*>(
      a.scratch + hist_offset()) + (long long)a.pass * BINS;
  unsigned long long* states = reinterpret_cast<unsigned long long*>(
      a.scratch + states_offset(BINS));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool owner = threadIdx.x * DPT < BINS;
  if (threadIdx.x == 0) {
    s_one = -1;
    bar_init(bar);
  }
  const int t = take_ticket(tickets + a.pass);
  const long long row0 = (long long)t * TILE;
  const int cnt = int(min((long long)TILE, a.n - row0));

  // the tile's arrays start for shared memory at once; the counters are
  // zeroed while they travel
  const unsigned char* in[MAX_KEYS];
  int esz[MAX_KEYS];
  unsigned tx = 0;
  const int nin = MODE == 1 ? a.k.nkeys : 1;
#pragma unroll
  for (int q = 0; q < MAX_KEYS; ++q) {
    esz[q] = a.lay.esz[q];
    in[q] = nullptr;
    if (q < nin) {
      const void* base = MODE == 1 ? a.k.ptr[q] : a.words_in;
      in[q] = load_array<THREADS>(static_cast<const unsigned char*>(base) +
                             row0 * esz[q],
                         esz[q], cnt, smem + a.lay.in[q], bar, &tx);
    }
  }
  const unsigned* rows = nullptr;
  if (a.rows_in)
    rows = reinterpret_cast<const unsigned*>(load_array<THREADS>(
        reinterpret_cast<const unsigned char*>(a.rows_in + row0), 4, cnt,
        smem + a.lay.rows, bar, &tx));
  if (threadIdx.x == 0) bar_expect(bar, tx);
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) whist[i] = 0;
  for (int i = threadIdx.x; i < BINS; i += THREADS) nhist[i] = 0;
  bar_wait(bar);
  __syncthreads();

  // row r's input word (MODE 1: the keys composed) and its digit
  using In = std::conditional_t<MODE == 1, u128, unsigned long long>;
  auto word_at = [&](int r) -> In {
    if constexpr (MODE == 1) {
      u128 c = 0;
#pragma unroll
      for (int q = 0; q < MAX_KEYS; ++q)
        if (q < a.k.nkeys) {
          const long long raw =
              a.k.orig64[q]
                  ? reinterpret_cast<const long long*>(in[q])[r]
                  : (long long)reinterpret_cast<const int*>(in[q])[r];
          c |= u128(map_key(raw, a.k.pad[q], a.k.ones[q])) << a.k.off[q];
        }
      return c;
    } else {
      return esz[0] == 8
                 ? reinterpret_cast<const unsigned long long*>(in[0])[r]
                 : (unsigned long long)reinterpret_cast<const unsigned*>(
                       in[0])[r];
    }
  };
  auto digit_of = [&](const In& v) {
    if constexpr (MODE == 1)
      return digit128<RB>(v, a.dshift);
    else
      return digit64<RB>(v, a.dshift);
  };

  // early counts: warp-striped rows, round i lane l -> row seg + i * 32 + l
  const int seg = warp * 32 * ITEMS;
  unsigned* wh = whist + warp * BINS;
#pragma unroll UNROLL
  for (int i = 0; i < ITEMS; ++i) {
    const int r = seg + i * 32 + lane;
    const bool valid = r < cnt;
    count_add<RB>(wh, valid ? digit_of(word_at(r)) : 0, valid);
  }
  __syncthreads();

  // per digit: each warp's count before it, the tile's count (published
  // now: early counts), one-digit tiles found
  unsigned cnts[DPT];
  Sum2 mine{0u, 0u}, loc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = threadIdx.x * DPT + j;
    unsigned run = 0;
    if (owner) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned c = whist[w * BINS + d];
        whist[w * BINS + d] = run;
        run += c;
      }
      st_word(states + (long long)t * BINS + d,
              digit_word(a.pass, t == 0 ? LB_INCL : LB_AGG, run));
      if (run == unsigned(cnt)) s_one = d;
    }
    cnts[j] = run;
    loc[j] = mine;
    mine.tile += run;
    if (owner) mine.global += ghist[d];
  }
  Sum2 total;
  const Sum2 ex = block_scan<false, Sum2Op>(mine, Sum2Op::identity(), wagg,
                                            &total);
  if (owner) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = threadIdx.x * DPT + j;
      const unsigned ds = ex.tile + loc[j].tile;
      dstart[d] = ds;
      gofs[d] = ex.global + loc[j].global;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) whist[w * BINS + d] += ds;
    }
  }
  __syncthreads();
  const int one = s_one;

  // stable ranks, round by round: a warp's lanes grouped by digit, each
  // warp's counter for a digit its next row's place in the tile; the
  // staged slot keeps the row (one-digit tiles: a row's rank is its place)
  if (one < 0) {
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll UNROLL
    for (int i = 0; i < ITEMS; ++i) {
      const int r = seg + i * 32 + lane;
      const bool valid = r < cnt;
      const int d = valid ? digit_of(word_at(r)) : 0;
      const unsigned peers = peers_of<RB>(d, valid);
      const unsigned base = valid ? wh[d] : 0u;
      __syncwarp();
      if (valid && !(peers & lt)) wh[d] = base + __popc(peers);
      if (valid)
        sidx[base + __popc(peers & lt)] = static_cast<unsigned short>(r);
      __syncwarp();
    }
  }

  // look back, one digit a thread: fold the counts of the tiles before
  // this one until an inclusive count
  if (owner) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = threadIdx.x * DPT + j;
      unsigned prefix = 0;
      if (t > 0) {
        // LB_BATCH tiles' words at once, the nearest first; a word not
        // yet published is read again until it is
        bool done = false;
        for (int p = t - 1; !done; p -= LB_BATCH) {
          unsigned long long w[LB_BATCH];
#pragma unroll
          for (int b = 0; b < LB_BATCH; ++b)
            w[b] = p - b >= 0 ? ld_word(states + (long long)(p - b) * BINS
                                        + d)
                              : 0ull;
#pragma unroll
          for (int b = 0; b < LB_BATCH; ++b) {
            if (done) break;
            const unsigned long long* slot =
                states + (long long)(p - b) * BINS + d;
            while (int(w[b] >> 34) != a.pass || !((w[b] >> 32) & 3u)) {
              __nanosleep(32);
              w[b] = ld_word(slot);
            }
            prefix += unsigned(w[b]);
            done = ((w[b] >> 32) & 3u) == LB_INCL;
          }
        }
        st_word(states + (long long)t * BINS + d,
                digit_word(a.pass, LB_INCL, prefix + cnts[j]));
      }
      // rank s of digit d goes to gofs[d] + s
      gofs[d] += prefix - dstart[d];
    }
  }
  __syncthreads();

  // write out in rank order: each digit's run is consecutive; the next
  // pass's digits counted as they are written
  W* wout = static_cast<W*>(a.words_out);
#pragma unroll UNROLL
  for (int i = 0; i < ITEMS; ++i) {
    const int s = threadIdx.x + i * THREADS;
    const bool valid = s < cnt;
    unsigned long long nw = 0;
    if (valid) {
      const int src = one >= 0 ? s : int(sidx[s]);
      const In v = word_at(src);
      const W word = W(static_cast<unsigned long long>(v >> a.drop));
      const unsigned pos = gofs[digit_of(v)] + unsigned(s);
      const unsigned row = rows ? rows[src] : unsigned(row0 + src);
      a.rows_out[pos] = row;
      nw = static_cast<unsigned long long>(word);
      if (wout) wout[pos] = word;
      if (a.next.key) {
        nw = map_key(load_key(a.next.key, a.next.orig64, row), a.next.pad,
                     a.next.ones);
        if (a.next.wide)
          static_cast<unsigned long long*>(a.next.out)[pos] = nw;
        else
          static_cast<unsigned*>(a.next.out)[pos] = unsigned(nw);
      }
      if (a.vals_out) {
        const long long val =
            static_cast<unsigned long long>(word) == a.vals_ones
                ? a.vals_pad
                : static_cast<long long>(word);
        if (a.vals64)
          static_cast<long long*>(a.vals_out)[pos] = val;
        else
          static_cast<int*>(a.vals_out)[pos] = int(val);
      }
    }
    // the next pass's digit (radix_hist counts the first pass's only)
    if (a.count_shift >= 0) {
      const int nd = digit64<RB>(nw, a.count_shift);
      count_add<RB>(nhist, nd, valid);
    }
  }
  if (a.count_shift >= 0) {
    __syncthreads();
    unsigned* next_hist = reinterpret_cast<unsigned*>(
        a.scratch + hist_offset()) + (long long)(a.pass + 1) * BINS;
    for (int d = threadIdx.x; d < BINS; d += THREADS)
      if (nhist[d]) atomicAdd(next_hist + d, nhist[d]);
  }
}

template <int RB>
int hist_launch(const Hist& h, long long n, void* scratch, void* fault,
                cudaStream_t s) {
  auto fn = radix_hist_kernel<RB>;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long span = (long long)HIST_THREADS * HIST_ROWS;
  const long long blocks =
      min((n + span - 1) / span, (long long)sms * HIST_BLOCKS_PER_SM);
  const int smem = HIST_THREADS / 32 * (1 << RB) * 4;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  fn<<<int(blocks), HIST_THREADS, smem, s>>>(
      h, n,
      reinterpret_cast<unsigned*>(static_cast<unsigned char*>(scratch) +
                                  hist_offset()),
      static_cast<int*>(fault));
  return int(cudaGetLastError());
}

// the shared memory of a pass whose input arrays have these row sizes
// (with the row ids when ``rows``)
Layout make_layout(int nin, const int* esz, bool rows, int rb, int warps) {
  Layout L{};
  int at = 0;
  auto take = [&](int bytes) {
    const int o = at;
    at += (bytes + 15) / 16 * 16;
    return o;
  };
  L.nin = nin;
  for (int q = 0; q < nin; ++q) {
    L.esz[q] = esz[q];
    L.in[q] = take(TILE * esz[q] + 16);
  }
  L.rows = rows ? take(TILE * 4 + 16) : 0;
  L.idx = take(TILE * 2);
  L.whist = take(warps * (1 << rb) * 4);
  L.misc = take(3 * (1 << rb) * 4);
  L.bar = take(8);
  L.bytes = at;
  return L;
}

// the pass kernel's shared memory: its bytes allowed, and the SM's
// carveout at its largest so that MIN_BLOCKS blocks fit
template <int RB, class W, int MODE>
void pass_attributes(int smem) {
  auto fn = radix_pass_kernel<RB, W, MODE>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                       int(cudaSharedmemCarveoutMaxShared));
}

template <int RB, class W, int MODE>
int pass_launch(Pass a, const int* esz, cudaStream_t s) {
  a.lay = make_layout(MODE == 1 ? a.k.nkeys : 1, esz, MODE == 0, RB,
                      Shape<W>::WARPS);
  pass_attributes<RB, W, MODE>(a.lay.bytes);
  const long long tiles = (a.n + TILE - 1) / TILE;
  radix_pass_kernel<RB, W, MODE>
      <<<int(tiles), Shape<W>::THREADS, a.lay.bytes, s>>>(a);
  return int(cudaGetLastError());
}

template <int RB, class W, int MODE>
void occupancy(int smem, int* blocks) {
  pass_attributes<RB, W, MODE>(smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, radix_pass_kernel<RB, W, MODE>, Shape<W>::THREADS, smem);
}

template <int RB>
int pass_dispatch(const Pass& a, const int* esz, int stage_wide,
                  cudaStream_t s) {
  if (a.k.nkeys > 0)
    return stage_wide ? pass_launch<RB, unsigned long long, 1>(a, esz, s)
                      : pass_launch<RB, unsigned, 1>(a, esz, s);
  return stage_wide ? pass_launch<RB, unsigned long long, 0>(a, esz, s)
                    : pass_launch<RB, unsigned, 0>(a, esz, s);
}

// the keys' descriptors (key qs[i] at bit offs[i]); false if one is out
// of range
bool fill_keys(Keys* k, int nkeys, const int* qs, void* const* keys,
               const int* orig64, const long long* pads, const int* bits,
               const int* offs) {
  if (nkeys < 0 || nkeys > MAX_KEYS) return false;
  k->nkeys = nkeys;
  for (int i = 0; i < nkeys; ++i) {
    const int q = qs ? qs[i] : i;
    if (q < 0 || q >= MAX_KEYS || bits[q] < 1 ||
        bits[q] > (orig64[q] ? 63 : 31) || offs[i] < 0 ||
        offs[i] + bits[q] > 128)
      return false;
    k->ptr[i] = keys[q];
    k->pad[i] = pads[q];
    k->ones[i] = (1ull << bits[q]) - 1ull;
    k->orig64[i] = orig64[q];
    k->off[i] = offs[i];
  }
  return true;
}

}  // namespace

extern "C" {

// rows of a tile
int radix_sort_tile() { return TILE; }

// the digit's width in bits
int radix_sort_radix_bits() { return RADIX_BITS; }

// the passes one sort may make
int radix_sort_max_passes() { return MAX_PASSES; }

// blocks of the pass kernel an SM holds: input rows of in_bytes (the
// keys' bytes summed when composed), with row ids if rows, u64 staged
// words if wide
int radix_pass_blocks_per_sm(int in_bytes, int rows, int wide,
                             int composed) {
  int blocks = -1;
  const int warps = wide ? Shape<unsigned long long>::WARPS
                         : Shape<unsigned>::WARPS;
  const Layout L = make_layout(1, &in_bytes, rows != 0, RADIX_BITS, warps);
  if (wide)
    composed ? occupancy<RADIX_BITS, unsigned long long, 1>(L.bytes, &blocks)
             : occupancy<RADIX_BITS, unsigned long long, 0>(L.bytes, &blocks);
  else
    composed ? occupancy<RADIX_BITS, unsigned, 1>(L.bytes, &blocks)
             : occupancy<RADIX_BITS, unsigned, 0>(L.bytes, &blocks);
  return blocks;
}

// bytes of scratch (zeroed by the caller) for a sort of n rows: the
// passes' tickets, their digit counts and one 8-byte word per tile and
// digit (reused by every pass)
long long radix_sort_scratch_bytes(long long n) {
  const int bins = 1 << RADIX_BITS;
  const long long tiles = (n + TILE - 1) / TILE;
  return states_offset(bins) + 8ll * tiles * bins;
}

// A sort of n rows by nkeys (1..4) keys: pointers to n rows each, most
// significant first; orig64: int64 (else int32); pads, bits: each key's
// pad and width; hist_offs: each key's lowest bit in the composite. Runs
// steps [first, last) of the npass records (PLAN_INTS ints each, a pass
// of kernels.radix_plan: in_wide, dshift, drop, stage_wide, write, vals,
// next, count_shift, hist_src, hist_shift): step 0, radix_hist (the
// first pass's digits, at bit hist_shift of the composite when hist_src
// is -1, else of key hist_src's word; and bit q ORed into *fault for a
// key q outside [0, min(2^bits - 1, pad)) that is not its pad), then step
// p + 1, pass p.
// Pass 0 reads the nin keys in_keys in place (at bits in_offs of the
// composite); pass p > 0 the words (u64 if in_wide) and row ids pass p - 1
// wrote. Pass p's digit is at bit dshift of its input; it stages the
// input >> drop (u64 if stage_wide) and writes it to words[p % 2] if
// write, or the words of key next (>= 0) gathered through its rows, to
// words[p % 2]; and, if vals, as the first key's values (all ones -> its
// pad) to vals. Its row ids go to rows[p % 2], the last pass's to
// out_rows. Unless count_shift is -1, it counts the
// digits at that bit of the words it writes (pass p + 1's).
int radix_sort_run(int nkeys, void* const* keys, const int* orig64,
                   const long long* pads, const int* bits,
                   const int* hist_offs, int nin, const int* in_keys,
                   const int* in_offs,
                   const int* recs, int npass, int first, int last,
                   void* words0, void* words1, void* rows0, void* rows1,
                   void* out_rows, void* vals, long long n, void* scratch,
                   void* fault, void* stream) {
  constexpr int BAD = int(cudaErrorInvalidValue);
  if (nkeys < 1 || nkeys > MAX_KEYS || n < 1 || n >= (1ll << 31) - 1 ||
      npass < 1 || npass > MAX_PASSES || first < 0 || last > npass + 1 ||
      first > last || !scratch || !out_rows)
    return BAD;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* words[2] = {words0, words1};
  void* rowbuf[2] = {rows0, rows1};
  for (int step = first; step < last; ++step) {
    int err = 0;
    if (step == 0) {
      Hist h{};
      if (!fill_keys(&h.k, nkeys, nullptr, keys, orig64, pads, bits,
                     hist_offs) || !fault)
        return BAD;
      h.src = recs[8];
      h.shift = recs[9];
      if (h.src < -1 || h.src >= nkeys || h.shift < 0 ||
          h.shift + RADIX_BITS > (h.src < 0 ? 128 : 64))
        return BAD;
      for (int q = 0; q < nkeys; ++q)
        h.limit[q] = h.k.ones[q] < static_cast<unsigned long long>(pads[q])
                         ? h.k.ones[q]
                         : static_cast<unsigned long long>(pads[q]);
      err = hist_launch<RADIX_BITS>(h, n, scratch, fault, s);
    } else {
      const int p = step - 1;
      const int* r = recs + p * PLAN_INTS;
      const int in_wide = r[0], dshift = r[1], drop = r[2];
      const int stage_wide = r[3], write = r[4], want_vals = r[5];
      const int next = r[6], count_shift = r[7];
      const bool final = p + 1 == npass;
      Pass a{};
      int esz[MAX_KEYS] = {in_wide ? 8 : 4};   // the input's rows' bytes
      if (p == 0) {
        if (nin < 1 || !fill_keys(&a.k, nin, in_keys, keys, orig64, pads,
                                  bits, in_offs) ||
            dshift < 0 || dshift >= 128 || drop < 0 || drop >= 128)
          return BAD;
        for (int q = 0; q < nin; ++q) esz[q] = orig64[in_keys[q]] ? 8 : 4;
      } else {
        a.words_in = words[(p - 1) & 1];
        a.rows_in = static_cast<const unsigned*>(rowbuf[(p - 1) & 1]);
        if (!a.words_in || !a.rows_in || dshift < 0 || dshift >= 64 ||
            drop < 0 || drop >= 64)
          return BAD;
      }
      a.dshift = dshift;
      a.drop = drop;
      a.words_out = write ? words[p & 1] : nullptr;
      if ((write && !a.words_out) || (want_vals && (!vals || !final)) ||
          next < -1 || next >= nkeys || count_shift < -1 ||
          count_shift >= 64 || (count_shift >= 0 && final))
        return BAD;
      if (want_vals) {
        a.vals_out = vals;
        a.vals64 = orig64[0];
        a.vals_pad = pads[0];
        a.vals_ones = (1ull << bits[0]) - 1ull;
      }
      if (next >= 0) {
        a.next.key = keys[next];
        a.next.orig64 = orig64[next];
        a.next.pad = pads[next];
        a.next.ones = (1ull << bits[next]) - 1ull;
        a.next.wide = bits[next] > 32;
        a.next.out = words[p & 1];
        if (!a.next.out) return BAD;
      }
      a.count_shift = count_shift;
      a.rows_out = static_cast<unsigned*>(final ? out_rows : rowbuf[p & 1]);
      if (!a.rows_out) return BAD;
      a.pass = p;
      a.n = n;
      a.scratch = static_cast<unsigned char*>(scratch);
      err = pass_dispatch<RADIX_BITS>(a, esz, stage_wide, s);
    }
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
