// radix_sort_late_counts.cu — the radix sort that
// cmsbwt_tpu_torch/kernels/csrc/radix_sort.cu replaced, kept whole so that
// tools/radix_variants.py can time the two designs in one run (late_counts:
// a tile publishes its digit counts only after it has ranked every row;
// words, digits and row ids staged in shared memory; one shared atomic a
// row for the next pass's counts). Nothing of the package builds or calls
// it. Its C interface is the one radix_variants.LateSorter binds: one
// radix_hist_launch, then one radix_pass_launch a digit.
//
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
// d-bit digits reads its words and row ids and writes them scattered.
//
// Design: Onesweep (Adinets and Merrill, "Onesweep: A Faster Least
// Significant Digit Radix Sort for GPUs", 2022): one histogram launch,
// then one launch per digit, each a single pass with a decoupled
// look-back per digit. kernels/__init__.radix_plan lays the passes out.
//  * The composite plan, when the keys' total width less the first digit
//    fits 64 bits (every call site of the port): the keys are one
//    composite key C (most significant key in the top bits). The first
//    pass reads the keys themselves, in place, and every pass writes the
//    words of C with the bits it no longer needs dropped (a pass's words
//    are u32 once they fit), so no pass gathers; the most significant
//    key's bits stay whole when its sorted values are wanted.
//  * The per-key plan otherwise: key by key, the least significant first;
//    the last pass of a key writes the next key's words, gathered through
//    the rows it writes (the gather sits in the write-out, after the
//    look-back, where no tile waits on it).
//  * radix_hist reads every key once (coalesced), checks it against its
//    width and counts the first pass's digits (a warp's lanes of one
//    digit, found with __match_any_sync, add their count to the warp's
//    counter); each pass counts the next pass's digits as it writes its
//    words (a shared atomic a row).
//  * radix_pass: a block takes its 3072-row tile from a ticket (scan
//    order, never blockIdx), loads its rows warp-striped (warp w owns 384
//    consecutive rows; in round i lane l holds row i * 32 + l, coalesced)
//    and ranks them stably: round by round each warp groups its lanes by
//    digit (a ballot per digit bit), so a row's rank among its warp's
//    equal digits is the rows before it in row order. Per digit the
//    warps' counts then give each warp its base and the tile its count,
//    which the tile publishes at once (flag AGG) in a 64-bit word beside
//    its flag, as tile_scan.cuh's look-back words are; the flag also
//    carries the pass, so one zeroed scratch serves every pass of a sort.
//    The block stages its words, digits and row ids in shared memory in
//    digit order, then each thread looks back for one digit over the
//    tiles before it (8 tiles' words at once) until it meets a published
//    inclusive count, publishes its own, and the block writes its rows
//    out from shared memory, each digit's run to consecutive addresses.
//  * A pass waits on memory more than it moves it (tools/radix_variants.py
//    times the variants), so: registers set how many blocks an SM holds
//    (3, by the launch bound), and a thread holds its words, their
//    digits (packed) and ranks only; the row ids are copied into shared
//    memory (cp.async) as the keys load, and arrive while they are
//    ranked.
//
// Plain C interface (bound with ctypes): each *_launch returns
// cudaGetLastError() after its launch; it launches on the given stream,
// allocates nothing (the caller passes radix_sort_scratch_bytes(n) bytes
// of scratch, zeroed: the passes' tickets, the digit histograms and the
// tiles' per-digit words) and does not synchronise.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

// radix_pass's block: THREADS threads of ITEMS rows, MIN_BLOCKS an SM
// (tools/radix_variants.py builds other shapes with -D)
#ifndef RS_THREADS
#define RS_THREADS 256
#endif
#ifndef RS_ITEMS
#define RS_ITEMS 12
#endif
#ifndef RS_MIN_BLOCKS
#define RS_MIN_BLOCKS 3
#endif
// tiles' words a digit's look-back reads at once
#ifndef RS_LB_BATCH
#define RS_LB_BATCH 8
#endif
// the digit's width: 8 bits (11 measured slower: tools/radix_variants.py)
#ifndef RS_RADIX_BITS
#define RS_RADIX_BITS 8
#endif
constexpr int THREADS = RS_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = RS_ITEMS;
constexpr int TILE = THREADS * ITEMS;       // 3072 rows
constexpr int MIN_BLOCKS = RS_MIN_BLOCKS;
constexpr int LB_BATCH = RS_LB_BATCH;
constexpr int RADIX_BITS = RS_RADIX_BITS;
constexpr int MAX_KEYS = 4;
constexpr int MAX_PASSES = 32;
constexpr int HIST_THREADS = 256;
constexpr int HIST_ROWS = 2;                // radix_hist: rows a lane loads
constexpr int HIST_BLOCKS_PER_SM = 4;

typedef unsigned __int128 u128;

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
  int shift;                            // the digit's bit in it (+ RB <= 64)
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

struct Pass {
  Keys k;                   // mode 1 (k.nkeys > 0): the keys composed
  const void* words_in;     // mode 0: the words the pass before wrote
  int in_wide;
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

__device__ __forceinline__ u128 compose(const Keys& k, long long r) {
  u128 c = 0;
#pragma unroll
  for (int q = 0; q < MAX_KEYS; ++q)
    if (q < k.nkeys)
      c |= u128(map_key(load_key(k.ptr[q], k.orig64[q], r), k.pad[q],
                        k.ones[q])) << k.off[q];
  return c;
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

// ---------------------------------------------------------------------------
// radix_hist: every pass's digit counts, and the keys' width check
// ---------------------------------------------------------------------------

template <int RB>
__global__ void __launch_bounds__(HIST_THREADS, 4)
radix_hist_kernel(Hist h, long long n, unsigned* __restrict__ hist,
                  int* __restrict__ fault) {
  constexpr int BINS = 1 << RB;
  constexpr int HWARPS = HIST_THREADS / 32;
  extern __shared__ unsigned s_hist[];   // [warps][BINS]
  for (int i = threadIdx.x; i < HWARPS * BINS; i += HIST_THREADS)
    s_hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned* wh = s_hist + (threadIdx.x >> 5) * BINS;
  int bad = 0;
  // the block's rows are one run; a warp takes 32 x HIST_ROWS consecutive
  // rows a step, all their loads in flight at once (coalesced); the
  // lanes of one digit add their count to the warp's own counter (one
  // lane a digit: no atomics). The digit lies in C's (or the key's) low
  // 64 bits.
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
      unsigned long long v = 0;
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
          if (h.src == q)
            v = w;
          else if (h.src < 0 && h.k.off[q] < 64)
            v |= w << h.k.off[q];
        }
      }
      const int d = digit64<RB>(v, h.shift);
      // (one match here beats the passes' ballots: tools/radix_variants.py)
      const unsigned peers = __match_any_sync(FULL, valid ? d : BINS + lane);
      if (valid && !(peers & ((1u << lane) - 1u))) wh[d] += __popc(peers);
      __syncwarp();
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

struct Sum {
  static __device__ __forceinline__ unsigned identity() { return 0u; }
  static __device__ __forceinline__ unsigned combine(unsigned x, unsigned y) {
    return x + y;
  }
};

// a tile's word for one digit: the count below, the pass and status above
__device__ __forceinline__ unsigned long long digit_word(int pass, int status,
                                                         unsigned count) {
  return (static_cast<unsigned long long>((pass << 2) | status) << 32) |
         count;
}

// the staged tile: a word, a digit and a row id a row
template <int RB, class W>
__host__ __device__ constexpr int region_bytes() {
  return WARPS * (1 << RB) * 4 > TILE * (int(sizeof(W)) + 4 + 2)
             ? WARPS * (1 << RB) * 4
             : TILE * (int(sizeof(W)) + 4 + 2);
}

template <int RB, class W>
__host__ __device__ constexpr int pass_smem() {
  // the digits' starts, places and next-pass counts, and the tile's row
  // ids in row order, copied in as the keys load
  return region_bytes<RB, W>() + 3 * (1 << RB) * 4 + TILE * 4;
}

// a 4-byte copy from global to shared memory that does not wait
__device__ __forceinline__ void copy_async4(unsigned* dst,
                                            const unsigned* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// W: the staged word (what words_out and vals_out get); MODE 1: the keys
// read in place and composed, MODE 0: the words of the pass before
template <int RB, class W, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
radix_pass_kernel(Pass a) {
  constexpr int BINS = 1 << RB;
  // digits a thread owns (threads past BINS own none)
  constexpr int DPT = BINS >= THREADS ? BINS / THREADS : 1;
  static_assert(BINS % THREADS == 0 || THREADS % BINS == 0,
                "threads own whole digits");
  // digits packed a register
  constexpr int DPR = RB <= 8 ? 4 : 2;
  constexpr int DBITS = 32 / DPR;
  constexpr int NDG = (ITEMS + DPR - 1) / DPR;
  extern __shared__ __align__(16) unsigned char smem[];
  // the warps' digit counters, then (aliased) the staged tile
  unsigned* whist = reinterpret_cast<unsigned*>(smem);
  W* swords = reinterpret_cast<W*>(smem);
  unsigned* srows = reinterpret_cast<unsigned*>(smem + TILE * sizeof(W));
  unsigned short* sdig = reinterpret_cast<unsigned short*>(
      smem + TILE * (sizeof(W) + 4));
  unsigned* dstart = reinterpret_cast<unsigned*>(smem +
                                                 region_bytes<RB, W>());
  unsigned* gofs = dstart + BINS;
  unsigned* nhist = gofs + BINS;    // the next pass's digit counts
  unsigned* inrows = nhist + BINS;  // the row ids in row order
  __shared__ unsigned wagg[33];

  unsigned* tickets = reinterpret_cast<unsigned*>(a.scratch);
  const unsigned* ghist = reinterpret_cast<const unsigned*>(
      a.scratch + hist_offset()) + (long long)a.pass * BINS;
  unsigned long long* states = reinterpret_cast<unsigned long long*>(
      a.scratch + states_offset(BINS));

  const int t = take_ticket(tickets + a.pass);
  const long long row0 = (long long)t * TILE;
  const int cnt = int(min((long long)TILE, a.n - row0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool owner = threadIdx.x * DPT < BINS;

  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) whist[i] = 0;
  for (int i = threadIdx.x; i < BINS; i += THREADS) nhist[i] = 0;

  // the row ids start on their way to shared memory now, and arrive
  // while the keys are ranked
  if (a.rows_in) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int s = warp * 32 * ITEMS + i * 32 + lane;
      if (s < cnt) copy_async4(inrows + s, a.rows_in + row0 + s);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // load: warp-striped rows, round i lane l -> row seg + i * 32 + l; a
  // row's digit and its staged word (the row ids travel apart, to shared
  // memory: fewer registers)
  W k[ITEMS];
  unsigned dg[NDG];
#pragma unroll
  for (int i = 0; i < NDG; ++i) dg[i] = 0;
  const int seg = warp * 32 * ITEMS;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = seg + i * 32 + lane;
    k[i] = 0;
    if (s < cnt) {
      int d;
      if (MODE == 1) {
        const u128 v = compose(a.k, row0 + s);
        d = digit128<RB>(v, a.dshift);
        k[i] = W(static_cast<unsigned long long>(v >> a.drop));
      } else {
        const unsigned long long v =
            a.in_wide
                ? __ldg(static_cast<const unsigned long long*>(a.words_in) +
                        row0 + s)
                : __ldg(static_cast<const unsigned*>(a.words_in) + row0 + s);
        d = digit64<RB>(v, a.dshift);
        k[i] = W(v >> a.drop);
      }
      dg[i / DPR] |= unsigned(d) << (i % DPR * DBITS);
    }
  }
  __syncthreads();    // the counters are zero

  auto digit = [&](int i) {
    return int((dg[i / DPR] >> (i % DPR * DBITS)) & ((1u << DBITS) - 1));
  };

  // stable ranks within the warp, round by round
  unsigned off[ITEMS];
  const unsigned lt = (1u << lane) - 1u;
  unsigned* wh = whist + warp * BINS;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool valid = seg + i * 32 + lane < cnt;
    const int d = digit(i);
    const unsigned peers = peers_of<RB>(d, valid);
    const unsigned base = valid ? wh[d] : 0u;
    __syncwarp();
    if (valid && !(peers & lt)) wh[d] = base + __popc(peers);
    off[i] = base + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();

  // per digit: each warp's base, the tile's count, published at once
  unsigned cnts[DPT], ex_local[DPT], tsum = 0;
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
    }
    cnts[j] = run;
    ex_local[j] = tsum;
    tsum += run;
  }
  unsigned total;
  const unsigned ex = block_scan<false, Sum>(tsum, 0u, wagg, &total);
  // the pass's global digit starts, from the histogram
  unsigned gc_local[DPT], gsum = 0;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    gc_local[j] = gsum;
    if (owner) gsum += ghist[threadIdx.x * DPT + j];
  }
  const unsigned gex = block_scan<false, Sum>(gsum, 0u, wagg, &total);
  if (owner) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = threadIdx.x * DPT + j;
      dstart[d] = ex + ex_local[j];
      gofs[d] = gex + gc_local[j];
    }
  }
  __syncthreads();

  // each row's place in the tile, digit by digit
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (seg + i * 32 + lane < cnt) {
      const int d = digit(i);
      off[i] += dstart[d] + wh[d];
    }
  }
  __syncthreads();    // the counters are read: stage over them
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (seg + i * 32 + lane < cnt) {
      swords[off[i]] = k[i];
      sdig[off[i]] = static_cast<unsigned short>(digit(i));
    }
  }
  // the row ids, staged beside their words (a thread moves the ones it
  // copied in)
  if (a.rows_in) asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = seg + i * 32 + lane;
    if (s < cnt) srows[off[i]] = a.rows_in ? inrows[s] : unsigned(row0 + s);
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
      // row s of the staged tile (digit d) goes to gofs[d] + s
      gofs[d] += prefix - dstart[d];
    }
  }
  __syncthreads();

  // write out from the staged tile: each digit's run is consecutive. The
  // next key's gathers are issued first, all of a thread's at once
  long long nk[ITEMS];
  if (a.next.key) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int s = threadIdx.x + i * THREADS;
      nk[i] = s < cnt ? load_key(a.next.key, a.next.orig64, srows[s]) : 0;
    }
  }
  W* wout = static_cast<W*>(a.words_out);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = threadIdx.x + i * THREADS;
    if (s >= cnt) break;
    const W word = swords[s];
    const unsigned pos = gofs[sdig[s]] + unsigned(s);
    a.rows_out[pos] = srows[s];
    unsigned long long nw = static_cast<unsigned long long>(word);
    if (wout) wout[pos] = word;
    if (a.next.key) {
      nw = map_key(nk[i], a.next.pad, a.next.ones);
      if (a.next.wide)
        static_cast<unsigned long long*>(a.next.out)[pos] = nw;
      else
        static_cast<unsigned*>(a.next.out)[pos] = unsigned(nw);
    }
    // the next pass's digit, counted here (radix_hist counts the first
    // pass's only)
    if (a.count_shift >= 0)
      atomicAdd(nhist + digit64<RB>(nw, a.count_shift), 1u);
    if (a.vals_out) {
      const long long v = static_cast<unsigned long long>(word) == a.vals_ones
                              ? a.vals_pad
                              : static_cast<long long>(word);
      if (a.vals64)
        static_cast<long long*>(a.vals_out)[pos] = v;
      else
        static_cast<int*>(a.vals_out)[pos] = int(v);
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

// the pass kernel's shared memory: its bytes allowed, and the SM's
// carveout at its largest so that MIN_BLOCKS blocks fit
template <int RB, class W, int MODE>
void pass_attributes() {
  auto fn = radix_pass_kernel<RB, W, MODE>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pass_smem<RB, W>());
  cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                       int(cudaSharedmemCarveoutMaxShared));
}

template <int RB, class W, int MODE>
int pass_launch(const Pass& a, cudaStream_t s) {
  constexpr int smem = pass_smem<RB, W>();
  auto fn = radix_pass_kernel<RB, W, MODE>;
  pass_attributes<RB, W, MODE>();
  const long long tiles = (a.n + TILE - 1) / TILE;
  fn<<<int(tiles), THREADS, smem, s>>>(a);
  return int(cudaGetLastError());
}

template <int RB, class W, int MODE>
void occupancy(int* blocks) {
  pass_attributes<RB, W, MODE>();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, radix_pass_kernel<RB, W, MODE>, THREADS, pass_smem<RB, W>());
}

template <int RB>
int pass_dispatch(const Pass& a, int stage_wide, cudaStream_t s) {
  if (a.k.nkeys > 0)
    return stage_wide ? pass_launch<RB, unsigned long long, 1>(a, s)
                      : pass_launch<RB, unsigned, 1>(a, s);
  return stage_wide ? pass_launch<RB, unsigned long long, 0>(a, s)
                    : pass_launch<RB, unsigned, 0>(a, s);
}

// the keys' descriptors; false if one is out of range
bool fill_keys(Keys* k, int nkeys, void* const* keys, const int* orig64,
               const long long* pads, const int* bits, const int* offs) {
  if (nkeys < 0 || nkeys > MAX_KEYS) return false;
  k->nkeys = nkeys;
  for (int q = 0; q < nkeys; ++q) {
    if (bits[q] < 1 || bits[q] > (orig64[q] ? 63 : 31) || offs[q] < 0 ||
        offs[q] + bits[q] > 128)
      return false;
    k->ptr[q] = keys[q];
    k->pad[q] = pads[q];
    k->ones[q] = (1ull << bits[q]) - 1ull;
    k->orig64[q] = orig64[q];
    k->off[q] = offs[q];
  }
  return true;
}

}  // namespace

extern "C" {

// rows of a tile, and the passes one sort may make
int radix_sort_tile() { return TILE; }

// the digit's width in bits
int radix_sort_radix_bits() { return RADIX_BITS; }

// blocks of the pass kernel an SM holds (u64 staged words if wide, the
// keys read in place if composed)
int radix_pass_blocks_per_sm(int wide, int composed) {
  int blocks = -1;
  if (wide)
    composed ? occupancy<RADIX_BITS, unsigned long long, 1>(&blocks)
             : occupancy<RADIX_BITS, unsigned long long, 0>(&blocks);
  else
    composed ? occupancy<RADIX_BITS, unsigned, 1>(&blocks)
             : occupancy<RADIX_BITS, unsigned, 0>(&blocks);
  return blocks;
}
int radix_sort_max_passes() { return MAX_PASSES; }

// bytes of scratch (zeroed by the caller) for a sort of n rows: the
// passes' tickets, their digit counts and one 8-byte word per tile and
// digit (reused by every pass)
long long radix_sort_scratch_bytes(long long n) {
  const int bins = 1 << RADIX_BITS;
  const long long tiles = (n + TILE - 1) / TILE;
  return states_offset(bins) + 8ll * tiles * bins;
}

// keys: nkeys (1..4) pointers to n rows each, most significant first;
// orig64: int64 (else int32); pads, bits: each key's pad and width; offs:
// each key's lowest bit in the composite. Counts the first pass's digits,
// at bit ``shift`` of the composite (src == -1) or of key src's word
// (shift + radix_sort_radix_bits() <= 64), into the scratch (each later
// pass's are counted by the pass before it), and ORs bit q into *fault
// for a key q outside [0, min(2^bits - 1, pad)) that is not its pad.
int radix_hist_launch(int nkeys, void* const* keys, const int* orig64,
                      const long long* pads, const int* bits,
                      const int* offs, int src, int shift, long long n,
                      void* scratch, void* fault, void* stream) {
  Hist h{};
  if (nkeys < 1 || n < 1 || n >= (1ll << 31) - 1 ||
      !fill_keys(&h.k, nkeys, keys, orig64, pads, bits, offs) ||
      src < -1 || src >= nkeys || shift < 0 || shift + RADIX_BITS > 64)
    return int(cudaErrorInvalidValue);
  for (int q = 0; q < nkeys; ++q)
    h.limit[q] = h.k.ones[q] < static_cast<unsigned long long>(pads[q])
                     ? h.k.ones[q]
                     : static_cast<unsigned long long>(pads[q]);
  h.src = src;
  h.shift = shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hist_launch<RADIX_BITS>(h, n, scratch, fault, s);
}

// One pass, number ``pass`` of the sort (its ticket, its counts). Input:
// the nkeys keys themselves (nkeys > 0, described as for radix_hist),
// composed, or else words_in (u64 if in_wide, else u32), the words the
// pass before wrote; rows_in the row order so far (null: the identity).
// The digit is at bit dshift of the input, and the staged word is the
// input >> drop (u64 if stage_wide, else u32), written to words_out and,
// as the values of a key (int64 if vals64, else int32; all ones -> its
// pad), to vals_out, where not null. rows_out gets the row ids; where
// next_key is not null, next_out gets that key's words (next_bits wide,
// u64 if next_wide), gathered through the rows. Unless count_shift is -1,
// the digits at that bit of the words written (the next pass's) are
// added into pass + 1's counts.
int radix_pass_launch(int nkeys, void* const* keys, const int* orig64,
                      const long long* pads, const int* bits,
                      const int* offs, const void* words_in, int in_wide,
                      const void* rows_in, int dshift, int drop,
                      int stage_wide, void* words_out, void* vals_out,
                      int vals64, long long vals_pad, int vals_bits,
                      const void* next_key, int next_orig64,
                      long long next_pad, int next_bits, int next_wide,
                      void* next_out, int count_shift, void* rows_out,
                      int pass, long long n, void* scratch, void* stream) {
  Pass a{};
  if (n < 1 || n >= (1ll << 31) - 1 || pass < 0 || pass >= MAX_PASSES ||
      dshift < 0 || dshift >= 128 || drop < 0 ||
      drop >= 128 || !rows_out ||
      !fill_keys(&a.k, nkeys, keys, orig64, pads, bits, offs) ||
      (nkeys == 0 && (!words_in || dshift >= 64 || drop >= 64)) ||
      (vals_out && (vals_bits < 1 || vals_bits > 63)) ||
      (next_key && (!next_out || next_bits < 1 || next_bits > 63 ||
                    (!next_wide && next_bits > 32))) ||
      count_shift < -1 || count_shift >= 64 ||
      (count_shift >= 0 && pass + 1 >= MAX_PASSES))
    return int(cudaErrorInvalidValue);
  a.count_shift = count_shift;
  a.words_in = words_in;
  a.in_wide = in_wide;
  a.rows_in = static_cast<const unsigned*>(rows_in);
  a.dshift = dshift;
  a.drop = drop;
  a.words_out = words_out;
  a.vals_out = vals_out;
  a.vals64 = vals64;
  a.vals_pad = vals_pad;
  a.vals_ones = vals_out ? (1ull << vals_bits) - 1ull : 0ull;
  a.next.key = next_key;
  a.next.orig64 = next_orig64;
  a.next.pad = next_pad;
  a.next.ones = next_key ? (1ull << next_bits) - 1ull : 0ull;
  a.next.wide = next_wide;
  a.next.out = next_out;
  a.rows_out = static_cast<unsigned*>(rows_out);
  a.pass = pass;
  a.n = n;
  a.scratch = static_cast<unsigned char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pass_dispatch<RADIX_BITS>(a, stage_wide, s);
}

}  // extern "C"
