// dense_neighbors — for every joint SA slot, the nearest reference slot
// below and above and the segmented LCP minima to each, as a tiled scan in
// both directions for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports the XLA program _neighbors
// (cmsbwt_tpu/ops/ms_dense.py:366-386, with _seg_min_scan :332 and
// _fill_ref_value :350), four running min/max scans over all m slots that
// torch would run as 1-D cummin/cummax in a single block. For slot r, with
// is_ref[r] = sa[r] < n:
//   pred_pos[r] = sa of the last ref slot <= r, else -1;
//   a[r]        = min(ell[s..r]), s the last slot <= r with s == 0 or
//                 is_ref[s-1] (reset after each ref slot); INT_MIN if no
//                 ref slot <= r;
//   succ_pos[r] = sa of the first ref slot >= r, else -1;
//   b[r]        = min(ell_s[r..e]), ell_s[j] = ell[j+1] (0 at m-1), e the
//                 first slot >= r with e == m-1 or is_ref[e+1]; INT_MIN if
//                 no ref slot >= r.
// Equal to neighbors_reference (cmsbwt_tpu_torch/ops/ms_dense.py) element
// for element.
//
// Design. Both directions are one associative scan over the state
// (reset seen, min since the last reset, ref seen, sa of the last ref):
//   combine(x, y) = (x.f | y.f, y.f ? y.v : min(x.v, y.v),
//                    x.has | y.has, y.has ? y.sa : x.sa)
// with y the later element in scan order (left to right for pred/a, right
// to left for succ/b), carried as three 32-bit words (v, sa, flags). Tiles
// of 4096 slots, 512 threads of 8 consecutive slots each. Three launches:
//   1. nb_tile_reduce: each tile's aggregate in both directions;
//   2. nb_tile_carry: one block of 256 threads per chunk of 4096 tiles (16
//      per thread) and direction scans the chunk's tile aggregates, giving
//      each tile the fold of the tiles before it (forward) or after it
//      (backward) within its chunk, and the chunk its aggregate; the block
//      that finishes last (an atomic count, no waiting) scans the chunk
//      aggregates (at most 128 per direction for m < 2^31, 4 per lane of
//      one warp) into each chunk's exclusive prefix;
//   3. nb_tile_emit: each tile's carry is its chunk's prefix combined with
//      its carry within the chunk; the tile scans again from its carries
//      and writes the four outputs.
// Inside every scan: a thread folds its 8 items (carry: 16) in registers;
// a warp scans its 32 thread states with 5 __shfl_up_sync (forward) or
// __shfl_down_sync (backward) steps; warp 0 scans the block's warp
// aggregates the same way. No thread folds more than 16 states in series,
// and no loop runs over tile or thread states.
//
// Memory. Each thread loads its 8 consecutive slots of sa and of ell
// straight into registers as two 16-byte vectors each (the two loads of a
// warp read 1 KB, every sector whole; a thread that reaches past m loads
// by 4 bytes). One-slot halos come from the neighbouring lane by shuffle,
// and across warps and tiles from device memory (a cached 4-byte load by
// lane 0 or 31). So no shared memory and no barrier stand between the
// loads and the folds. The outputs are staged in two shared arrays (pred/a,
// then succ/b) and written striped by 16-byte stores, so each warp store
// instruction covers 512 contiguous bytes. The shared arrays are padded by
// one word per 32 (index i at i + i/32): the lanes' writes of item j (word
// 8*lane + j + lane/4), the vector lanes' reads (4*lane + c + lane/8) and
// the carry's 16-item reads and writes (16*lane + j + lane/2) each fall on
// 32 distinct banks. sa, ell and the outputs must be 16-byte aligned (the
// wrapper checks). Occupancy: the reduce runs three blocks of 512 threads
// per SM (at most 42 registers), the emit two (64 registers), so while one
// block scans another's loads are in flight.
//
// What bounds it on this card: bytes. The function needs 24 B per slot
// (sa and ell read once, four int32 outputs written once); this design
// moves 32 B per slot (sa and ell are read by the reduce and again by the
// emit pass; the tile aggregates and carries add about 0.03 B per slot),
// the least for a scan in two directions: a single pass with a decoupled
// look-back can look back but not ahead, so it reads sa and ell once per
// direction all the same.
//
// Plain C interface (bound with ctypes): each function returns
// cudaGetLastError() after its launches. Launches on the given stream,
// allocates nothing (the caller passes scratch of
// dense_neighbors_scratch_bytes(m) bytes), does not synchronise.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // 4096 slots
constexpr int VECS = TILE / 4 / THREADS;  // int4 per thread per array
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_WARPS = CARRY_THREADS / 32;
constexpr int CARRY_ITEMS = 16;
constexpr int CHUNK = CARRY_THREADS * CARRY_ITEMS;  // 4096 tiles
constexpr int CHUNKS_PER_LANE = 4;  // chunk aggregates per lane (prefixes)
constexpr int MAX_CHUNKS = 32 * CHUNKS_PER_LANE;
static_assert((long long)MAX_CHUNKS * CHUNK * TILE >= (1LL << 31),
              "the chunk fold covers every m < 2^31");
constexpr unsigned FULL = 0xffffffffu;
constexpr int F_RESET = 1, F_HAS = 2;

struct Seg {
  int v;    // min since the last reset
  int sa;   // sa of the last ref slot
  int fl;   // F_RESET: a reset was seen; F_HAS: a ref slot was seen
};
static_assert(sizeof(Seg) == 12, "Seg layout");

__device__ __forceinline__ Seg seg_identity() { return Seg{INT_MAX, -1, 0}; }

// x then y in scan order
__device__ __forceinline__ Seg combine(const Seg& x, const Seg& y) {
  Seg r;
  r.fl = x.fl | y.fl;
  r.v = (y.fl & F_RESET) ? y.v : min(x.v, y.v);
  r.sa = (y.fl & F_HAS) ? y.sa : x.sa;
  return r;
}

// padded shared-memory index: one spare word per 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
constexpr int TILE_PAD = TILE + TILE / 32;     // padded array lengths
constexpr int CHUNK_PAD = CHUNK + CHUNK / 32;

template <bool BWD>
__device__ __forceinline__ Seg shfl(const Seg& x, int d) {
  Seg y;
  if (BWD) {
    y.v = __shfl_down_sync(FULL, x.v, d);
    y.sa = __shfl_down_sync(FULL, x.sa, d);
    y.fl = __shfl_down_sync(FULL, x.fl, d);
  } else {
    y.v = __shfl_up_sync(FULL, x.v, d);
    y.sa = __shfl_up_sync(FULL, x.sa, d);
    y.fl = __shfl_up_sync(FULL, x.fl, d);
  }
  return y;
}

// Warp scan of the lanes' states in scan order (lane 0 first forward,
// lane 31 first backward): returns the exclusive prefix of this lane and
// sets *total to the fold of all 32 lanes.
template <bool BWD>
__device__ __forceinline__ Seg warp_scan(Seg x, Seg* total) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg y = shfl<BWD>(x, d);
    if (BWD ? lane + d < 32 : lane >= d) x = combine(y, x);
  }
  Seg ex = shfl<BWD>(x, 1);
  if (lane == (BWD ? 31 : 0)) ex = seg_identity();
  total->v = __shfl_sync(FULL, x.v, BWD ? 0 : 31);
  total->sa = __shfl_sync(FULL, x.sa, BWD ? 0 : 31);
  total->fl = __shfl_sync(FULL, x.fl, BWD ? 0 : 31);
  return ex;
}

// Block scan of one state per thread in scan order: returns this
// thread's exclusive prefix, starting from ``carry``; *total is the fold
// of the whole block (without the carry). ``wagg`` holds ``nwarps`` states
// of shared memory; nwarps <= 32.
template <bool BWD>
__device__ __forceinline__ Seg block_scan(Seg x, const Seg& carry,
                                          Seg* wagg, int nwarps,
                                          Seg* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg wtot;
  const Seg ex = warp_scan<BWD>(x, &wtot);
  if (lane == 0) wagg[warp] = wtot;
  __syncthreads();
  if (warp == 0) {
    Seg w = lane < nwarps ? wagg[lane] : seg_identity();
    Seg all;
    // backward, the identity lanes past nwarps come first: no effect
    Seg wex = warp_scan<BWD>(w, &all);
    if (lane < nwarps) wagg[lane] = combine(carry, wex);
    if (lane == 0) wagg[nwarps] = all;
  }
  __syncthreads();
  const Seg r = combine(wagg[warp], ex);
  *total = wagg[nwarps];
  __syncthreads();   // wagg is reused by the next scan
  return r;
}

// This thread's 8 slots of the tile at ``base`` (slot r = base + 8*t + j)
// with their halos.
struct Items {
  int sa[ITEMS];
  int ell[ITEMS];
  int sa_prev;    // sa[r_0 - 1]
  int sa_next;    // sa[r_7 + 1]
  int ell_next;   // ell[r_7 + 1]
};

__device__ __forceinline__ int4 get4(const int* s, int v) {
  return make_int4(s[pad(4 * v)], s[pad(4 * v + 1)], s[pad(4 * v + 2)],
                   s[pad(4 * v + 3)]);
}

// this thread's 8 slots r = base + 8*t + j and their halos, from device
// memory into registers
__device__ __forceinline__ Items load_items(const int* __restrict__ sa,
                                            const int* __restrict__ ell,
                                            long long base, int lim, int m) {
  Items it;
  const int t = threadIdx.x, lane = t & 31, i0 = t * ITEMS;
  const long long r0 = base + i0;
  if (i0 + ITEMS <= lim) {
    const int4* sa4 = reinterpret_cast<const int4*>(sa + r0);
    const int4* ell4 = reinterpret_cast<const int4*>(ell + r0);
    const int4 s0 = __ldg(sa4), s1 = __ldg(sa4 + 1);
    const int4 e0 = __ldg(ell4), e1 = __ldg(ell4 + 1);
    it.sa[0] = s0.x; it.sa[1] = s0.y; it.sa[2] = s0.z; it.sa[3] = s0.w;
    it.sa[4] = s1.x; it.sa[5] = s1.y; it.sa[6] = s1.z; it.sa[7] = s1.w;
    it.ell[0] = e0.x; it.ell[1] = e0.y; it.ell[2] = e0.z; it.ell[3] = e0.w;
    it.ell[4] = e1.x; it.ell[5] = e1.y; it.ell[6] = e1.z; it.ell[7] = e1.w;
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool in = i0 + j < lim;
      it.sa[j] = in ? __ldg(sa + r0 + j) : 0;
      it.ell[j] = in ? __ldg(ell + r0 + j) : 0;
    }
  }
  it.sa_prev = __shfl_up_sync(FULL, it.sa[ITEMS - 1], 1);
  it.sa_next = __shfl_down_sync(FULL, it.sa[0], 1);
  it.ell_next = __shfl_down_sync(FULL, it.ell[0], 1);
  if (lane == 0 && r0 > 0) it.sa_prev = __ldg(sa + r0 - 1);
  if (lane == 31 && r0 + ITEMS < m) {
    it.sa_next = __ldg(sa + r0 + ITEMS);
    it.ell_next = __ldg(ell + r0 + ITEMS);
  }
  return it;
}

// element j of this thread; ``last`` is the tile index of slot m - 1
// (-1 when it lies beyond the tile)
template <bool BWD>
__device__ __forceinline__ Seg elem(const Items& it, int j, int i, int n,
                                    long long base, int last) {
  Seg e;
  e.sa = it.sa[j];
  const int has = it.sa[j] < n ? F_HAS : 0;
  if (BWD) {
    const int sn = j + 1 < ITEMS ? it.sa[j + 1] : it.sa_next;
    const int en = j + 1 < ITEMS ? it.ell[j + 1] : it.ell_next;
    const bool end = i == last;
    e.fl = has | ((end || sn < n) ? F_RESET : 0);
    e.v = end ? 0 : en;
  } else {
    const int sp = j > 0 ? it.sa[j - 1] : it.sa_prev;
    e.fl = has | (((base == 0 && i == 0) || sp < n) ? F_RESET : 0);
    e.v = it.ell[j];
  }
  return e;
}

template <bool BWD>
__device__ __forceinline__ Seg thread_fold(const Items& it, int n,
                                           long long base, int lim,
                                           int last) {
  const int i0 = threadIdx.x * ITEMS;
  Seg acc = seg_identity();
#pragma unroll
  for (int jj = 0; jj < ITEMS; ++jj) {
    const int j = BWD ? ITEMS - 1 - jj : jj;
    if (i0 + j < lim) acc = combine(acc, elem<BWD>(it, j, i0 + j, n, base,
                                                   last));
  }
  return acc;
}

__device__ __forceinline__ void tile_geometry(int m, long long* base,
                                              int* lim, int* last) {
  *base = (long long)blockIdx.x * TILE;
  const long long rest = (long long)m - *base;
  *lim = (int)(rest < TILE ? rest : TILE);
  *last = rest - 1 < TILE ? (int)(rest - 1) : -1;
}

__global__ void __launch_bounds__(THREADS, 3)
nb_tile_reduce(const int* __restrict__ sa, const int* __restrict__ ell,
               int n, int m, Seg* __restrict__ agg_f,
               Seg* __restrict__ agg_b) {
  __shared__ Seg wagg[WARPS + 1];
  long long base;
  int lim, last;
  tile_geometry(m, &base, &lim, &last);
  const Items it = load_items(sa, ell, base, lim, m);
  Seg tot;
  block_scan<false>(thread_fold<false>(it, n, base, lim, last),
                    seg_identity(), wagg, WARPS, &tot);
  if (threadIdx.x == 0) agg_f[blockIdx.x] = tot;
  block_scan<true>(thread_fold<true>(it, n, base, lim, last),
                   seg_identity(), wagg, WARPS, &tot);
  if (threadIdx.x == 0) agg_b[blockIdx.x] = tot;
}

// One chunk of one direction of the carry (block (c, dir)): car[t] = fold
// of agg over the tiles of chunk c before t in scan order; cagg[c] = the
// chunk's fold. The chunk's aggregates are staged in shared memory.
template <bool BWD>
__device__ void carry_chunk(const Seg* __restrict__ agg,
                            Seg* __restrict__ car, Seg* __restrict__ cagg,
                            int tiles, int* v_s, int* sa_s, int* fl_s,
                            Seg* wagg) {
  const int t = threadIdx.x, i0 = t * CARRY_ITEMS;
  const long long lo = (long long)blockIdx.x * CHUNK;
#pragma unroll
  for (int k = 0; k < CARRY_ITEMS; ++k) {
    const int i = k * CARRY_THREADS + t;
    const Seg x = lo + i < tiles ? agg[lo + i] : seg_identity();
    v_s[pad(i)] = x.v;
    sa_s[pad(i)] = x.sa;
    fl_s[pad(i)] = x.fl;
  }
  __syncthreads();
  Seg acc = seg_identity();
#pragma unroll
  for (int jj = 0; jj < CARRY_ITEMS; ++jj) {
    const int j = BWD ? CARRY_ITEMS - 1 - jj : jj;
    acc = combine(acc, Seg{v_s[pad(i0 + j)], sa_s[pad(i0 + j)],
                           fl_s[pad(i0 + j)]});
  }
  Seg tot;
  acc = block_scan<BWD>(acc, seg_identity(), wagg, CARRY_WARPS, &tot);
#pragma unroll
  for (int jj = 0; jj < CARRY_ITEMS; ++jj) {   // in place: own items
    const int j = BWD ? CARRY_ITEMS - 1 - jj : jj;
    const Seg x{v_s[pad(i0 + j)], sa_s[pad(i0 + j)], fl_s[pad(i0 + j)]};
    v_s[pad(i0 + j)] = acc.v;
    sa_s[pad(i0 + j)] = acc.sa;
    fl_s[pad(i0 + j)] = acc.fl;
    acc = combine(acc, x);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CARRY_ITEMS; ++k) {
    const int i = k * CARRY_THREADS + t;
    if (lo + i < tiles) car[lo + i] = Seg{v_s[pad(i)], sa_s[pad(i)],
                                          fl_s[pad(i)]};
  }
  if (t == 0) cagg[blockIdx.x] = tot;
}

// by one warp of the last carry block: cpre[c] = fold of the chunk
// aggregates before chunk c in scan order (forward: chunks < c; backward:
// chunks > c). Lane l holds chunks [4l, 4l + 4). The aggregates were
// written by other blocks: read past L1.
template <bool BWD>
__device__ __forceinline__ void chunk_prefixes(const Seg* cagg, Seg* cpre,
                                               int nch) {
  const int lane = threadIdx.x & 31;
  Seg x[CHUNKS_PER_LANE];
  Seg acc = seg_identity();
#pragma unroll
  for (int jj = 0; jj < CHUNKS_PER_LANE; ++jj) {
    const int j = BWD ? CHUNKS_PER_LANE - 1 - jj : jj;
    const int k = lane * CHUNKS_PER_LANE + j;
    const int* w = reinterpret_cast<const int*>(cagg + k);
    x[j] = k < nch ? Seg{__ldcg(w), __ldcg(w + 1), __ldcg(w + 2)}
                   : seg_identity();
    acc = combine(acc, x[j]);
  }
  Seg tot;
  acc = warp_scan<BWD>(acc, &tot);
#pragma unroll
  for (int jj = 0; jj < CHUNKS_PER_LANE; ++jj) {
    const int j = BWD ? CHUNKS_PER_LANE - 1 - jj : jj;
    const int k = lane * CHUNKS_PER_LANE + j;
    if (k < nch) cpre[k] = acc;
    acc = combine(acc, x[j]);
  }
}

// exclusive carries within each chunk: car_f[t] = fold of the chunk's
// tiles < t (blockIdx.y 0), car_b[t] = fold of the chunk's tiles > t in
// backward scan order (blockIdx.y 1); cagg_f / cagg_b the chunks' folds,
// cpre_f / cpre_b the chunks' exclusive prefixes; *done counts finished
// blocks (zero at launch)
__global__ void __launch_bounds__(CARRY_THREADS)
nb_tile_carry(const Seg* __restrict__ agg_f, const Seg* __restrict__ agg_b,
              Seg* __restrict__ car_f, Seg* __restrict__ car_b, Seg* cagg_f,
              Seg* cagg_b, Seg* __restrict__ cpre_f,
              Seg* __restrict__ cpre_b, unsigned* done, int tiles) {
  extern __shared__ int smem[];
  int* v_s = smem;
  int* sa_s = v_s + CHUNK_PAD;
  int* fl_s = sa_s + CHUNK_PAD;
  __shared__ Seg wagg[CARRY_WARPS + 1];
  __shared__ bool last;
  if (blockIdx.y == 0)
    carry_chunk<false>(agg_f, car_f, cagg_f, tiles, v_s, sa_s, fl_s, wagg);
  else
    carry_chunk<true>(agg_b, car_b, cagg_b, tiles, v_s, sa_s, fl_s, wagg);
  if (threadIdx.x == 0) {   // the thread that wrote this block's cagg
    __threadfence();
    last = atomicAdd(done, 1u) == 2 * gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < 32)
    chunk_prefixes<false>(cagg_f, cpre_f, gridDim.x);
  else if (threadIdx.x < 64)
    chunk_prefixes<true>(cagg_b, cpre_b, gridDim.x);
}
constexpr int CARRY_SMEM = 3 * CHUNK_PAD * (int)sizeof(int);

// write two outputs staged in the shared arrays, striped (full tiles by
// 16-byte stores: each warp store instruction covers 512 contiguous bytes)
__device__ __forceinline__ void store_two(int* o1_s, int* o2_s,
                                          int* __restrict__ o1,
                                          int* __restrict__ o2,
                                          long long base, int lim) {
  __syncthreads();
  if (lim == TILE) {
    int4* o14 = reinterpret_cast<int4*>(o1 + base);
    int4* o24 = reinterpret_cast<int4*>(o2 + base);
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int v = k * THREADS + threadIdx.x;
      o14[v] = get4(o1_s, v);
      o24[v] = get4(o2_s, v);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < lim) {
        o1[base + i] = o1_s[pad(i)];
        o2[base + i] = o2_s[pad(i)];
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2)
nb_tile_emit(const int* __restrict__ sa, const int* __restrict__ ell, int n,
             int m, const Seg* __restrict__ car_f,
             const Seg* __restrict__ car_b, const Seg* __restrict__ cpre_f,
             const Seg* __restrict__ cpre_b, int* __restrict__ pred_pos,
             int* __restrict__ succ_pos, int* __restrict__ a_out,
             int* __restrict__ b_out) {
  __shared__ int o1_s[TILE_PAD], o2_s[TILE_PAD];
  __shared__ Seg wagg[WARPS + 1];
  long long base;
  int lim, last;
  tile_geometry(m, &base, &lim, &last);
  const Items it = load_items(sa, ell, base, lim, m);
  const int i0 = threadIdx.x * ITEMS, c = blockIdx.x / CHUNK;
  Seg tot;
  Seg fwd = block_scan<false>(thread_fold<false>(it, n, base, lim, last),
                              combine(cpre_f[c], car_f[blockIdx.x]), wagg,
                              WARPS, &tot);
  Seg bwd = block_scan<true>(thread_fold<true>(it, n, base, lim, last),
                             combine(cpre_b[c], car_b[blockIdx.x]), wagg,
                             WARPS, &tot);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (i0 + j < lim)
      fwd = combine(fwd, elem<false>(it, j, i0 + j, n, base, last));
    const bool has = fwd.fl & F_HAS;
    o1_s[pad(i0 + j)] = has ? fwd.sa : -1;
    o2_s[pad(i0 + j)] = has ? fwd.v : INT_MIN;
  }
  store_two(o1_s, o2_s, pred_pos, a_out, base, lim);
#pragma unroll
  for (int jj = 0; jj < ITEMS; ++jj) {
    const int j = ITEMS - 1 - jj;
    if (i0 + j < lim)
      bwd = combine(bwd, elem<true>(it, j, i0 + j, n, base, last));
    const bool has = bwd.fl & F_HAS;
    o1_s[pad(i0 + j)] = has ? bwd.sa : -1;
    o2_s[pad(i0 + j)] = has ? bwd.v : INT_MIN;
  }
  store_two(o1_s, o2_s, succ_pos, b_out, base, lim);
}

}  // namespace

extern "C" long long dense_neighbors_scratch_bytes(int m) {
  const long long tiles = ((long long)m + TILE - 1) / TILE;
  const long long chunks = (tiles + CHUNK - 1) / CHUNK;
  return (4 * tiles + 4 * chunks) * (long long)sizeof(Seg) + 4;
}

extern "C" int dense_neighbors_launch(const int* sa, const int* ell, int n,
                                      int m, void* scratch, int* pred_pos,
                                      int* succ_pos, int* a_out, int* b_out,
                                      void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)(((long long)m + TILE - 1) / TILE);
  const int nch = (tiles + CHUNK - 1) / CHUNK;
  Seg* agg_f = (Seg*)scratch;
  Seg* agg_b = agg_f + tiles;
  Seg* car_f = agg_b + tiles;
  Seg* car_b = car_f + tiles;
  Seg* cagg_f = car_b + tiles;
  Seg* cagg_b = cagg_f + nch;
  Seg* cpre_f = cagg_b + nch;
  Seg* cpre_b = cpre_f + nch;
  unsigned* done = (unsigned*)(cpre_b + nch);
  cudaError_t err = cudaFuncSetAttribute(
      nb_tile_carry, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CARRY_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(done, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  nb_tile_reduce<<<tiles, THREADS, 0, s>>>(sa, ell, n, m, agg_f, agg_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nb_tile_carry<<<dim3(nch, 2), CARRY_THREADS, CARRY_SMEM, s>>>(
      agg_f, agg_b, car_f, car_b, cagg_f, cagg_b, cpre_f, cpre_b, done,
      tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nb_tile_emit<<<tiles, THREADS, 0, s>>>(sa, ell, n, m, car_f, car_b, cpre_f,
                                         cpre_b, pred_pos, succ_pos, a_out,
                                         b_out);
  return (int)cudaGetLastError();
}
