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
// to left for succ/b). Three launches:
//   1. nb_tile_reduce: per tile of 4096 slots (staged in shared memory by
//      coalesced loads, with a one-slot halo each side), each thread folds
//      its 16 slots in both directions, then one thread per direction
//      folds the 256 thread states into the tile's state;
//   2. nb_tile_carry: one block scans the tile states (1024 threads fold
//      contiguous runs of tiles, one thread scans the 1024 run states),
//      giving each tile the state of everything before it (and after it);
//   3. nb_tile_emit: each tile repeats step 1's thread folds, scans the
//      thread states from the tile's carry, and each thread rescans its 16
//      slots from its own carry, writing the four outputs.
//
// What bounds it on this card: memory traffic, about 8 bytes read twice and
// 16 bytes written per slot; the serial folds over 256 thread states and
// over the tile states are short. Later work: one pass with a decoupled
// look-back.
//
// Plain C interface (bound with ctypes): each function returns
// cudaGetLastError() after its launches. Launches on the given stream,
// allocates nothing (the caller passes scratch of
// dense_neighbors_scratch_bytes(m) bytes), does not synchronise.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // 4096 slots
constexpr int CARRY_THREADS = 1024;

struct Seg {
  int v;               // min since the last reset
  int sa;              // sa of the last ref slot
  unsigned char f;     // a reset was seen
  unsigned char has;   // a ref slot was seen
};
static_assert(sizeof(Seg) == 12, "Seg layout");

__device__ __forceinline__ Seg seg_identity() {
  Seg s;
  s.v = INT_MAX;
  s.sa = -1;
  s.f = 0;
  s.has = 0;
  return s;
}

// x then y in scan order
__device__ __forceinline__ Seg combine(const Seg& x, const Seg& y) {
  Seg r;
  r.f = x.f | y.f;
  r.v = y.f ? y.v : min(x.v, y.v);
  r.has = x.has | y.has;
  r.sa = y.has ? y.sa : x.sa;
  return r;
}

struct Tile {
  int sa[TILE + 2];    // sa[base - 1 .. base + TILE]
  int ell[TILE + 1];   // ell[base .. base + TILE]
};

__device__ __forceinline__ void load_tile(Tile& t, const int* sa,
                                          const int* ell, int m,
                                          long long base) {
  for (int i = threadIdx.x; i < TILE + 2; i += THREADS) {
    const long long g = base - 1 + i;
    t.sa[i] = (g >= 0 && g < m) ? sa[g] : 0;
  }
  for (int i = threadIdx.x; i < TILE + 1; i += THREADS) {
    const long long g = base + i;
    t.ell[i] = g < m ? ell[g] : 0;
  }
  __syncthreads();
}

// slot r = base + i, forward element (pred / a)
__device__ __forceinline__ Seg fwd_elem(const Tile& t, int i, long long r,
                                        int n) {
  Seg e;
  e.f = (r == 0 || t.sa[i] < n) ? 1 : 0;
  e.v = t.ell[i];
  e.has = t.sa[i + 1] < n ? 1 : 0;
  e.sa = t.sa[i + 1];
  return e;
}

// slot r = base + i, backward element (succ / b)
__device__ __forceinline__ Seg bwd_elem(const Tile& t, int i, long long r,
                                        int n, int m) {
  Seg e;
  e.f = (r == m - 1 || t.sa[i + 2] < n) ? 1 : 0;
  e.v = r + 1 < m ? t.ell[i + 1] : 0;
  e.has = t.sa[i + 1] < n ? 1 : 0;
  e.sa = t.sa[i + 1];
  return e;
}

// this thread's fold of its ITEMS slots in both directions
__device__ __forceinline__ void thread_folds(const Tile& t, long long base,
                                             int n, int m, Seg* f, Seg* b) {
  const int i0 = threadIdx.x * ITEMS;
  Seg acc = seg_identity();
  for (int j = 0; j < ITEMS; ++j) {
    const long long r = base + i0 + j;
    if (r < m) acc = combine(acc, fwd_elem(t, i0 + j, r, n));
  }
  *f = acc;
  acc = seg_identity();
  for (int j = ITEMS - 1; j >= 0; --j) {
    const long long r = base + i0 + j;
    if (r < m) acc = combine(acc, bwd_elem(t, i0 + j, r, n, m));
  }
  *b = acc;
}

__global__ void nb_tile_reduce(const int* __restrict__ sa,
                               const int* __restrict__ ell, int n, int m,
                               Seg* __restrict__ agg_f,
                               Seg* __restrict__ agg_b) {
  __shared__ Tile t;
  __shared__ Seg s_f[THREADS], s_b[THREADS];
  const long long base = (long long)blockIdx.x * TILE;
  load_tile(t, sa, ell, m, base);
  thread_folds(t, base, n, m, &s_f[threadIdx.x], &s_b[threadIdx.x]);
  __syncthreads();
  if (threadIdx.x == 0) {
    Seg acc = seg_identity();
    for (int k = 0; k < THREADS; ++k) acc = combine(acc, s_f[k]);
    agg_f[blockIdx.x] = acc;
  } else if (threadIdx.x == 32) {
    Seg acc = seg_identity();
    for (int k = THREADS - 1; k >= 0; --k) acc = combine(acc, s_b[k]);
    agg_b[blockIdx.x] = acc;
  }
}

// exclusive carries: car_f[t] = fold of tiles < t, car_b[t] = fold of
// tiles > t (in backward scan order)
__global__ void nb_tile_carry(const Seg* __restrict__ agg_f,
                              const Seg* __restrict__ agg_b,
                              Seg* __restrict__ car_f,
                              Seg* __restrict__ car_b, int tiles) {
  __shared__ Seg s_f[CARRY_THREADS], s_b[CARRY_THREADS];
  const int per = (tiles + CARRY_THREADS - 1) / CARRY_THREADS;
  const int lo = min(tiles, (int)threadIdx.x * per);
  const int hi = min(tiles, lo + per);
  Seg f = seg_identity(), b = seg_identity();
  for (int k = lo; k < hi; ++k) f = combine(f, agg_f[k]);
  for (int k = hi - 1; k >= lo; --k) b = combine(b, agg_b[k]);
  s_f[threadIdx.x] = f;
  s_b[threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.x == 0) {
    Seg acc = seg_identity();
    for (int k = 0; k < CARRY_THREADS; ++k) {
      const Seg x = s_f[k];
      s_f[k] = acc;
      acc = combine(acc, x);
    }
  } else if (threadIdx.x == 32) {
    Seg acc = seg_identity();
    for (int k = CARRY_THREADS - 1; k >= 0; --k) {
      const Seg x = s_b[k];
      s_b[k] = acc;
      acc = combine(acc, x);
    }
  }
  __syncthreads();
  f = s_f[threadIdx.x];
  for (int k = lo; k < hi; ++k) {
    car_f[k] = f;
    f = combine(f, agg_f[k]);
  }
  b = s_b[threadIdx.x];
  for (int k = hi - 1; k >= lo; --k) {
    car_b[k] = b;
    b = combine(b, agg_b[k]);
  }
}

__global__ void nb_tile_emit(const int* __restrict__ sa,
                             const int* __restrict__ ell, int n, int m,
                             const Seg* __restrict__ car_f,
                             const Seg* __restrict__ car_b,
                             int* __restrict__ pred_pos,
                             int* __restrict__ succ_pos,
                             int* __restrict__ a_out,
                             int* __restrict__ b_out) {
  __shared__ Tile t;
  __shared__ Seg s_f[THREADS], s_b[THREADS];
  const long long base = (long long)blockIdx.x * TILE;
  load_tile(t, sa, ell, m, base);
  thread_folds(t, base, n, m, &s_f[threadIdx.x], &s_b[threadIdx.x]);
  __syncthreads();
  if (threadIdx.x == 0) {          // exclusive scan of the thread folds
    Seg acc = car_f[blockIdx.x];
    for (int k = 0; k < THREADS; ++k) {
      const Seg x = s_f[k];
      s_f[k] = acc;
      acc = combine(acc, x);
    }
  } else if (threadIdx.x == 32) {
    Seg acc = car_b[blockIdx.x];
    for (int k = THREADS - 1; k >= 0; --k) {
      const Seg x = s_b[k];
      s_b[k] = acc;
      acc = combine(acc, x);
    }
  }
  __syncthreads();
  const int i0 = threadIdx.x * ITEMS;
  Seg acc = s_f[threadIdx.x];
  for (int j = 0; j < ITEMS; ++j) {
    const long long r = base + i0 + j;
    if (r >= m) break;
    acc = combine(acc, fwd_elem(t, i0 + j, r, n));
    pred_pos[r] = acc.has ? acc.sa : -1;
    a_out[r] = acc.has ? acc.v : INT_MIN;
  }
  acc = s_b[threadIdx.x];
  for (int j = ITEMS - 1; j >= 0; --j) {
    const long long r = base + i0 + j;
    if (r >= m) continue;
    acc = combine(acc, bwd_elem(t, i0 + j, r, n, m));
    succ_pos[r] = acc.has ? acc.sa : -1;
    b_out[r] = acc.has ? acc.v : INT_MIN;
  }
}

}  // namespace

extern "C" long long dense_neighbors_scratch_bytes(int m) {
  const long long tiles = ((long long)m + TILE - 1) / TILE;
  return 4 * tiles * (long long)sizeof(Seg);
}

extern "C" int dense_neighbors_launch(const int* sa, const int* ell, int n,
                                      int m, void* scratch, int* pred_pos,
                                      int* succ_pos, int* a_out, int* b_out,
                                      void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)(((long long)m + TILE - 1) / TILE);
  Seg* agg_f = (Seg*)scratch;
  Seg* agg_b = agg_f + tiles;
  Seg* car_f = agg_b + tiles;
  Seg* car_b = car_f + tiles;
  nb_tile_reduce<<<tiles, THREADS, 0, s>>>(sa, ell, n, m, agg_f, agg_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nb_tile_carry<<<1, CARRY_THREADS, 0, s>>>(agg_f, agg_b, car_f, car_b,
                                            tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nb_tile_emit<<<tiles, THREADS, 0, s>>>(sa, ell, n, m, car_f, car_b,
                                         pred_pos, succ_pos, a_out, b_out);
  return (int)cudaGetLastError();
}
