// pair_expand — tail_good's expansion of (class, bucket) pairs into the
// rows of its join, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program that
// cmsbwt_tpu/engine/device_merge.py's tail_good_dev runs before its join
// sort (:359-423: a packed (5, p_pad) scatter and cummax fill of the class
// attributes, then the join keys), which the port ran as torch ops (a
// searchsorted of every pair over the classes' pair ranges, six gathers
// through an int64 class index, int64 temporaries of p_pad rows, four
// concatenations). Equal to
// cmsbwt_tpu_torch/engine/device_merge._pair_expand_reference element for
// element.
//
// The join has J = h_pad + p_pad rows: the class rows i < h_pad, then the
// pair rows. Class c holds the pairs [ends[c - 1], ends[c]) (ends: the
// inclusive sum of the classes' pair counts; ends[-1] = 0), pair p of
// class c meets bucket b = bucket_pos[pair_lo[c] + p - ends[c - 1]].
//   class row i (valid: i < n_classes):
//     key1 = pos[i], key2f = (key_k[i] * (n + 1) + isa_next[i]) << 1 | 1,
//     or INT_MAX and I64_BIG; srcidx = i; pay = slot_base[i];
//   pair row h_pad + p, p < total:
//     q_len = length[c] + pos[c] - b, q_k = smaller[c] ? q_len : 2n - q_len
//     (int32, wrapping as torch's int32 does);
//     key1 = b, key2f = (q_k * (n + 1) + isa_next[c]) << 1; srcidx = p;
//     pay = size[c]; src_cls[p] = c;
//   pad rows total <= p < p_pad: key1 INT_MAX, key2f I64_BIG, srcidx p,
//     and the last class with pairs (0 when there are none) as c.
//
// What bounds it on this card: bytes. It writes 24 bytes a pair (20 of the
// join row, 4 of src_cls) and reads 4 (the bucket position; the class
// attributes are shared by a class's pairs, ~13 at 500 Mchars): 12.6 GB,
// 3.8 ms at the 500 Mchar shape (P = 446 M pairs).
//
// Design: one block per 2048 pairs, each block's pairs fixed (a balanced
// expand over the pairs, whatever the classes' sizes). Its first thread
// finds the block's first class and last class by a binary search over
// ends (two searches a block, not one a pair). The block writes each
// class start that falls inside its range into a shared row of 2048 marks
// (the class ids are distinct and increasing, so a start is written once
// and no atomic is needed; classes with no pairs are skipped), then a
// block max-scan over the marks, each thread taking 8 consecutive ones,
// gives every pair its class. The rows are then written striped (pair p0
// + j * 256 + thread), so that each store of a warp covers 128 or 256
// consecutive bytes. Consecutive pairs of a class read consecutive
// bucket positions. The class rows take blocks of their own at the front
// of the grid.
//
// Plain C interface (bound with ctypes): pair_expand_launch launches on
// the given stream and returns the first cudaGetLastError() that is not
// 0; nothing allocates or synchronises.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;   // pairs (or class rows) a block
constexpr long long I64_BIG = 1ll << 62;

struct MaxOp {
  static __device__ __forceinline__ int identity() { return -1; }
  static __device__ __forceinline__ int combine(int x, int y) {
    return max(x, y);
  }
};

struct Args {
  const int* pos;          // per class, h_pad each
  const int* length;
  const int* key_k;
  const int* isa_next;
  const int* size;
  const unsigned char* smaller;
  const int* pair_lo;
  const int* ends;
  const int* slot_base;
  const int* bucket_pos;   // h_pad
  int h_pad, n_classes, total, p_pad;
  long long n;
  int class_blocks;
  int* key1;               // J = h_pad + p_pad rows each
  long long* key2f;
  int* srcidx;
  int* pay;
  int* src_cls;            // p_pad
};

// the first class whose pair range ends after pair v (ends ascending)
__device__ int class_of(const int* __restrict__ ends, int len, int v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) > v)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ int wrap32(long long v) {
  return int(static_cast<unsigned>(static_cast<unsigned long long>(v)));
}

__global__ void __launch_bounds__(THREADS) pair_expand_kernel(const Args a) {
  __shared__ int mark[TILE];
  __shared__ int wagg[33];
  __shared__ int s_lo, s_hi, s_last;
  const int tid = threadIdx.x;
  if (int(blockIdx.x) < a.class_blocks) {   // the class rows
    const long long i0 = (long long)blockIdx.x * TILE;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = i0 + j * THREADS + tid;
      if (i >= a.h_pad) break;
      const bool valid = i < a.n_classes;
      a.key1[i] = valid ? __ldg(a.pos + i) : INT_MAX;
      a.key2f[i] = valid ? ((long long)__ldg(a.key_k + i) * (a.n + 1) +
                            __ldg(a.isa_next + i)) << 1 | 1
                         : I64_BIG;
      a.srcidx[i] = int(i);
      a.pay[i] = __ldg(a.slot_base + i);
    }
    return;
  }
  const long long p0 = (long long)(blockIdx.x - a.class_blocks) * TILE;
  const long long pe = min(p0 + TILE, (long long)a.p_pad);
  const long long vend = min(pe, (long long)a.total);
  if (tid == 0) {
    s_last = a.total ? class_of(a.ends, a.h_pad, a.total - 1) : 0;
    if (p0 < vend) {
      s_lo = class_of(a.ends, a.h_pad, int(p0));
      s_hi = class_of(a.ends, a.h_pad, int(vend - 1));
    }
  }
  for (int i = tid; i < TILE; i += THREADS) mark[i] = -1;
  __syncthreads();
  if (p0 < vend) {   // block-uniform
    const int lo = s_lo, hi = s_hi;
    if (tid == 0) mark[0] = lo;
    // a class after lo with pairs starts inside (p0, vend)
    for (int c = lo + 1 + tid; c <= hi; c += THREADS) {
      const int off = __ldg(a.ends + c - 1);
      const long long at = off - p0;
      if (__ldg(a.ends + c) > off && at > 0 && at < TILE) mark[at] = c;
    }
    __syncthreads();
    int v[ITEMS], m = -1;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      v[j] = mark[tid * ITEMS + j];
      m = max(m, v[j]);
    }
    int tot;
    int run = block_scan<false, MaxOp>(m, -1, wagg, &tot);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      run = max(run, v[j]);
      mark[tid * ITEMS + j] = run;
    }
    __syncthreads();
  }
  const int last = s_last;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * THREADS + tid;
    const long long p = p0 + i;
    if (p >= pe) break;
    const long long row = a.h_pad + p;
    int c = last, k1 = INT_MAX;
    long long k2 = I64_BIG;
    if (p < a.total) {
      c = mark[i];
      const int off = c ? __ldg(a.ends + c - 1) : 0;
      // int32 throughout, as the plain version's index arithmetic
      const int d = int(unsigned(__ldg(a.pair_lo + c)) - unsigned(off));
      const int bi = min(max(wrap32(p + d), 0), a.h_pad - 1);
      k1 = __ldg(a.bucket_pos + bi);
      const int q_len = wrap32((long long)__ldg(a.length + c) +
                               __ldg(a.pos + c) - k1);
      const int q_k = __ldg(a.smaller + c)
                          ? q_len
                          : int(unsigned(2 * a.n) - unsigned(q_len));
      k2 = ((long long)q_k * (a.n + 1) + __ldg(a.isa_next + c)) << 1;
    }
    a.key1[row] = k1;
    a.key2f[row] = k2;
    a.srcidx[row] = int(p);
    a.pay[row] = __ldg(a.size + c);
    a.src_cls[p] = c;
  }
}

}  // namespace

extern "C" {

// pos, length, key_k, isa_next, size, pair_lo, ends, slot_base,
// bucket_pos: int32[h_pad]; smaller: bool[h_pad]; key1, srcidx, pay:
// int32[h_pad + p_pad]; key2f: int64[h_pad + p_pad]; src_cls:
// int32[p_pad]; 0 <= n_classes <= h_pad; 0 <= total < p_pad <= 2^30;
// 2n(n + 1) < 2^61
int pair_expand_launch(const void* pos, const void* length,
                       const void* key_k, const void* isa_next,
                       const void* size, const void* smaller,
                       const void* pair_lo, const void* ends,
                       const void* slot_base, const void* bucket_pos,
                       int h_pad, int n_classes,
                       int total, int p_pad, long long n, void* key1,
                       void* key2f, void* srcidx, void* pay, void* src_cls,
                       void* stream) {
  if (h_pad < 1 || n_classes < 0 || n_classes > h_pad || total < 0 ||
      total >= p_pad || p_pad > (1 << 30) || n < 1 || n >= (1ll << 30))
    return int(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const int*>(pos);
  a.length = static_cast<const int*>(length);
  a.key_k = static_cast<const int*>(key_k);
  a.isa_next = static_cast<const int*>(isa_next);
  a.size = static_cast<const int*>(size);
  a.smaller = static_cast<const unsigned char*>(smaller);
  a.pair_lo = static_cast<const int*>(pair_lo);
  a.ends = static_cast<const int*>(ends);
  a.slot_base = static_cast<const int*>(slot_base);
  a.bucket_pos = static_cast<const int*>(bucket_pos);
  a.h_pad = h_pad;
  a.n_classes = n_classes;
  a.total = total;
  a.p_pad = p_pad;
  a.n = n;
  a.class_blocks = (h_pad + TILE - 1) / TILE;
  a.key1 = static_cast<int*>(key1);
  a.key2f = static_cast<long long*>(key2f);
  a.srcidx = static_cast<int*>(srcidx);
  a.pay = static_cast<int*>(pay);
  a.src_cls = static_cast<int*>(src_cls);
  const int blocks = a.class_blocks + (p_pad + TILE - 1) / TILE;
  pair_expand_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
