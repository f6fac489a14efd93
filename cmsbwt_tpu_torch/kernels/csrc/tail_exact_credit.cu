// tail_exact_credit — the exact-key (counterBad) path's credit pass after
// its join's sort and fill, fused, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program of
// tail_exact_dev after its reverse fill
// (cmsbwt_tpu/engine/device_merge.py:543-559): the sort that routes each
// query's found slot back to the query, the in-class test, the spill test
// and the two scatter-adds into the counter. Over J sorted join rows
// (flag int32: 1 for a target slot, 0 for a query; i int32: the slot or
// the query's id; tgt int32: the reverse running min of the targets'
// slots, h_pad past the last), per query row with id q:
//   p      = clamp(tgt, 0, h_pad - 1), d = dst[q];
//   inb    = q < tot and cls_of_slot[p] == d;
//   counter[inb ? p : h_pad + 1] += 1;
//   counter[spill ? slot_base[clamp(d + 1)] : h_pad + 1] += 1, spill = q <
//     tot and not inb and d + 1 < cls_hi[clamp(bucket_of_class[d])];
// a slot past counter_len is dropped. Equal to _exact_credit_reference
// (cmsbwt_tpu_torch/engine/device_merge.py) element for element.
//
// Design: one launch, 256 threads of 8 consecutive rows each. The rows'
// found slots never decrease (tgt is a suffix minimum), so a thread adds
// each run of one slot with one atomic; the dump slot h_pad + 1, which
// nearly every query touches once, takes one atomic per block after a
// block reduction. The gathers (dst by query id, the class of a slot, the
// bucket's last class, the next class's base slot) are the pass's
// irregular reads.
//
// What bounds it on this card: bytes. The function reads 12 B per row and
// gathers about 20 B per query; it writes the counter.
//
// Plain C interface (bound with ctypes): tail_exact_credit_launch returns
// cudaGetLastError() after its launch; it launches on the given stream,
// allocates nothing, does not synchronise, and adds into ``counter``.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // 2048 rows

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// adds ``n`` at ``slot`` (dropped past counter_len)
__device__ __forceinline__ void add_at(int* counter, int counter_len,
                                       int slot, int n) {
  if (n != 0 && slot >= 0 && slot < counter_len)
    atomicAdd(counter + slot, n);
}

__global__ void __launch_bounds__(THREADS)
    tec_emit(const int* __restrict__ flag, const int* __restrict__ is,
             const int* __restrict__ tgt, int J, bool vec,
             const int* __restrict__ dst, int tot,
             const int* __restrict__ cls_of_slot,
             const int* __restrict__ slot_base,
             const int* __restrict__ cls_hi,
             const int* __restrict__ bucket_of_class, int h_pad,
             int* __restrict__ counter, int counter_len) {
  __shared__ int red[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * TILE
                       + (long long)threadIdx.x * ITEMS;
  int f[ITEMS], q[ITEMS], t[ITEMS];
  load_items<ITEMS>(flag, r0, J, vec, 1, f);
  load_items<ITEMS>(is, r0, J, vec, 0, q);
  load_items<ITEMS>(tgt, r0, J, vec, 0, t);
  const int dump = h_pad + 1;
  int dumped = 0;
  int run_slot = -1, run_n = 0;  // the current run of one found slot
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (r0 + j >= J || f[j] != 0) continue;
    const int p = clampi(t[j], 0, h_pad - 1);
    const bool valid = q[j] < tot;
    const int d = valid ? __ldg(dst + q[j]) : 0;
    const bool inb = valid && __ldg(cls_of_slot + p) == d;
    if (inb) {
      if (p != run_slot) {
        add_at(counter, counter_len, run_slot, run_n);
        run_slot = p;
        run_n = 0;
      }
      ++run_n;
    } else {
      ++dumped;
    }
    bool spill = false;
    if (valid && !inb) {
      const int b = clampi(__ldg(bucket_of_class + clampi(d, 0, h_pad - 1)),
                           0, h_pad - 1);
      spill = d + 1 < __ldg(cls_hi + b);
    }
    if (spill)
      add_at(counter, counter_len,
             __ldg(slot_base + clampi(d + 1, 0, h_pad - 1)), 1);
    else
      ++dumped;
  }
  add_at(counter, counter_len, run_slot, run_n);
  // the dump slot: one atomic per block
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    dumped += __shfl_down_sync(FULL, dumped, d);
  if (lane == 0) red[warp] = dumped;
  __syncthreads();
  if (threadIdx.x == 0) {
    int all = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) all += red[k];
    add_at(counter, counter_len, dump, all);
  }
}

}  // namespace

extern "C" {

// flag, is, tgt: int32[J]; dst: int32 by query id; cls_of_slot,
// slot_base, cls_hi, bucket_of_class: int32[h_pad] at least; counter:
// int32[counter_len], added into; 1 <= J < INT_MAX, h_pad >= 1
int tail_exact_credit_launch(const int* flag, const int* is, const int* tgt,
                             int J, const int* dst, int tot,
                             const int* cls_of_slot, const int* slot_base,
                             const int* cls_hi, const int* bucket_of_class,
                             int h_pad, int* counter, int counter_len,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J < 1 || J == INT_MAX || h_pad < 1) return int(cudaErrorInvalidValue);
  const int tiles = (J + TILE - 1) / TILE;
  const bool vec = aligned16(flag) && aligned16(is) && aligned16(tgt);
  tec_emit<<<tiles, THREADS, 0, s>>>(flag, is, tgt, J, vec, dst, tot,
                                      cls_of_slot, slot_base, cls_hi,
                                      bucket_of_class, h_pad, counter,
                                      counter_len);
  return int(cudaGetLastError());
}

}  // extern "C"
