// lcp_lift — the LCP of each irreducible SA-adjacent pair of the joint
// string, by binary lifting through the rank history, as one CUDA kernel
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports the XLA programs of the dense route's
// lift, lift_pairs (cmsbwt_tpu/ops/joint_sa.py:429-460) with its seed-pack
// tail pack_lcp_at / byte8_lcp / nib16_lcp (:378-426), which the JAX
// package runs on one device as a host loop of one dispatch per level
// (ops/ms_dense.py:288-329 _lift_orchestrated). Its output equals
// lift_pairs pair for pair.
//
// Design. One thread per pair runs the whole descent in one launch:
//   1. h = 2^(lv-1) when the pair is valid and lv > sl (the pair's boundary
//      split at level lv, so its lcp is at least that), else 0;
//   2. for k from the top level down to sl: if ai+h and bi+h are both < m
//      and their windows of 2^k have equal rank (hist[k - sl]), h += 2^k;
//   3. the last sub-seed bits from the seed packs at the clipped positions
//      ai+h, bi+h: a byte-8 compare (one pack row) or two nibble-16
//      compares (two rows; the second counts only when the first matches
//      all 16).
// The top level is the pair's own lv - 2 when lv >= sl: a pair's lcp lies
// in [2^(lv-1), 2^lv), so every test above its range fails, exactly as in
// the shared loop from max(lv) - 2 of lift_pairs. Rows with lv below the
// seed level (rows that are not irreducible carry lv = 0) run the shared
// loop from lmax - 2, as lift_pairs runs them, so the kernel equals
// lift_pairs on any rows. Invalid rows (ai or bi >= m) give 0. The dense
// scan hands it only the irreducible rows, sorted by level, deepest first,
// so neighbouring threads run the same number of levels.
//
// Loads: ai, bi, lv read and h written coalesced; the history and the
// packs through the read-only path. The two gathers of a level do not
// depend on each other and issue together; the chain runs from level to
// level. The wide seed's second nibble row is gathered only after the
// first row matched all 16 symbols: issuing its two gathers with the
// first row's saves a dependent round trip but reads two more random
// sectors for every pair, and most pairs stop in the first row (that
// form took twice as long at the bench's primary shape).
//
// What bounds it on this card: random 32-byte sectors, not the bytes
// used. Each 4-byte history gather and each 8-byte pack gather lands in a
// row far larger than L2 and costs a whole sector; nothing is reused
// between pairs, and the levels of one pair form a chain of dependent
// gathers, so the kernel waits on memory latency long before it fills the
// card's bandwidth.
//
// Plain C interface (bound with ctypes): returns cudaGetLastError() after
// the launch. Launches on the given stream, allocates nothing, does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long clip(long long v, long long lo,
                                          long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// common symbol-prefix length (< 8) of two masked 8-byte window packs;
// a special (byte 2 or 255) ends the match
__device__ __forceinline__ int byte8_lcp(unsigned long long pa,
                                         unsigned long long pb) {
  int out = 0;
  for (int t = 0; t < 8; ++t) {
    const int sh = 56 - 8 * t;
    const unsigned ba = (unsigned)((pa >> sh) & 0xFF);
    const unsigned bb = (unsigned)((pb >> sh) & 0xFF);
    if (ba != bb || ba == 2 || ba == 255) break;
    ++out;
  }
  return out;
}

// common symbol-prefix length (<= 16) of two 16-nibble coarse packs; only
// odd nibbles (ACGT) match
__device__ __forceinline__ int nib16_lcp(unsigned long long pa,
                                         unsigned long long pb) {
  int out = 0;
  for (int t = 0; t < 16; ++t) {
    const int sh = 60 - 4 * t;
    const unsigned na = (unsigned)((pa >> sh) & 0xF);
    const unsigned nb = (unsigned)((pb >> sh) & 0xF);
    if (na != nb || (na & 1u) == 0) break;
    ++out;
  }
  return out;
}

__global__ void lcp_lift_kernel(const int* __restrict__ hist,
                                const unsigned long long* __restrict__ packs,
                                int n_packs, const int* __restrict__ ai,
                                const int* __restrict__ bi,
                                const int* __restrict__ lv,
                                int* __restrict__ h_out, int rows, int m,
                                int sl, int lmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int a = __ldg(ai + i), b = __ldg(bi + i), l = __ldg(lv + i);
  if (!(a < m && b < m)) {
    h_out[i] = 0;
    return;
  }
  int h = l > sl ? (1 << (l - 1)) : 0;
  const int top = l >= sl ? l - 2 : lmax - 2;
  for (int k = top; k >= sl; --k) {
    const long long va = (long long)a + h, vb = (long long)b + h;
    if (va < m && vb < m) {
      const int* rk = hist + (size_t)(k - sl) * (size_t)m;
      if (__ldg(rk + va) == __ldg(rk + vb)) h += 1 << k;
    }
  }
  const long long ca = clip((long long)a + h, 0, m - 1);
  const long long cb = clip((long long)b + h, 0, m - 1);
  int rem;
  if (n_packs == 1) {
    rem = byte8_lcp(__ldg(packs + ca), __ldg(packs + cb));
  } else {
    rem = nib16_lcp(__ldg(packs + ca), __ldg(packs + cb));
    if (rem == 16)
      rem += nib16_lcp(__ldg(packs + m + ca), __ldg(packs + m + cb));
  }
  h_out[i] = h + rem;
}

}  // namespace

extern "C" int lcp_lift_launch(const int* hist, const long long* packs,
                               int n_packs, const int* ai, const int* bi,
                               const int* lv, int* h_out, int rows, int m,
                               int sl, int lmax, int threads,
                               void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + threads - 1) / threads;
  lcp_lift_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      hist, (const unsigned long long*)packs, n_packs, ai, bi, lv, h_out,
      rows, m, sl, lmax);
  return (int)cudaGetLastError();
}
