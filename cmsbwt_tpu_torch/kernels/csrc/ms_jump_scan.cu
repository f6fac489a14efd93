// ms_jump_scan — the head-jumping matching-statistics scan as one CUDA
// kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ms_pallas_step (docs/retired_pallas_scan.py:525,
// pallas_call at :544), whose body is the wave loop of the live XLA scan
// ms_jump_step (cmsbwt_tpu/ops/ms_jump.py:136). The records written here
// equal ms_jump_step's lane by lane and slot by slot, including records
// dropped past the capacity (a lane keeps counting nrec and raises viol).
//
// What bounds it on this card: chains of dependent random gathers into the
// index (SA, the text, the PSV/NSV and next-greater-or-equal structures),
// with no reuse between lanes: load latency. Its byte bound (the collection,
// the index and the records, each moved once: ~70 MB at 20 Mchars against
// a 2 Mbp reference, ~21 us at 3.35 TB/s) is far below.
//
// Design: shorten every chain, and keep enough of them in flight.
//  * One warp per lane (a lane of the JAX wave loop: one chunk of the
//    collection, its own state machine). 4096 lanes are 4096 warps, one
//    wave on 132 SMs. The lane's state is warp-uniform (every thread holds
//    it, every branch is taken by the whole warp); thread 0 writes records.
//  * Singleton extension: the 32 threads load 2 bytes each of the 64-byte
//    window of the collection and of the text at once (one dependent load
//    pair instead of up to 64); a ballot gives the first mismatch.
//  * Non-singleton extension: a 32-ary search. Each round the 32 threads
//    probe 32 pivots of the lower- and of the upper-bound interval (an SA
//    gather, then a text gather), and a ballot narrows each 33-fold:
//    <= 5 rounds at n = 2M instead of 22. The keys are sorted on an SA
//    interval whose suffixes share `length` chars, and the JAX binary
//    search is complete, so the bounds are the same.
//  * Tail skip (first p >= pos+1 with g[p] = p + PLCP[p] >= T) and PSV/NSV
//    over LCP: 128-wide block trees, the TPU kernel's own plan
//    (retired_pallas_scan.py:107-273), in place of [levels, n] sparse
//    tables. A query scans its own 128-block with one coalesced warp load
//    (32 x int4) and, in the same round, the 32-node group of each of its
//    ancestors (level k holds the min or max of 32 nodes of level k-1;
//    level 1 of 128 base entries); the nearest group with a hit is
//    descended 32 children per load. At n = 2M: levels of 15625, 489 and
//    16 nodes, at most 4 dependent loads per query instead of 21 (6 as n
//    nears 2^31), and the index the kernel reads (~34 MB) fits the 50 MB
//    L2.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 3.26 ms
// at 20 Mchars against a 2 Mbp reference, 4096 lanes, 64 registers and no
// spills (8 blocks of 4 warps fit on an SM, so 4096 lanes are one wave);
// the one-thread-per-lane form over sparse tables took 38.8 ms.
//
// Every gather index is clipped exactly as jnp.clip clips it in the JAX
// code (JAX clamps out-of-range gathers; CUDA does not), and bytes compare
// as unsigned char (pad 0xFF, separator 2).
//
// Plain C interface (bound with ctypes): returns cudaGetLastError() after
// the launch. Launches on the given stream, allocates nothing, does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned char SEPARATOR = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 128;      // base entries under a level-1 node
constexpr int MAX_LEVELS = 6;   // the base row + 5 levels: n < 2^31
constexpr int WARPS_PER_BLOCK = 4;

__device__ __forceinline__ long long clip(long long v, long long lo,
                                          long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A block tree: level 0 is the base row padded to a multiple of 128 with a
// value that never satisfies a query; level k >= 1 (at data + off[k],
// padded to a multiple of 32 likewise) holds the min (LCP) or max (g) of
// 32 nodes of level k-1, or of 128 base entries for k = 1.
struct Tree {
  const int* data;
  int off[MAX_LEVELS];
  int levels;
};

struct Index {
  const unsigned char* x;   // x_padded
  long long x_hi;           // len(x_padded) - 1
  const int* sa;
  const int* isa;
  Tree lcp;                 // minima over LCP[0..n)
  Tree g;                   // maxima over p + PLCP[p]
  int n;
};

// a base or node value that answers the query: LCP < ub (min tree) or
// g >= t (max tree)
template <bool MAX_TREE>
__device__ __forceinline__ bool hit(int v, int thr) {
  return MAX_TREE ? v >= thr : v < thr;
}

// the first (FWD) or last set bit of a non-zero mask
template <bool FWD>
__device__ __forceinline__ int pick(unsigned m) {
  return FWD ? __ffs(m) - 1 : 31 - __clz(m);
}

// The loads of one query, all independent: the query's own 128-block and
// the 32-node group of its ancestor at every level above.
struct Probe {
  int4 own;
  int up[MAX_LEVELS];
};

__device__ __forceinline__ void probe_load(const Tree& T, int s, int lane,
                                           Probe& pr) {
  pr.own = __ldg(reinterpret_cast<const int4*>(T.data + (s >> 7) * BLOCK)
                 + lane);
  int idx = s >> 7;
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k) {
    if (k < T.levels) pr.up[k] = __ldg(T.data + T.off[k] + (idx & ~31) + lane);
    idx >>= 5;
  }
}

// hits of one 128-block, 4 per thread (bit q: entry 4*lane + q); only
// entries on the query's side of s count when `bounded`
template <bool MAX_TREE, bool FWD>
__device__ __forceinline__ unsigned block_bits(int4 v, int base, int s,
                                               bool bounded, int thr,
                                               int lane) {
  const int p = base + 4 * lane;
  const int vals[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool side = !bounded || (FWD ? p + q >= s : p + q <= s);
    bits |= (unsigned)(side && hit<MAX_TREE>(vals[q], thr)) << q;
  }
  return bits;
}

// index of the first (FWD) or last hit in a block, from its bits; -1 if none
template <bool FWD>
__device__ __forceinline__ int block_pick(unsigned bits, int base) {
  const unsigned any = __ballot_sync(FULL, bits != 0);
  if (!any) return -1;
  const int f = pick<FWD>(any);
  return base + 4 * f + pick<FWD>(__shfl_sync(FULL, bits, f));
}

// The first base index p >= s (FWD) or the last p <= s whose value answers
// the query, from a loaded probe of s (0 <= s < padded length); -1 when
// none. Warp-uniform.
template <bool MAX_TREE, bool FWD>
__device__ int probe_resolve(const Tree& T, int s, int thr, int lane,
                             const Probe& pr) {
  const int own = block_pick<FWD>(
      block_bits<MAX_TREE, FWD>(pr.own, (s >> 7) * BLOCK, s, true, thr,
                                lane),
      (s >> 7) * BLOCK);
  if (own >= 0) return own;
  // the lowest level whose group holds a node past (before) the ancestor
  int idx = s >> 7, level = 0, node = 0;
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k) {
    if (k < T.levels && level == 0) {
      const int j = (idx & ~31) + lane;
      const unsigned m = __ballot_sync(
          FULL, (FWD ? j > idx : j < idx) && hit<MAX_TREE>(pr.up[k], thr));
      if (m) {
        level = k;
        node = (idx & ~31) + pick<FWD>(m);
      }
    }
    idx >>= 5;
  }
  if (level == 0) return -1;
  // descend: the first (last) answering child, 32 per load
#pragma unroll
  for (int k = MAX_LEVELS - 2; k >= 1; --k) {
    if (k < level) {
      const int v = __ldg(T.data + T.off[k] + node * 32 + lane);
      node = node * 32 + pick<FWD>(__ballot_sync(FULL, hit<MAX_TREE>(v, thr)));
    }
  }
  const int base = node * BLOCK;
  const int4 v = __ldg(reinterpret_cast<const int4*>(T.data + base) + lane);
  return block_pick<FWD>(block_bits<MAX_TREE, FWD>(v, base, 0, false, thr,
                                                   lane),
                         base);
}

// smallest p >= start with g[p] >= t_val (p < n), else n
__device__ __forceinline__ int next_ge(const Index& ix, int start, int t_val,
                                       int lane) {
  if (start >= ix.n) return ix.n;
  Probe pr;
  probe_load(ix.g, start, lane, pr);
  const int p = probe_resolve<true, true>(ix.g, start, t_val, lane, pr);
  return p < 0 || p > ix.n ? ix.n : p;
}

// largest p <= pi with LCP[p] < ub (else -1) and smallest p >= ni (p < n)
// with LCP[p] < ub (else -1), for 0 <= pi < n and 0 <= ni; both probes'
// loads are issued together
__device__ __forceinline__ void psv_nsv(const Index& ix, int pi, int ni,
                                        int ub, int lane, int* p_out,
                                        int* n_out) {
  const bool right = ni < ix.n;
  Probe a, b;
  probe_load(ix.lcp, pi, lane, a);
  if (right) probe_load(ix.lcp, ni, lane, b);
  *p_out = probe_resolve<false, false>(ix.lcp, pi, ub, lane, a);
  const int r = right ? probe_resolve<false, true>(ix.lcp, ni, ub, lane, b)
                      : -1;
  *n_out = r >= ix.n ? -1 : r;
}

// k-th of the 32 pivots of the unknown range [lo, lo + size) of a bound
// search (all of it when size <= 32)
__device__ __forceinline__ int pivot(int lo, int size, int k) {
  return size <= 32 ? lo + k
                    : lo + (int)(((long long)(k + 1) * size) / 33);
}

// the byte that orders SA row i at depth `length` (JAX clips both gathers)
__device__ __forceinline__ unsigned char key_at(const Index& ix, int i,
                                                int length) {
  const int s = __ldg(ix.sa + clip(i, 0, ix.n - 1));
  return __ldg(ix.x + clip((long long)s + length, 0, ix.x_hi));
}

// narrow a bound search's unknown range [lo, hi) by one round: `below` is
// the ballot of pivots whose key lies below the bound (a prefix of them)
__device__ __forceinline__ void narrow(int& lo, int& hi, unsigned below) {
  const int size = hi - lo;
  const int m = __popc(below);
  if (size <= 32) {
    lo += m;
    hi = lo;
  } else {
    const int nlo = m > 0 ? pivot(lo, size, m - 1) + 1 : lo;
    hi = m < 32 ? pivot(lo, size, m) : hi;
    lo = nlo;
  }
}

// at most 64 registers a thread: 8 blocks (32 warps) fit on each SM
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, 8)
ms_jump_scan_kernel(
    Index ix, const unsigned char* __restrict__ sx, int sn, int window,
    const int* __restrict__ chunk_ends, int L, int cap,
    int* st_t, int* st_len, int* st_lb, int* st_rb, int* st_pos,
    bool* st_fin, bool* st_done, int* st_nrec, bool* st_viol,
    int* out_t, int* out_pos, int* out_len, bool* out_sml) {
  const int lane_id = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;   // thread of the warp
  if (lane_id >= L) return;            // the whole warp leaves
  const int n = ix.n;
  const int W = window;
  const long long sx_hi = (long long)sn + W - 1;
  const int end = chunk_ends[lane_id];

  int t = st_t[lane_id], length = st_len[lane_id], lb = st_lb[lane_id];
  int rb = st_rb[lane_id], pos = st_pos[lane_id], nrec = st_nrec[lane_id];
  bool fin = st_fin[lane_id], done = st_done[lane_id];
  bool viol = st_viol[lane_id];
  const long long obase = (long long)lane_id * cap;

  while (!done) {
    // ---- extension step (JAX extend_body) ----
    if (!fin) {
      const unsigned char cur = __ldg(sx + clip(t, 0, sx_hi));
      const bool sep_emit = length == 0 && cur == SEPARATOR;
      const bool singleton = !sep_emit && lb == rb;
      const bool nons = !sep_emit && lb != rb;
      const long long j_abs = (long long)t + length;
      int dmm = W;
      bool sgl_smaller = false;  // stays false without a mismatch: JAX
                                 // compares at W - 1, where bytes are equal
      if (singleton) {
        const long long xb = (long long)pos + length;
        for (int c = 0; c < W; c += 64) {
          const int k0 = c + 2 * lane, k1 = k0 + 1;
          unsigned char a0 = 0, b0 = 0, a1 = 0, b1 = 0;
          if (k0 < W) {
            a0 = __ldg(sx + clip(j_abs + k0, 0, sx_hi));
            b0 = __ldg(ix.x + clip(xb + k0, 0, ix.x_hi));
          }
          if (k1 < W) {
            a1 = __ldg(sx + clip(j_abs + k1, 0, sx_hi));
            b1 = __ldg(ix.x + clip(xb + k1, 0, ix.x_hi));
          }
          const bool m0 = a0 != b0, m1 = a1 != b1;
          const unsigned mm = __ballot_sync(FULL, m0 || m1);
          if (mm) {
            const int f = __ffs(mm) - 1;
            const bool first0 = (__ballot_sync(FULL, m0) >> f) & 1u;
            const unsigned sml = __ballot_sync(FULL, m0 ? b0 > a0 : b1 > a1);
            dmm = c + 2 * f + (first0 ? 0 : 1);
            sgl_smaller = (sml >> f) & 1u;
            break;
          }
        }
      }
      const bool sgl_final = singleton && dmm < W;

      int lower = lb, upper = lb;
      if (nons) {
        const unsigned char c = __ldg(sx + clip(j_abs, 0, sx_hi));
        int lo1 = lb, hi1 = rb + 1, lo2 = lb, hi2 = rb + 1;
        while (lo1 < hi1 || lo2 < hi2) {
          const int s1 = hi1 - lo1, s2 = hi2 - lo2;
          const bool v1 = s1 > 32 || lane < s1;
          const bool v2 = s2 > 32 || lane < s2;
          unsigned char k1 = 0, k2 = 0;
          if (v1) k1 = key_at(ix, pivot(lo1, s1, lane), length);
          if (v2) k2 = key_at(ix, pivot(lo2, s2, lane), length);
          const unsigned b1 = __ballot_sync(FULL, v1 && k1 < c);
          const unsigned b2 = __ballot_sync(FULL, v2 && k2 <= c);
          if (s1 > 0) narrow(lo1, hi1, b1);
          if (s2 > 0) narrow(lo2, hi2, b2);
        }
        lower = lo1;
        upper = lo2;
      }
      const bool bs_found = nons && lower < upper;
      const bool at_end = lower == rb + 1;
      const int bs_maxmatch = at_end ? rb : lower;
      const bool bs_final = nons && lower >= upper;

      const int new_lb = bs_found ? lower : lb;
      const int new_rb = bs_found ? upper - 1 : rb;
      const int new_pos = bs_found ? __ldg(ix.sa + clip(lower, 0, n - 1))
                                   : pos;
      const int new_len = length + (bs_found ? 1 : 0) + (singleton ? dmm : 0);
      const bool final_ = sgl_final || bs_final;
      const int fpos = bs_final ? __ldg(ix.sa + clip(bs_maxmatch, 0, n - 1))
                                : new_pos;
      const bool fsml = bs_final ? !at_end : sgl_smaller;

      if (final_ || sep_emit) {
        if (nrec < cap) {
          if (lane == 0) {
            out_t[obase + nrec] = t;
            out_pos[obase + nrec] = sep_emit ? n - 1 : fpos;
            out_len[obase + nrec] = sep_emit ? 0 : new_len;
            out_sml[obase + nrec] = sep_emit ? false : fsml;
          }
        } else {
          viol = true;  // record dropped; the host retries with 2x cap
        }
        nrec += 1;
        t += 1;
      }
      if (sep_emit) {  // separator: reset to the root interval
        length = 0;
        lb = 0;
        rb = n - 1;
        pos = n - 1;
      } else if (final_) {
        length = new_len - 1;
        pos = fpos;
      } else {
        length = new_len;
        lb = new_lb;
        rb = new_rb;
        pos = new_pos;
      }
      fin = final_;
      done = t >= end;
    }

    // ---- skip + adjust for a parked lane (JAX skip_adjust_body) ----
    if (fin && !done) {
      // independent of the skip: issued before it
      const int suflo = __ldg(ix.sa + clip(lb, 0, n - 1));
      const int sufhi = __ldg(ix.sa + clip(rb, 0, n - 1));
      const int p_found = next_ge(ix, (int)clip((long long)pos + 1, 0, n),
                                  pos + length + 1, lane);
      int q = p_found - (pos + 1);
      if (q < 0) q = 0;
      if (q > end - t) q = end - t;
      t += q;
      pos += q;
      length -= q;
      if (t >= end) {
        done = true;
      } else {
        const bool adj_sgl = lb == rb;
        const bool at_root = !adj_sgl && (suflo == n - 1 || sufhi == n - 1);
        int qlo, qhi;
        if (adj_sgl) {
          qlo = qhi = __ldg(ix.isa + clip((long long)pos + 1, 0, n - 1));
        } else {
          qlo = __ldg(ix.isa + clip((long long)suflo + 1, 0, n - 1));
          qhi = __ldg(ix.isa + clip((long long)sufhi + 1, 0, n - 1));
        }
        if (at_root) {
          lb = 0;
          rb = n - 1;
        } else {
          int p, qn;
          psv_nsv(ix, qlo, qhi + 1, length, lane, &p, &qn);
          lb = p == -1 ? 0 : p;
          rb = qn == -1 ? n - 1 : qn - 1;
        }
        pos = __ldg(ix.sa + clip(lb, 0, n - 1));
        fin = false;
      }
    }
  }

  if (lane == 0) {
    st_t[lane_id] = t;
    st_len[lane_id] = length;
    st_lb[lane_id] = lb;
    st_rb[lane_id] = rb;
    st_pos[lane_id] = pos;
    st_fin[lane_id] = fin;
    st_done[lane_id] = done;
    st_nrec[lane_id] = nrec;
    st_viol[lane_id] = viol;
  }
}

}  // namespace

extern "C" int ms_jump_scan_launch(
    const unsigned char* x_padded, long long x_len, const int* sa,
    const int* isa, const int* lcp_tree, const int* g_tree,
    const int* level_off, int levels, int n, const unsigned char* sx_padded,
    int sn, int window, const int* chunk_ends, int L, int cap, int* st_t,
    int* st_len, int* st_lb, int* st_rb, int* st_pos, bool* st_fin,
    bool* st_done, int* st_nrec, bool* st_viol, int* out_t, int* out_pos,
    int* out_len, bool* out_sml, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Index ix{};
  ix.x = x_padded;
  ix.x_hi = x_len - 1;
  ix.sa = sa;
  ix.isa = isa;
  ix.lcp.data = lcp_tree;
  ix.g.data = g_tree;
  ix.lcp.levels = ix.g.levels = levels;
  for (int k = 0; k < MAX_LEVELS; ++k)
    ix.lcp.off[k] = ix.g.off[k] = k < levels ? level_off[k] : 0;
  ix.n = n;
  const int blocks = (L + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  ms_jump_scan_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                        (cudaStream_t)stream>>>(
      ix, sx_padded, sn, window, chunk_ends, L, cap, st_t, st_len, st_lb,
      st_rb, st_pos, st_fin, st_done, st_nrec, st_viol, out_t, out_pos,
      out_len, out_sml);
  return (int)cudaGetLastError();
}
