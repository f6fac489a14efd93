// ms_jump_scan — the head-jumping matching-statistics scan as one CUDA
// kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ms_pallas_step (docs/retired_pallas_scan.py:525,
// pallas_call at :544), whose body is the wave loop of the live XLA scan
// ms_jump_step (cmsbwt_tpu/ops/ms_jump.py:136). The records written here
// equal ms_jump_step's lane by lane and slot by slot.
//
// Design. One thread per lane runs that lane's whole state machine in one
// launch: extend the factor (windowed compare on a singleton SA interval,
// or one fused lower/upper-bound binary search round pair otherwise); when
// the factor finalizes, skip the tail run (first p >= pos+1 with
// p + PLCP[p] >= pos+len+1, a descent over the gmax sparse table) and
// re-expand the interval by PSV/NSV over the LCP sparse table. The lanes of
// the JAX wave loop are independent, so a per-thread loop reproduces the
// masked loop exactly, including records dropped past the capacity (a
// lane keeps counting nrec and raises viol, as the JAX code does).
//
// What bounds it on this card: dependent random gathers into the index
// (SA, the text, the two [levels, n] sparse tables), a few hundred bytes
// per step per lane with no reuse between lanes; latency, not bandwidth.
// This first version reads the full sparse tables from global memory and
// relies on L2 (50 MB) for the hot upper levels. Later work: the TPU
// kernel's 128-wide block trees to shrink the tables, warp-per-lane
// layouts, lane-count tuning.
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

__device__ __forceinline__ long long clip(long long v, long long lo,
                                          long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Index {
  const unsigned char* x;   // x_padded
  long long x_hi;           // len(x_padded) - 1
  const int* sa;
  const int* isa;
  const int* jump;          // [levels, n] LCP window minima
  const int* gmax;          // [levels, n] window maxima of p + PLCP[p]
  int levels;
  int n;
};

// smallest p >= start with g[p] >= t_val (p < n), else n
__device__ __forceinline__ int next_ge(const Index& ix, int start,
                                       int t_val) {
  long long d = 0;
  for (int k = ix.levels - 1; k >= 0; --k) {
    const long long w = 1LL << k;
    const long long s = start + d;
    const int mx = ix.gmax[(long long)k * ix.n + clip(s, 0, ix.n - 1)];
    if (s + w <= ix.n && mx < t_val) d += w;
  }
  const long long r = start + d;
  return (int)(r < ix.n ? r : ix.n);
}

// psv(jump, pi, ub) and nsv(jump, ni, ub) in one descent; -1 when absent
__device__ __forceinline__ void psv_nsv(const Index& ix, int pi, int ni,
                                        int ub, int* p_out, int* n_out) {
  long long dp = 0, dn = 0;
  for (int k = ix.levels - 1; k >= 0; --k) {
    const long long w = 1LL << k;
    const long long sp = pi - dp - w + 1;
    const long long sn = ni + dn;
    const int* row = ix.jump + (long long)k * ix.n;
    const int vp = row[sp > 0 ? sp : 0];
    const int vn = row[sn < ix.n - 1 ? sn : ix.n - 1];
    if (sp >= 0 && vp >= ub) dp += w;
    if (sn + w <= ix.n && vn >= ub) dn += w;
  }
  const long long rp = pi - dp;
  const long long rn = ni + dn;
  *p_out = rp >= 0 ? (int)rp : -1;
  *n_out = rn < ix.n ? (int)rn : -1;
}

__global__ void ms_jump_scan_kernel(
    Index ix, const unsigned char* __restrict__ sx, int sn, int window,
    int rounds, const int* __restrict__ chunk_ends, int L, int cap,
    int* st_t, int* st_len, int* st_lb, int* st_rb, int* st_pos,
    bool* st_fin, bool* st_done, int* st_nrec, bool* st_viol,
    int* out_t, int* out_pos, int* out_len, bool* out_sml) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int n = ix.n;
  const int W = window;
  const long long sx_hi = (long long)sn + W - 1;
  const int end = chunk_ends[lane];

  int t = st_t[lane], length = st_len[lane], lb = st_lb[lane];
  int rb = st_rb[lane], pos = st_pos[lane], nrec = st_nrec[lane];
  bool fin = st_fin[lane], done = st_done[lane], viol = st_viol[lane];
  const long long obase = (long long)lane * cap;

  while (!done) {
    // ---- extension step (JAX extend_body) ----
    const bool act = !done && !fin;
    if (act) {
      const unsigned char cur = sx[clip(t, 0, sx_hi)];
      const bool sep_emit = length == 0 && cur == SEPARATOR;
      const bool singleton = !sep_emit && lb == rb;
      const bool nons = !sep_emit && lb != rb;
      const long long j_abs = (long long)t + length;
      int dmm = W;
      bool sgl_smaller = false;
      if (singleton) {
        const long long xb = (long long)pos + length;
        for (int k = 0; k < W; ++k) {
          const unsigned char a = sx[clip(j_abs + k, 0, sx_hi)];
          const unsigned char b = ix.x[clip(xb + k, 0, ix.x_hi)];
          if (a != b) {
            dmm = k;
            sgl_smaller = b > a;
            break;
          }
        }
        if (dmm == W) {  // no mismatch: compare at clip(W, 0, W-1)
          const unsigned char a = sx[clip(j_abs + W - 1, 0, sx_hi)];
          const unsigned char b = ix.x[clip(xb + W - 1, 0, ix.x_hi)];
          sgl_smaller = b > a;
        }
      }
      const bool sgl_final = singleton && dmm < W;

      int lower = lb, upper = lb;
      if (nons) {
        const unsigned char c = sx[clip(j_abs, 0, sx_hi)];
        int lo1 = lb, hi1 = rb + 1, lo2 = lb, hi2 = rb + 1;
        for (int r = 0; r < rounds && (lo1 < hi1 || lo2 < hi2); ++r) {
          if (lo1 < hi1) {
            const int m1 = (lo1 + hi1) >> 1;
            const int s1 = ix.sa[clip(m1, 0, n - 1)];
            const unsigned char k1 = ix.x[clip((long long)s1 + length, 0,
                                               ix.x_hi)];
            if (k1 < c) lo1 = m1 + 1; else hi1 = m1;
          }
          if (lo2 < hi2) {
            const int m2 = (lo2 + hi2) >> 1;
            const int s2 = ix.sa[clip(m2, 0, n - 1)];
            const unsigned char k2 = ix.x[clip((long long)s2 + length, 0,
                                               ix.x_hi)];
            if (k2 <= c) lo2 = m2 + 1; else hi2 = m2;
          }
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
      const int new_pos = bs_found ? ix.sa[clip(lower, 0, n - 1)] : pos;
      const int new_len = length + (bs_found ? 1 : 0) + (singleton ? dmm : 0);
      const bool final_ = sgl_final || bs_final;
      const int fpos = bs_final ? ix.sa[clip(bs_maxmatch, 0, n - 1)]
                                : new_pos;
      const bool fsml = bs_final ? !at_end : sgl_smaller;

      if (final_ || sep_emit) {
        if (nrec < cap) {
          out_t[obase + nrec] = t;
          out_pos[obase + nrec] = sep_emit ? n - 1 : fpos;
          out_len[obase + nrec] = sep_emit ? 0 : new_len;
          out_sml[obase + nrec] = sep_emit ? false : fsml;
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
      fin = fin || final_;
      done = t >= end;
    }

    // ---- skip + adjust for a parked lane (JAX skip_adjust_body) ----
    if (fin && !done) {
      const int p_found = next_ge(ix, (int)clip((long long)pos + 1, 0, n),
                                  pos + length + 1);
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
        const int suflo = ix.sa[clip(lb, 0, n - 1)];
        const int sufhi = ix.sa[clip(rb, 0, n - 1)];
        const bool at_root = !adj_sgl && (suflo == n - 1 || sufhi == n - 1);
        int qlo, qhi;
        if (adj_sgl) {
          qlo = qhi = ix.isa[clip((long long)pos + 1, 0, n - 1)];
        } else {
          qlo = ix.isa[clip((long long)suflo + 1, 0, n - 1)];
          qhi = ix.isa[clip((long long)sufhi + 1, 0, n - 1)];
        }
        if (at_root) {
          lb = 0;
          rb = n - 1;
        } else {
          int p, qn;
          psv_nsv(ix, qlo, qhi + 1, length, &p, &qn);
          lb = p == -1 ? 0 : p;
          rb = qn == -1 ? n - 1 : qn - 1;
        }
        pos = ix.sa[clip(lb, 0, n - 1)];
        fin = false;
      }
    }
  }

  st_t[lane] = t;
  st_len[lane] = length;
  st_lb[lane] = lb;
  st_rb[lane] = rb;
  st_pos[lane] = pos;
  st_fin[lane] = fin;
  st_done[lane] = done;
  st_nrec[lane] = nrec;
  st_viol[lane] = viol;
}

}  // namespace

extern "C" int ms_jump_scan_launch(
    const unsigned char* x_padded, long long x_len, const int* sa,
    const int* isa, const int* jump, const int* gmax, int levels, int n,
    const unsigned char* sx_padded, int sn, int window, int rounds,
    const int* chunk_ends, int L, int cap, int* st_t, int* st_len,
    int* st_lb, int* st_rb, int* st_pos, bool* st_fin, bool* st_done,
    int* st_nrec, bool* st_viol, int* out_t, int* out_pos, int* out_len,
    bool* out_sml, int threads, void* stream) {
  Index ix{x_padded, x_len - 1, sa, isa, jump, gmax, levels, n};
  const int blocks = (L + threads - 1) / threads;
  ms_jump_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      ix, sx_padded, sn, window, rounds, chunk_ends, L, cap, st_t, st_len,
      st_lb, st_rb, st_pos, st_fin, st_done, st_nrec, st_viol, out_t,
      out_pos, out_len, out_sml);
  return (int)cudaGetLastError();
}
