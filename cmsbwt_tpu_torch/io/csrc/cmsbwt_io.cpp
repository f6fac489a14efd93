// Native runtime IO of the PyTorch port: the streaming collection
// parser, the output writers of the host and sharded merge routes, and
// the host merge's parallel sorts, searches, tail walk and run expansion
// (cmsbwt_tpu_torch/io/native.py). The host-side runtime that the
// reference implements in C++ (parsing: CMS-BWT-functions.cpp:344-559,
// writers: :939-1085), kept off the Python interpreter.
//
// The port's own copy of the JAX package's native/cmsbwt_io.cpp, the
// same in behaviour: the host merge's files stay byte for byte those of
// the JAX package. The device merge writes its files through the card
// instead (cmsbwt_tpu_torch/io/output.py).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Parse the collection file with the reference's exact getline semantics:
// every empty line or '>' line flushes the current document and appends one
// separator (2); a final unterminated line is dropped; the -p cut happens
// mid-line once charactersRead >= sn_limit - 1; the EOF block appends a
// final separator when unfinished content remains.
//
// out must hold at least file_size+1 bytes. Returns sn (chars written) or
// -1 on IO error. n_seps_out receives the separator count.
int64_t cms_parse_collection(const char *path, uint64_t sn_limit,
                             uint8_t *out, int64_t *n_seps_out) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  // read whole file (collections are memory-bound anyway upstream)
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(fsize);
  if (fsize && fread(data.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return -1;
  }
  fclose(f);

  int64_t sn = 0;
  int64_t n_seps = 0;
  uint64_t characters_read = 0;
  int64_t cur_doc_len = 0;
  bool truncated = false;

  int64_t line_start = 0;
  // iterate complete lines only (getline .good() drops the final
  // unterminated line)
  for (int64_t i = 0; i < fsize && !truncated; i++) {
    if (data[i] != '\n') continue;
    const uint8_t *line = data.data() + line_start;
    int64_t len = i - line_start;
    line_start = i + 1;
    if (len == 0 || line[0] == '>') {
      characters_read += 1;
      out[sn++] = 2;
      n_seps++;
      cur_doc_len = 0;
    } else {
      characters_read += len;
      if (characters_read >= sn_limit - 1) {
        int64_t take = len - (int64_t)(characters_read - sn_limit) - 1;
        if (take < 0) take = 0;
        if (take > len) take = len;
        memcpy(out + sn, line, take);
        sn += take;
        cur_doc_len += take;
        truncated = true;
      } else {
        memcpy(out + sn, line, len);
        sn += len;
        cur_doc_len += len;
      }
    }
  }
  if (cur_doc_len != 0) {
    out[sn++] = 2;
    n_seps++;
  }
  *n_seps_out = n_seps;
  return sn;
}

// Expand runs to a plain .bwt file with a buffered writer
// (ref :939-1002 semantics; runs are pre-assembled by the engine).
int64_t cms_write_plain(const char *path, const int64_t *run_len,
                        const uint8_t *run_char, int64_t n_runs) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  const size_t BUF = 1 << 20;
  std::vector<uint8_t> buf(BUF);
  size_t fill = 0;
  int64_t total = 0;
  for (int64_t i = 0; i < n_runs; i++) {
    int64_t l = run_len[i];
    uint8_t c = run_char[i];
    total += l;
    while (l > 0) {
      size_t room = BUF - fill;
      size_t take = (size_t)l < room ? (size_t)l : room;
      memset(buf.data() + fill, c, take);
      fill += take;
      l -= take;
      if (fill == BUF) {
        fwrite(buf.data(), 1, fill, f);
        fill = 0;
      }
    }
  }
  if (fill) fwrite(buf.data(), 1, fill, f);
  fclose(f);
  return total;
}

// Merge adjacent equal-char runs and emit (uint64-LE length, uint8 char)
// records (ref :1003-1085).
int64_t cms_write_rle(const char *path, const int64_t *run_len,
                      const uint8_t *run_char, int64_t n_runs) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  uint64_t cur_len = 0;
  uint8_t cur_char = 0;
  int64_t records = 0;
  for (int64_t i = 0; i < n_runs; i++) {
    if (run_len[i] <= 0) continue;
    if (run_char[i] == cur_char) {
      cur_len += (uint64_t)run_len[i];
    } else {
      // the reference's prevChar=0/runLength=0 initial state never emits an
      // empty first record because BWT chars are >= 2
      if (cur_len > 0) {
        fwrite(&cur_len, 8, 1, f);
        fwrite(&cur_char, 1, 1, f);
        records++;
      }
      cur_len = (uint64_t)run_len[i];
      cur_char = run_char[i];
    }
  }
  fwrite(&cur_len, 8, 1, f);
  fwrite(&cur_char, 1, 1, f);
  records++;
  fclose(f);
  return records;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tail positioning (the reference's counterSmallerThanHead accumulation,
// ref CMS-BWT-functions.cpp:733-902 / :1517-1603) as a native loop: the
// per-(class, offset) credit walk is branchy and list-heavy — a poor fit
// for array expansion — but trivial at C++ speed. OpenMP over classes with
// atomic credit updates.
// ---------------------------------------------------------------------------

// Caller passes per-class (pos, len, until, size, isa, smaller) and the
// per-bucket class ranges over the text-order sorted class combo keys.
extern "C" int64_t cms_position_tails(
    int64_t n_classes, const int64_t *pos, const int64_t *len,
    const int64_t *until, const int64_t *size, const int64_t *isa,
    const uint8_t *smaller, const int64_t *cls_combo,  // per class, sorted
    const int64_t *slot_base,                          // size C+1
    const int64_t *member_rank,                        // size h
    const int32_t *bmap,                               // size n_ref
    const int64_t *cls_lo, const int64_t *cls_hi,      // per bucket
    int64_t n_ref, int64_t *counter,                   // size h+1
    int64_t *stats /* good, bad, donothing */) {
  int64_t good = 0, bad = 0, donothing = 0;
  const int64_t two_n = 2 * n_ref;
  const int64_t scale = n_ref + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) \
    reduction(+ : good, bad, donothing)
#endif
  for (int64_t c = 0; c < n_classes; c++) {
    const bool sm = smaller[c] != 0;
    const int64_t lc = len[c];
    const int64_t ic = isa[c];
    const int64_t sz = size[c];
    for (int64_t k = 0; k < until[c]; k++) {
      int64_t b = pos[c] + 1 + k;
      int32_t bid = bmap[b];
      if (bid < 0) {
        donothing++;
        continue;
      }
      int64_t qlen = lc - 1 - k;
      int64_t kk = sm ? qlen : two_n - qlen;
      int64_t qkey = kk * scale + ic;
      // lower_bound over [cls_lo[bid], cls_hi[bid])
      int64_t lo = cls_lo[bid], hi = cls_hi[bid];
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (cls_combo[mid] < qkey)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo >= cls_hi[bid]) continue;  // past all classes in bucket
      if (cls_combo[lo] != qkey) {
        // strictly before the found class: lump credit
        good++;
#ifdef _OPENMP
#pragma omp atomic
#endif
        counter[slot_base[lo]] += sz;
        continue;
      }
      // exact: element-wise sorted merge (ref :1567-1589)
      bad++;
      const int64_t *src = member_rank + slot_base[c];
      const int64_t *dst = member_rank + slot_base[lo];
      int64_t msrc = slot_base[c + 1] - slot_base[c];
      int64_t mdst = slot_base[lo + 1] - slot_base[lo];
      int64_t is = 0, id = 0;
      while (is < msrc && id < mdst) {
        if (src[is] < dst[id]) {
#ifdef _OPENMP
#pragma omp atomic
#endif
          counter[slot_base[lo] + id] += 1;
          is++;
        } else {
          id++;
        }
      }
      if (is < msrc && lo + 1 < cls_hi[bid]) {
#ifdef _OPENMP
#pragma omp atomic
#endif
        counter[slot_base[lo + 1]] += msrc - is;
      }
    }
  }
  stats[0] = good;
  stats[1] = bad;
  stats[2] = donothing;
  return 0;
}

// ---------------------------------------------------------------------------
// Parallel stable argsort for the host merge engine's big key arrays
// (numpy's single-threaded sorts dominate at tens of millions of heads).
// Sorts perm (in/out) so that keys[perm] is ascending; stable with respect
// to the incoming perm order, i.e. chained calls implement lexsort.
// ---------------------------------------------------------------------------
#if defined(_OPENMP)
#include <parallel/algorithm>
#define CMS_STABLE_SORT __gnu_parallel::stable_sort
#else
#include <algorithm>
#define CMS_STABLE_SORT std::stable_sort
#endif

extern "C" int64_t cms_stable_argsort_i64(const int64_t *keys, int64_t *perm,
                                          int64_t m) {
  // pair-array sort (cache-friendly) beats an indirect comparator
  struct KV {
    int64_t k;
    int64_t v;
  };
  std::vector<KV> buf(m);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < m; i++) buf[i] = {keys[perm[i]], perm[i]};
  CMS_STABLE_SORT(buf.begin(), buf.end(),
                  [](const KV &a, const KV &b) { return a.k < b.k; });
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < m; i++) perm[i] = buf[i].v;
  return 0;
}

// ---------------------------------------------------------------------------
// Slot-level run expansion for build_runs (see engine/merge.py): for each
// emission class c, write its m_c [counter run, head char] pairs into the
// run arrays and return the class's counter sum. One parallel pass replaces
// ~8 full-size numpy passes (repeat/arange/gather/scatter/bincount).
extern "C" int64_t cms_expand_slots(
    int64_t nec,
    const int64_t *m_c,        // [nec] members per class (emission order)
    const int64_t *ex_mc,      // [nec] exclusive prefix sum of m_c
    const int64_t *base_c,     // [nec] text-layout slot base per class
    const int64_t *cls_start,  // [nec] first run index per class
    const int64_t *counter,    // [tot_slots_text] per-slot counter (text layout)
    const uint8_t *cls_char,   // [nec] bucket refBWT char per class
    const uint8_t *bwt_heads,  // [tot_slots] head chars (emission slot order)
    int64_t *run_len,          // out
    uint8_t *run_char,         // out
    int64_t *csum_c) {         // out [nec] per-class counter sum
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t c = 0; c < nec; c++) {
    const int64_t m = m_c[c];
    const int64_t slot0 = ex_mc[c];
    const int64_t text0 = base_c[c];
    const int64_t r0 = cls_start[c];
    const uint8_t ch = cls_char[c];
    int64_t sum = 0;
    for (int64_t k = 0; k < m; k++) {
      const int64_t cnt = counter[text0 + k];
      sum += cnt;
      run_len[r0 + 2 * k] = cnt;
      run_char[r0 + 2 * k] = ch;
      run_len[r0 + 2 * k + 1] = 1;
      run_char[r0 + 2 * k + 1] = bwt_heads[slot0 + k];
    }
    csum_c[c] = sum;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Parallel batched binary search: out[i] = upper_bound(a, a+n, q[i]) - a
// (side='right' semantics of np.searchsorted). numpy's searchsorted is
// single-threaded; this is the hot call of the covering-phrase fixup.
extern "C" int64_t cms_searchsorted_right(const int64_t *a, int64_t n,
                                          const int64_t *q, int64_t m,
                                          int64_t *out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < m; i++) {
    int64_t lo = 0, hi = n;
    const int64_t x = q[i];
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (a[mid] <= x) lo = mid + 1; else hi = mid;
    }
    out[i] = lo;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Stable argsort by a two-int64 lexicographic key in ONE parallel sort pass
// (vs chaining two stable single-key passes).
extern "C" int64_t cms_stable_argsort_2i64(const int64_t *primary,
                                           const int64_t *secondary,
                                           int64_t *perm, int64_t m) {
  struct KKV {
    int64_t k1;  // primary
    int64_t k2;  // secondary
    int64_t v;
  };
  std::vector<KKV> buf(m);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < m; i++)
    buf[i] = {primary[perm[i]], secondary[perm[i]], perm[i]};
  CMS_STABLE_SORT(buf.begin(), buf.end(), [](const KKV &a, const KKV &b) {
    return a.k1 != b.k1 ? a.k1 < b.k1 : a.k2 < b.k2;
  });
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < m; i++) perm[i] = buf[i].v;
  return 0;
}

// ---------------------------------------------------------------------------
// rankToHead fill (see engine/ranking.py assign_class_ranks): for each class
// write its rank value at every member's head index. Classes own disjoint
// members, so parallel-over-classes writes never collide.
extern "C" int64_t cms_fill_class_ranks(int64_t n_classes,
                                        const int64_t *member_off,
                                        const int64_t *member_head,
                                        const int64_t *rank_value,
                                        int64_t pseudo_cls,
                                        int64_t *rank_to_head) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t c = 0; c < n_classes; c++) {
    if (c == pseudo_cls) continue;
    const int64_t v = rank_value[c];
    for (int64_t k = member_off[c]; k < member_off[c + 1]; k++)
      rank_to_head[member_head[k]] = v;
  }
  return 0;
}
