"""Tail positioning: credit each implied tail suffix against the heads of its
bucket (ref ``CMS-BWT-functions.cpp:733-902`` buffered small path /
``:1525-1603`` direct large path) — the port's copy of
cmsbwt_tpu/engine/tails.py.

Reference semantics, vectorized:

* a class ``p`` at position ``i`` implies tails at buckets ``i+1+k`` for
  ``k in [0, untilNext)`` with key ``(len-1-k, smaller, isaNext)``;
* buckets without heads need nothing (``counterDoNothing``);
* ``lower_bound`` in the bucket's class list; if the key matches exactly
  (len + isaNext equality, match.h:23-25), each member succ-rank of ``p`` is
  credited at slot ``base + searchsorted(bucketClassRanks, r, 'right')`` —
  the reference's element-wise sorted-list merge (ref :1567-1589) — with
  overflow going to the next class's base slot only if a next class exists
  in the bucket; otherwise the whole member count is credited at the found
  class's base slot (``counterGood``).

The per-(class, offset) loop of the reference is O(total tails); here only
the (class, head-bucket) intersections are enumerated via searchsorted over
the sorted head-bucket position list — strictly less work.

Memory bounding: the numpy path processes the (class, bucket) pair stream in
batches sized by ``buffer_bytes`` — the role the reference's ``-b`` flag
plays for its ``bufferSuffixes`` query buffer (ref :713-719, the only
consumer of ``arg.buffer``).

Key packing: class keys (K, isaNext) pack into one int64 when
``2n(n+1)+n < 2^62`` (references up to ~1.5 Gbp). Above that the code
switches to explicit two-key lexicographic comparisons (no packing), so
large in-range references work; the native kernel requires packed keys and
is skipped in that regime.
"""
from __future__ import annotations

import numpy as np

from ..index.host import ReferenceIndex
from .heads import ClassArrays
from .ranking import RankedHeads

_FORCE_TWO_KEY = False  # test hook: exercise the large-n two-key path
_MIN_BATCH_PAIRS = 1 << 18  # floor of the -b–derived batch size


def _packing_ok(n: int) -> bool:
    return not _FORCE_TWO_KEY and 2 * n * (n + 1) + n < 2**62


def _combine_key(key_k: np.ndarray, isa_next: np.ndarray, n: int) -> np.ndarray:
    """Pack (K, isaNext) into one int64 sort key. K < 2n, isaNext < n."""
    assert _packing_ok(n)
    return key_k * np.int64(n + 1) + isa_next


def position_tails(index: ReferenceIndex, classes: ClassArrays,
                   ranked: RankedHeads,
                   buffer_bytes: int | None = None) -> np.ndarray:
    """Return counterSmallerThanHead (int64 [h+1], slot-indexed)."""
    import os
    import sys
    import time
    profile = bool(os.environ.get("CMSBWT_PROFILE"))
    t0 = time.time()
    n = index.n
    h = len(ranked.member_rank_sorted)
    counter = np.zeros(h + 1, dtype=np.int64)
    if classes.n_classes == 0:
        return counter

    # bucket positions that contain heads, ascending; classes are stored in
    # text order so class ranges per bucket come from searchsorted
    bucket_pos = np.unique(classes.pos)
    cls_lo = np.searchsorted(classes.pos, bucket_pos, side="left")
    cls_hi = np.searchsorted(classes.pos, bucket_pos, side="right")

    packed = _packing_ok(n)
    if packed:
        combo = _combine_key(classes.key_k, classes.isa_next, n)
        # native path: the per-(class, offset) credit walk at C++ speed
        # (OpenMP); numpy fallback below
        from ..io.native import position_tails_native
        bmap = np.full(n, -1, dtype=np.int32)
        bmap[bucket_pos] = np.arange(len(bucket_pos), dtype=np.int32)
        native = position_tails_native(classes, combo, ranked.slot_base,
                                       ranked.member_rank_sorted, bmap,
                                       cls_lo, cls_hi, n, h)
        if native is not None:
            counter, stats = native
            if profile:
                print(f"#   tails(native): total={time.time() - t0:.2f}s "
                      f"good={stats[0]} bad={stats[1]} skip={stats[2]}",
                      file=sys.stderr)
            return counter

    # enumerate (class, interesting bucket) pairs
    first_b = classes.pos + 1
    last_b = classes.pos + classes.until_next        # inclusive
    lo = np.searchsorted(bucket_pos, first_b, side="left")
    hi = np.searchsorted(bucket_pos, last_b, side="right")
    cnt = np.maximum(hi - lo, 0)
    total = int(cnt.sum())
    if total == 0:
        return counter
    if profile:
        print(f"#   tails: classes={classes.n_classes} pairs={total} "
              f"setup={time.time() - t0:.2f}s", file=sys.stderr)

    # -b–bounded batching: each pair costs ~64 bytes of intermediates
    budget_pairs = max(_MIN_BATCH_PAIRS, int(buffer_bytes or (2 << 30)) // 64)
    ccum = np.concatenate([[0], np.cumsum(cnt)])
    n_exact = 0
    c0 = 0
    while c0 < classes.n_classes:
        c1 = int(np.searchsorted(ccum, ccum[c0] + budget_pairs,
                                 side="right")) - 1
        c1 = min(max(c1, c0 + 1), classes.n_classes)
        n_exact += _position_tails_range(
            classes, ranked, counter, bucket_pos, cls_lo, cls_hi,
            lo, hi, cnt, n, h, c0, c1, packed)
        c0 = c1
    if profile:
        print(f"#   tails: total={time.time() - t0:.2f}s exact={n_exact}",
              file=sys.stderr)
    return counter


def _position_tails_range(classes, ranked, counter, bucket_pos, cls_lo,
                          cls_hi, lo, hi, cnt, n, h, c0, c1,
                          packed: bool) -> int:
    """Credit the (class, bucket) pairs of classes [c0, c1) into counter."""
    cnt_r = cnt[c0:c1]
    total = int(cnt_r.sum())
    if total == 0:
        return 0
    src_cls = c0 + np.repeat(np.arange(c1 - c0, dtype=np.int64), cnt_r)
    offsets = np.concatenate([[0], np.cumsum(cnt_r)])[:-1]
    within = (np.arange(total, dtype=np.int64)
              - np.repeat(offsets, cnt_r)).astype(np.int64)
    b_idx = lo[src_cls] + within                     # index into bucket_pos
    del within
    b = bucket_pos[b_idx]
    k = b - classes.pos[src_cls] - 1                 # tail offset in [0, untilNext)

    q_len = classes.length[src_cls] - 1 - k
    del b, k
    q_small = classes.smaller[src_cls]
    q_isa = classes.isa_next[src_cls]
    q_k = np.where(q_small, q_len, 2 * np.int64(n) - q_len)
    del q_len, q_small

    # lower_bound within each bucket's class range
    if packed:
        combo = _combine_key(classes.key_k, classes.isa_next, n)
        q_combo = _combine_key(q_k, q_isa, n)
        found = _batched_lower_bound(combo, q_combo,
                                     cls_lo[b_idx], cls_hi[b_idx])
        fc_clip = np.minimum(found, classes.n_classes - 1)
        in_range = found < cls_hi[b_idx]
        exact = in_range & (combo[fc_clip] == q_combo)
        del combo, q_combo
    else:
        found = _batched_lower_bound2(classes.key_k, classes.isa_next,
                                      q_k, q_isa,
                                      cls_lo[b_idx], cls_hi[b_idx])
        fc_clip = np.minimum(found, classes.n_classes - 1)
        in_range = found < cls_hi[b_idx]
        exact = in_range & (classes.key_k[fc_clip] == q_k) & \
            (classes.isa_next[fc_clip] == q_isa)
    del q_k, q_isa
    good = in_range & ~exact

    # good path: lump-credit the source class's member count at the found
    # base (bincount: np.add.at is ~10x slower at tens of millions)
    gslots = ranked.slot_base[found[good]]
    counter += np.bincount(gslots, weights=classes.size[src_cls[good]],
                           minlength=h + 1).astype(np.int64)
    del gslots, good, in_range

    # exact path: member-wise merge via batched searchsorted (the
    # reference's element-wise sorted-list walk, ref :1567-1589)
    eidx = np.nonzero(exact)[0]
    if len(eidx):
        sc = src_cls[eidx]
        fc = found[eidx]
        msz = classes.size[sc]
        tot = int(msz.sum())
        pair_of = np.repeat(np.arange(len(eidx)), msz)
        off = np.concatenate([[0], np.cumsum(msz)])[:-1]
        within = np.arange(tot) - np.repeat(off, msz)
        q = ranked.member_rank_sorted[
            ranked.slot_base[sc][pair_of] + within]
        dst_lo = ranked.slot_base[fc][pair_of]
        dst_hi = ranked.slot_base[fc[pair_of] + 1]
        # upper bound on integers == lower bound of q+1
        p = _batched_lower_bound(ranked.member_rank_sorted, q + 1,
                                 dst_lo, dst_hi)
        inb = p < dst_hi
        counter += np.bincount(p[inb], minlength=h + 1).astype(np.int64)
        # spill to the next class's base slot when it exists in the bucket
        spill_pair = np.bincount(pair_of, weights=(~inb),
                                 minlength=len(eidx)).astype(np.int64)
        has_next = (fc + 1) < cls_hi[b_idx[eidx]]
        np.add.at(counter,
                  ranked.slot_base[np.minimum(fc + 1,
                                              classes.n_classes)][has_next],
                  spill_pair[has_next])
    return len(eidx)


def _batched_lower_bound(sorted_vals: np.ndarray, queries: np.ndarray,
                         lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Vectorized lower_bound of queries[i] within sorted_vals[lo[i]:hi[i]].

    Uses a fixed number of binary-search rounds (log2 of max range)."""
    low = lo.astype(np.int64).copy()
    high = hi.astype(np.int64).copy()
    max_range = int(np.max(hi - lo)) if len(lo) else 0
    rounds = max(1, int(np.ceil(np.log2(max_range + 1))) + 1)
    for _ in range(rounds):
        active = low < high
        mid = (low + high) >> 1
        midv = sorted_vals[np.minimum(mid, len(sorted_vals) - 1)]
        go_right = active & (midv < queries)
        low = np.where(go_right, mid + 1, low)
        high = np.where(active & ~go_right, mid, high)
    return low


def _batched_lower_bound2(vals_a: np.ndarray, vals_b: np.ndarray,
                          qa: np.ndarray, qb: np.ndarray,
                          lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Two-key lexicographic lower_bound (the unpacked-key path for
    references too large for int64 key packing)."""
    low = lo.astype(np.int64).copy()
    high = hi.astype(np.int64).copy()
    max_range = int(np.max(hi - lo)) if len(lo) else 0
    rounds = max(1, int(np.ceil(np.log2(max_range + 1))) + 1)
    for _ in range(rounds):
        active = low < high
        mid = (low + high) >> 1
        midc = np.minimum(mid, len(vals_a) - 1)
        ma = vals_a[midc]
        mb = vals_b[midc]
        lt = (ma < qa) | ((ma == qa) & (mb < qb))
        go_right = active & lt
        low = np.where(go_right, mid + 1, low)
        high = np.where(active & ~go_right, mid, high)
    return low
