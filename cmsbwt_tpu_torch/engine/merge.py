"""Output merge: interleave tail runs with head chars per reference-SA-rank
bucket and emit the collection BWT, plain (ref ``CMS-BWT-functions.cpp:
939-1002``) or run-length encoded (ref ``:1003-1085``) — the port's copy of
cmsbwt_tpu/engine/merge.py: the host merge's run assembly, and the numpy
writers used when the native IO runtime (io/native.py) cannot be built.

Represented as a run list (length, char) assembled per bucket:

* prelude: BWTheads[0..D-2] (separator-prefixed suffixes sort first, ref :946)
* tails-only bucket at SA rank i: one run (buckets[i], refBWT[i])
* mixed bucket: per class slot: (counterSmallerThanHead[slot], refBWT[i]) then
  the next head char; after the classes, the residual tails.

The plain writer emits the residual once per bucket (ref :986-994). The RLE
writer of the reference instead emits, after *every* class, a run equal to
the not-yet-emitted entry count of the bucket without consuming it
(ref :1069-1078 — the residual block sits inside the subBucket loop and
``bucketsForExpandedBWT[i]`` is never zeroed). For multi-class mixed buckets
the two outputs therefore differ; ``rle_quirk=True`` replicates that
behavior byte-for-byte, ``False`` emits RLE(plain).
"""
from __future__ import annotations

import numpy as np

from ..index.host import ReferenceIndex
from .heads import ClassArrays
from .ranking import RankedHeads


def bucket_counts(index: ReferenceIndex, ms_pos: np.ndarray,
                  is_head: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per reference text position: (#heads, #tails) (ref
    bucketsForExpandedBWT accounting :368-377, sign-decoded)."""
    n = index.n
    heads_cnt = np.bincount(ms_pos[is_head], minlength=n).astype(np.int64)
    tails_cnt = np.bincount(ms_pos[~is_head], minlength=n).astype(np.int64)
    return heads_cnt, tails_cnt


def build_runs(index: ReferenceIndex, classes: ClassArrays,
               ranked: RankedHeads, counter: np.ndarray,
               tails_cnt: np.ndarray,
               d: int, rle_quirk: bool) -> tuple[np.ndarray, np.ndarray]:
    """Assemble the output as (run_len int64[], run_char uint8[]) — fully
    vectorized (no per-bucket loop).

    Run layout per SA rank i in [1, n):

    * tails-only bucket: one run (tails, refBWT[i]); zero-length runs are
      RETAINED in the returned arrays — every writer skips them;
    * mixed bucket, per class in map order: per slot [counter run, head
      char], then one residual-style run — per class with ``rle_quirk``
      (the reference RLE writer's phantom residual, ref :1069-1078, length
      = remaining un-emitted entries, not consumed), or only after the last
      class without (the plain writer's single residual, ref :986-994).

    With ``rle_quirk`` the per-class phantom residual runs of the reference
    RLE writer are inserted (they add bytes, exactly as the reference does).
    """
    n = index.n
    sa = index.sa.astype(np.int64)
    ref_bwt = index.bwt

    sa_ord = ranked.sa_ord  # cached SA-walk order (ranking pass)
    ecls = sa_ord[1:]                         # emission order, pseudo dropped
    nec = len(ecls)
    m_c = classes.size[ecls].astype(np.int64)
    base_c = ranked.slot_base[ecls].astype(np.int64)
    bucket_rank = index.isa[classes.pos[ecls]].astype(np.int64)

    # group emission classes into buckets (bucket_rank ascending)
    new_b = np.ones(nec, dtype=bool)
    new_b[1:] = bucket_rank[1:] != bucket_rank[:-1]
    bucket_id = np.cumsum(new_b) - 1
    nb = int(bucket_id[-1]) + 1 if nec else 0
    b_rank = bucket_rank[new_b]               # SA rank per mixed bucket
    b_char = ref_bwt[b_rank]
    hb = np.bincount(bucket_id, weights=m_c, minlength=nb).astype(np.int64)
    ncls_b = np.bincount(bucket_id, minlength=nb).astype(np.int64)
    b_total = hb + tails_cnt[sa[b_rank]]

    # per-SA-rank run counts and offsets (prelude occupies [0, d-1))
    runs_per_rank = np.ones(n - 1, dtype=np.int64)
    runs_mixed = 2 * hb + (ncls_b if rle_quirk else 1)
    runs_per_rank[b_rank - 1] = runs_mixed
    offsets = np.empty(n - 1, dtype=np.int64)
    np.cumsum(runs_per_rank[:-1], out=offsets[1:])
    offsets[0] = 0
    offsets += d - 1
    total_runs = int(d - 1 + runs_per_rank.sum())

    run_len = np.zeros(total_runs, dtype=np.int64)
    run_char = np.zeros(total_runs, dtype=np.uint8)

    # prelude: head BWT chars of the D-1 separator suffixes (ref :946)
    run_len[: d - 1] = 1
    run_char[: d - 1] = ranked.bwt_heads[: d - 1]

    # simple buckets: one tails run each
    simple = np.ones(n - 1, dtype=bool)
    simple[b_rank - 1] = False
    s_off = offsets[simple]
    run_len[s_off] = tails_cnt[sa[1:][simple]]
    run_char[s_off] = ref_bwt[1:][simple]

    if nec:
        # class-level bookkeeping
        first_of_b = np.nonzero(new_b)[0]
        k_c = np.arange(nec) - np.repeat(first_of_b, ncls_b)  # class idx in bucket
        ex_mc = np.concatenate([[0], np.cumsum(m_c)[:-1]])
        mc_before = ex_mc - np.repeat(ex_mc[new_b], ncls_b)
        cls_start = offsets[bucket_rank - 1] + 2 * mc_before + \
            (k_c if rle_quirk else 0)

        # slot-level expansion (emission order): one native OpenMP pass
        # writes every [counter run, head char] pair and returns per-class
        # counter sums
        tot_slots = int(m_c.sum())
        from ..io.native import expand_slots_native
        csum_c = expand_slots_native(
            m_c, ex_mc, base_c, cls_start, counter, b_char[bucket_id],
            ranked.bwt_heads[d - 1: d - 1 + tot_slots], run_len, run_char)
        if csum_c is None:
            # numpy fallback. Per-slot indices advance by a constant stride
            # within a class, so they are cumsums of a step array with
            # C-sized corrections at class starts — cheaper than the
            # arange/repeat/gather formulation at tens of millions of slots.
            def strided(start_c, stride):
                # value at slot s of class c: start_c[c] + stride*(s - ex_mc[c])
                step = np.full(tot_slots, stride, dtype=np.int64)
                step[0] = start_c[0]
                step[ex_mc[1:]] = start_c[1:] - (
                    start_c[:-1] + stride * (m_c[:-1] - 1))
                return np.cumsum(step)

            slot_text = strided(base_c, 1)
            ridx_tail = strided(cls_start, 2)
            run_len[ridx_tail] = counter[slot_text]
            run_char[ridx_tail] = np.repeat(b_char[bucket_id], m_c)
            run_len[ridx_tail + 1] = 1
            run_char[ridx_tail + 1] = ranked.bwt_heads[
                d - 1: d - 1 + tot_slots]

            # per-class counter sums: segmented sums over the text-layout
            # slot ranges [base_c, base_c + m_c) via one cumsum
            cs = np.concatenate([[0], np.cumsum(counter[slot_text])])
            csum_c = cs[ex_mc + m_c] - cs[ex_mc]
        inc = csum_c + m_c
        cum_inc = np.cumsum(inc)
        cum_inc_b = cum_inc - np.repeat(
            np.concatenate([[0], np.cumsum(inc)[:-1]])[new_b], ncls_b)
        if rle_quirk:
            # phantom residual after *every* class (ref :1069-1078): length
            # = not-yet-emitted count, not consumed
            rem = b_total[bucket_id] - cum_inc_b
            ridx_rem = cls_start + 2 * m_c
            run_len[ridx_rem] = rem
            run_char[ridx_rem] = b_char[bucket_id]
        else:
            # one true residual per bucket (ref :986-994)
            last_of_b = np.nonzero(new_b)[0] + ncls_b - 1
            rem_b = b_total - cum_inc_b[last_of_b]
            ridx_rem = offsets[b_rank - 1] + 2 * hb
            run_len[ridx_rem] = rem_b
            run_char[ridx_rem] = b_char

    # zero-length runs are skipped by every writer (native writers test
    # per-run; the numpy fallbacks filter below), so no compaction pass here
    return run_len, run_char


def runs_to_plain(run_len: np.ndarray, run_char: np.ndarray) -> bytes:
    keep = run_len > 0
    return np.repeat(run_char[keep], run_len[keep]).tobytes()


def runs_to_rle(run_len: np.ndarray, run_char: np.ndarray) -> bytes:
    """Merge adjacent equal-char runs, emit (uint64 len, uint8 char) records
    (ref :1003-1085; the initial prevChar=0/runLength=0 state never emits an
    empty first record because BWT chars are >= 2)."""
    keep = run_len > 0
    run_len = run_len[keep]
    run_char = run_char[keep]
    if len(run_len) == 0:
        return b"\x00" * 8 + b"\x00"  # ref writes the (0, 0) initial state
    new = np.ones(len(run_char), dtype=bool)
    new[1:] = run_char[1:] != run_char[:-1]
    gid = np.cumsum(new) - 1
    merged_len = np.zeros(int(gid[-1]) + 1, dtype=np.int64)
    np.add.at(merged_len, gid, run_len)
    merged_len = merged_len.astype(np.uint64)
    merged_char = run_char[new]
    out = np.zeros(len(merged_len) * 9, dtype=np.uint8)
    out[: len(merged_len) * 9].reshape(-1, 9)[:, :8] = (
        merged_len[:, None] >> (8 * np.arange(8, dtype=np.uint64))[None, :]
    ).astype(np.uint8)
    out.reshape(-1, 9)[:, 8] = merged_char
    return out.tobytes()
