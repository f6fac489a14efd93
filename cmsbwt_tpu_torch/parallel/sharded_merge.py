"""Sharded downstream merge: head fixup -> grouping -> ranking -> tail
positioning -> run assembly over a group of ranks, no stage gathering the
head records to one device — the counterpart of
cmsbwt_tpu/parallel/sharded_merge.py, stage by stage (the reference
semantics of engine/device_merge.py, ref CMS-BWT-functions.cpp:566-1085),
on the primitives of parallel/dist.py:

* every sorted join is a sample sort ``dsort`` whose bucket exchange is
  the all-to-all reshard (the distributed (pos, idx) head sort of ref
  :588-593 and the tail-bucket reshard of ref :1517-1603);
* every global scan is a local scan plus the other ranks' prefix;
* the tail slot counters accumulate per rank and combine by routed
  scatter-add;
* each rank's slice of the run list goes to rank 0 as it is.

Domains (regular layout, rank r owns rows [r*local, (r+1)*local)):
  H — heads and classes        (lh rows per rank, R*lh >= h + 2)
  N — reference positions      (ln_ rows per rank, R*ln_ >= n + 2)
  P — expanded tail pairs      (lp rows per rank)
  J — tail joins (H ++ P, or H ++ M, concatenated per rank)
  E — run-emission lanes (4 x H ++ N concatenated per rank)

All arithmetic is int64, as in the JAX stages: the sharded merge is also
the route for collections past the int32 device merge's bound (sn is
uint64 in the reference, CMS-BWT.h:26,46).

Not ported, each a TPU workaround: the prewarm wave, the exchange
capacity factor and its memo (exact splits cannot overflow), and the
1-byte packed tier download.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import count, span
from . import distributed
from .dist import (all_sum, bcast_object, dcummax, dcummin_rev,
                   dcumsum, dgather, dscatter, dscatter_rows, dshift, dsort,
                   gather_rows, shard)

I64 = torch.int64
BIG = 1 << 62

W = torch.where


def _z(k: int, g, fill=0):
    return torch.full((k,), fill, dtype=I64, device=g.device)


def _bcast0(g, vals) -> int:
    """Global row 0's value (rank 0's first row) on every rank."""
    return int(bcast_object(g, int(vals[0]) if g.rank == 0 else None))


# ---------------------------------------------------------------------------
# Stage 1+2+3a: fixup, grouping, class ranks (H + N domains)
# ---------------------------------------------------------------------------

def _fixup(g, t, pos, ln, h: int, ref_isa):
    """to_next / isa_next / succ per head (ref :566-586)."""
    lh, ln_, R = t.shape[0], ref_isa.shape[0], g.size
    idx = g.gidx(lh)
    G = lh * R
    valid = idx < h
    ends = W(valid, t + ln, BIG)
    pseudo = valid & (ln == 0)
    barrier = dcummin_rev(g, W(pseudo, idx, G))
    ends_nxt = dshift(g, ends, 1, BIG + 1)
    is_run_end = ends_nxt != ends
    run_end = dcummin_rev(g, W(is_run_end, idx, G))
    j = torch.minimum(run_end + 1, barrier)
    j = W(pseudo, idx, j)
    t_nxt = dshift(g, t, 1, 0)
    to_next = W(valid & (ln > 0), t_nxt - t - 1, 0)
    pt = dgather(g, torch.stack([pos, t], 1), j, 0)
    img = pt[:, 0] + (ends - pt[:, 1])
    isa_next = W(valid, dgather(g, ref_isa, torch.clamp(img, 0, ln_ * R - 1),
                                0), 0)
    return to_next, isa_next, j


def _tail_counts(g, pos, to_next, h: int, ln_: int):
    """Tails per reference position (difference array over N, ref
    :368-377)."""
    lh = pos.shape[0]
    valid = (g.gidx(lh) < h) & (to_next > 0)
    hp = W(valid, pos + 1, -1)
    diff = dscatter(g, _z(ln_, g), torch.cat([hp, W(valid, hp + to_next, -1)]),
                    torch.cat([_z(lh, g, 1), _z(lh, g, -1)]), "add")
    return dcumsum(g, diff)


def _group(g, t, pos, ln, smaller, to_next, isa_next, h: int, n: int):
    """Class grouping (ref :594-603, match.h:27-33)."""
    lh = t.shape[0]
    idx = g.gidx(lh)
    G = lh * g.size
    valid = idx < h
    scale = n + 1
    pk_li = W(valid, ln * scale + isa_next, BIG)
    key1 = W(valid, pos, BIG)
    (k_p, k_li), (order, ln_s, isa_s) = dsort(
        g, [key1, pk_li], [idx, ln, isa_next], BIG)
    prev_p = dshift(g, k_p, -1, -1)
    prev_li = dshift(g, k_li, -1, -1)
    valid_s = idx < h
    firsts = ((k_p != prev_p) | (k_li != prev_li)) & valid_s
    n_classes = all_sum(g, firsts.sum())
    gid = dcumsum(g, firsts.to(I64)) - 1
    # compact class firsts
    _, (fi, cls_pos, cls_len, cls_isa, first_head) = dsort(
        g, [W(firsts, idx, BIG)], [idx, k_p, ln_s, isa_s, order], BIG)
    cvalid = idx < n_classes
    su = dgather(g, torch.stack([smaller.to(I64), to_next], 1), first_head, 0)
    cls_smaller = W(cvalid, su[:, 0], 0) != 0
    cls_until = W(cvalid, su[:, 1], 0)
    fi_nxt = dshift(g, fi, 1, 0)
    cls_size = W(cvalid, W(idx + 1 < n_classes, fi_nxt, h) - fi, 0)
    key_k = W(cls_smaller, cls_len, 2 * n - cls_len)
    key_k = W(cvalid, key_k, BIG)

    # text order (pos, K, isaNext)
    pk_ki = W(cvalid, key_k * scale + cls_isa, BIG)
    cpos_key = W(cvalid, cls_pos, BIG)
    (tpos, _), (torder, tlen, tisa, tsml, tuntil, tsize, tkk) = dsort(
        g, [cpos_key, pk_ki],
        [idx, cls_len, cls_isa, cls_smaller.to(I64), cls_until, cls_size,
         key_k], BIG)
    # rank of each grouped-order class in text order
    _, (text_rank,) = dsort(g, [W(idx < n_classes, torder, BIG)], [idx], BIG)
    # members regrouped by text-ordered class (stable keeps idx order)
    mkey = W(valid_s, dgather(g, text_rank, torch.clamp(gid, 0, G - 1), 0),
             BIG)
    _, (member_head,) = dsort(g, [mkey], [order], BIG)
    member_off = dcumsum(g, tsize) - tsize
    return dict(n_classes=n_classes, pos=tpos, length=tlen, isa_next=tisa,
                smaller=tsml != 0, until_next=tuntil, size=tsize,
                key_k=tkk, member_head=member_head, member_off=member_off)


def _class_ranks(g, cls, ref_isa, h: int, d: int, n: int):
    """rankToHead + SA-walk class order (ref :627-645)."""
    lh, ln_ = cls["pos"].shape[0], ref_isa.shape[0]
    idx = g.gidx(lh)
    G = lh * g.size
    cvalid = idx < cls["n_classes"]
    isa_pos = W(cvalid, dgather(g, ref_isa, torch.clamp(
        cls["pos"], 0, ln_ * g.size - 1), 0), BIG)
    pk = W(cvalid, cls["key_k"] * (n + 1) + cls["isa_next"], BIG)
    _, (sa_ord,) = dsort(g, [isa_pos, pk], [idx], BIG)
    rank_value = dscatter(g, _z(lh, g), W(cvalid, sa_ord, -1),
                          W(cvalid, idx + d, 0), "set")
    pseudo_cls = _bcast0(g, sa_ord)
    mvalid = idx < h
    starts = dscatter(g, _z(lh, g),
                      W(cvalid & (cls["size"] > 0), cls["member_off"], -1),
                      idx + 1, "max")
    cls_of_slot = dcummax(g, starts) - 1
    csl = torch.clamp(cls_of_slot, 0, G - 1)
    within = idx - dgather(g, cls["member_off"], csl, 0)
    mrank = W(cls_of_slot == pseudo_cls, 1 + within,
              dgather(g, rank_value, csl, 0))
    mrank = W(mvalid, mrank, 0)
    rank_to_head = dscatter(g, _z(lh, g),
                            W(mvalid, cls["member_head"], -1), mrank, "set")
    # terminator slot h keeps 0 (zeros base; member_head < h)
    return rank_to_head, sa_ord, cls_of_slot


# ---------------------------------------------------------------------------
# Stage 3b: head-string suffix sort (ref :648, libsais_int) over the ranks
# ---------------------------------------------------------------------------

def _dist_suffix_sort(g, s_vals, length: int, rounds: int):
    """ISA of the integer string s (rows >= length get distinct ascending
    symbols above every real one, so they resolve at once and sort to the
    top); the doubling rounds stop once every rank is distinct."""
    lh = s_vals.shape[0]
    idx = g.gidx(lh)
    G = lh * g.size
    sym = W(idx < length, s_vals, BIG // 2 + idx)

    def rerank(k1, k2):
        (m1, m2), (mi,) = dsort(g, [k1, k2], [idx], BIG)
        changed = (m1 != dshift(g, m1, -1, -7)) | (m2 != dshift(g, m2, -1, -7))
        ndist = all_sum(g, changed.sum())
        r = dcumsum(g, changed.to(I64)) - 1
        return dscatter(g, _z(lh, g), mi, r, "set"), ndist

    rank, ndist = rerank(sym, _z(lh, g))
    for k in range(rounds):
        if ndist >= G:
            break
        rank, ndist = rerank(rank, dshift(g, rank, 1 << k, -1))
    return rank  # ISA over the padded domain


def _head_string_sa(g, rank_to_head, h: int, rounds: int):
    """head_to_rank: SA of the rank string compacted to the real suffixes
    (first h+1 entries real; ref :648-665)."""
    lh = rank_to_head.shape[0]
    idx = g.gidx(lh)
    isa = _dist_suffix_sort(g, rank_to_head, h + 1, rounds)
    sa = dscatter(g, _z(lh, g), isa, idx, "set")
    _, (head_to_rank,) = dsort(g, [W(sa <= h, idx, BIG)], [sa], BIG)
    return head_to_rank


def _rank_heads(g, cls, head_to_rank, char, succ, h: int):
    """Final ranks, head BWT, successor re-rank (ref :661-687)."""
    lh = succ.shape[0]
    idx = g.gidx(lh)
    G = lh * g.size
    valid = idx < h
    sa_body = dshift(g, head_to_rank, 1, 0)
    final_rank = dscatter(g, _z(lh, g), W(valid, sa_body, -1), idx, "set")
    bwt_heads = dgather(g, char, torch.clamp(sa_body, 0, G - 1), 0)
    succ_rank = dgather(g, final_rank, torch.clamp(succ, 0, G - 1), 0)
    member_rank = dgather(g, succ_rank,
                          torch.clamp(cls["member_head"], 0, G - 1), 0)
    pk = W(valid, cls["cls_of_slot"] * (G + 2) + member_rank, BIG)
    _, (member_rank_sorted,) = dsort(g, [pk], [member_rank], BIG)
    return final_rank, bwt_heads, succ_rank, member_rank_sorted


# ---------------------------------------------------------------------------
# Stage 4: tail positioning (ref :1517-1603)
# ---------------------------------------------------------------------------

def _tail_pairs_count(g, cls):
    """Buckets + per-class interesting-bucket ranges."""
    lh = cls["pos"].shape[0]
    idx = g.gidx(lh)
    cvalid = idx < cls["n_classes"]
    pos = cls["pos"]
    new_b = (pos != dshift(g, pos, -1, -5)) & cvalid
    n_buckets = all_sum(g, new_b.sum())
    bid = dcumsum(g, new_b.to(I64)) - 1
    _, (bucket_pos, cls_lo) = dsort(g, [W(new_b, idx, BIG)], [pos, idx], BIG)
    bvalid = idx < n_buckets
    cls_lo_nxt = dshift(g, cls_lo, 1, 0)
    cls_hi = W(bvalid, W(idx + 1 < n_buckets, cls_lo_nxt, cls["n_classes"]),
               0)
    bp = W(bvalid, bucket_pos, BIG)
    lo = _lower_bound_join(g, bp, n_buckets, W(cvalid, pos + 1, BIG))
    hi = _lower_bound_join(g, bp, n_buckets,
                           W(cvalid, pos + cls["until_next"] + 1, BIG))
    cnt = W(cvalid, torch.clamp(hi - lo, min=0), 0)
    return dict(bucket_pos=bucket_pos, n_buckets=n_buckets, cls_lo=cls_lo,
                cls_hi=cls_hi, bucket_of_class=bid, pair_lo=lo,
                pair_cnt=cnt, total=all_sum(g, cnt.sum()))


def _lower_bound_join(g, sorted_vals, n_valid: int, queries):
    """Index of the first sorted_vals[j] >= queries[i]: one dsort of
    targets + queries (2*lh rows per rank), reverse fill, route back."""
    lh = sorted_vals.shape[0]
    idx = g.gidx(lh)
    # the key packs the tie flag low (queries sort before equal targets)
    keys = torch.cat([W(sorted_vals < BIG, sorted_vals * 2 + 1, BIG),
                      W(queries < BIG, queries * 2, BIG)])
    (k_s,), (i_s, f_s) = dsort(
        g, [keys], [torch.cat([idx, idx]),
                    torch.cat([_z(lh, g, 1), _z(lh, g, 0)])], BIG)
    tgt = dcummin_rev(g, W((f_s == 1) & (k_s < BIG), i_s, BIG))
    qk2 = W((f_s == 0) & (k_s < BIG), i_s, BIG)
    _, (ans,) = dsort(g, [qk2], [torch.clamp(tgt, max=n_valid)], BIG)
    return _shrink_to(g, ans, lh)


def _shrink_to(g, vals, ldst: int):
    """(lsrc,)-per-rank regular layout -> (ldst,) regular layout keeping
    global rows [0, ldst*R)."""
    idx = g.gidx(vals.shape[0])
    return dscatter(g, _z(ldst, g), W(idx < ldst * g.size, idx, -1), vals,
                    "set")


def _tail_good(g, cls, pairs, slot_base, n: int, lp: int):
    """Expand (class, bucket) pairs, lower_bound each query key in its
    bucket via one global sorted join, credit the good path."""
    lh = slot_base.shape[0]
    R = g.size
    idx_h = g.gidx(lh)
    idx_p = g.gidx(lp)
    G_H = lh * R
    cvalid = idx_h < cls["n_classes"]
    cnt = pairs["pair_cnt"]
    off = dcumsum(g, cnt) - cnt
    pvalid = idx_p < pairs["total"]
    # segment-expand the source class (P domain): each class's id at its
    # first pair, a running max, then one 5-channel gather of its
    # attributes. (The JAX stage forward-fills the attributes packed
    # behind the pair offset, (off + 1) << 33 | payload: the same values
    # for fewer than 2^30 pairs.)
    live_c = cvalid & (cnt > 0)
    starts = dscatter(g, _z(lp, g), W(live_c, off, -1), idx_h + 1, "max")
    src_cls = torch.clamp(dcummax(g, starts) - 1, 0, G_H - 1)
    del starts
    att = dgather(g, torch.stack([pairs["pair_lo"] - off,
                                  cls["length"] + cls["pos"],
                                  cls["smaller"].to(I64), cls["isa_next"],
                                  cls["size"]], 1), src_cls, 0)
    b = dgather(g, pairs["bucket_pos"],
                torch.clamp(idx_p + att[:, 0], 0, G_H - 1), 0)
    q_len = att[:, 1] - b
    q_small = att[:, 2] != 0
    q_isa = att[:, 3]
    q_size = att[:, 4]
    del att
    q_k = W(q_small, q_len, 2 * n - q_len)

    scale = n + 1
    t_k2 = W(cvalid, cls["key_k"] * scale + cls["isa_next"], BIG)
    q_k2 = W(pvalid, q_k * scale + q_isa, BIG)
    key1 = torch.cat([W(cvalid, cls["pos"], BIG), W(pvalid, b, BIG)])
    key2f = torch.cat([W(cvalid, (t_k2 << 1) | 1, BIG),
                       W(pvalid, q_k2 << 1, BIG)])
    del b, q_len, q_small, q_isa, q_k, t_k2, q_k2
    (k1s, k2fs), (i_s, pay_s) = dsort(
        g, [key1, key2f], [torch.cat([idx_h, idx_p]),
                           torch.cat([slot_base, q_size])], BIG)
    del key1, key2f, q_size
    f_s = W(k2fs >= BIG, 2, k2fs & 1)   # pads are neither side
    k2s = k2fs >> 1
    del k2fs
    lj = lh + lp
    rows = g.gidx(lj)
    G_J = lj * R
    # the nearest target row at or after each row, and its (pos, class):
    # one reverse min and one routed gather (the JAX stage packs
    # (row << 34) | payload into its reverse fill, which needs fewer than
    # 2^29 join rows)
    t_row = dcummin_rev(g, W(f_s == 1, rows, BIG))
    tgt = dgather(g, torch.stack([k1s, i_s], 1), t_row, -1)
    f_pos, f_cls = tgt[:, 0], tgt[:, 1]
    del tgt
    change_next = (dshift(g, k1s, 1, -3) != k1s) | (dshift(g, k2s, 1, -3)
                                                     != k2s)
    del k2s
    run_end = dcummin_rev(g, W(change_next, rows, G_J))
    del change_next
    in_range_s = (f_s == 0) & (f_pos == k1s) & (k1s < BIG)
    del f_pos, k1s
    exact_s = in_range_s & (t_row <= run_end)
    del t_row, run_end
    good_s = in_range_s & ~exact_s
    del in_range_s
    # good credit: cumsum difference at unique target rows
    gcum = dcumsum(g, W(good_s, pay_s, 0))
    del good_s
    prev_t = dshift(g, dcummax(g, W(f_s == 1, rows, -1)), -1, -1)
    base_cum = W(prev_t >= 0, dgather(g, gcum, torch.clamp(prev_t, 0,
                                                           G_J - 1), 0), 0)
    del prev_t
    credit = gcum - base_cum
    del gcum, base_cum
    is_t = f_s == 1
    counter = dscatter(g, _z(lh, g), W(is_t, pay_s, -1), W(is_t, credit, 0),
                       "add")
    n_exact = all_sum(g, exact_s.sum())
    exact_members = all_sum(g, W(exact_s, pay_s, 0).sum())
    # compact exact pairs (pair idx, found class) back into the P domain
    _, (e_pidx, e_fnd) = dsort(g, [W(exact_s, i_s, BIG)], [i_s, f_cls], BIG)
    return (counter, n_exact, exact_members, _shrink_to(g, e_pidx, lp),
            _shrink_to(g, e_fnd, lp), src_cls)


def _tail_exact(g, cls, pairs, slot_base, member_rank_sorted, cls_of_slot,
                e_pidx, e_fnd, src_cls, n_exact: int, h: int, lm: int):
    """Exact-key (counterBad) member-merge path (ref :1567-1589)."""
    lh, lp, R = slot_base.shape[0], e_pidx.shape[0], g.size
    idx_e = g.gidx(lp)
    idx_m = g.gidx(lm)
    G_H = lh * R
    evalid = idx_e < n_exact
    e_src = dgather(g, src_cls, torch.clamp(e_pidx, 0, lp * R - 1), 0)
    msz = W(evalid, dgather(g, cls["size"], torch.clamp(e_src, 0, G_H - 1),
                            0), 0)
    off = dcumsum(g, msz) - msz
    mvalid = idx_m < all_sum(g, msz.sum())
    starts = dscatter(g, _z(lm, g), W(evalid & (msz > 0), off, -1),
                      idx_e + 1, "max")
    pair_of = torch.clamp(dcummax(g, starts) - 1, 0, lp * R - 1)
    osd = dgather(g, torch.stack([off, e_src, e_fnd], 1), pair_of, 0)
    within = idx_m - osd[:, 0]
    src, dst = osd[:, 1], osd[:, 2]
    sb_src = dgather(g, slot_base, torch.clamp(src, 0, G_H - 1), 0)
    q = dgather(g, member_rank_sorted, torch.clamp(sb_src + within, 0,
                                                   G_H - 1), 0)
    # upper_bound join: targets (class-of-slot, member_rank, slot) vs
    # queries (dst, q); equal targets sort BEFORE the query
    hvalid = g.gidx(lh) < h
    WK = G_H + 2
    tkey = W(hvalid, cls_of_slot * WK * 4 + member_rank_sorted * 4 + 1, BIG)
    qkey = W(mvalid, dst * WK * 4 + q * 4 + 2, BIG)
    (k_s,), (i_s, f_s) = dsort(
        g, [torch.cat([tkey, qkey])],
        [torch.cat([g.gidx(lh), idx_m]),
         torch.cat([_z(lh, g, 1), _z(lm, g, 0)])], BIG)
    tgt = dcummin_rev(g, W((f_s == 1) & (k_s < BIG), i_s, BIG))
    qk2 = W((f_s == 0) & (k_s < BIG), i_s, BIG)
    _, (p_slot_j,) = dsort(g, [qk2], [torch.clamp(tgt, 0, G_H - 1)], BIG)
    p_slot = _shrink_to(g, p_slot_j, lm)
    cls_at = dgather(g, cls_of_slot, torch.clamp(p_slot, 0, G_H - 1), -1)
    inb = mvalid & (cls_at == dst)
    boc = dgather(g, pairs["bucket_of_class"], torch.clamp(dst, 0, G_H - 1),
                  0)
    chi = dgather(g, pairs["cls_hi"], torch.clamp(boc, 0, G_H - 1), 0)
    spill_ok = mvalid & ~inb & ((dst + 1) < chi)
    sb_next = dgather(g, slot_base, torch.clamp(dst + 1, 0, G_H - 1), 0)
    # the in-bucket credits and the spills, one routed add
    return dscatter(g, _z(lh, g),
                    torch.cat([W(inb, p_slot, -1), W(spill_ok, sb_next, -1)]),
                    _z(2 * lm, g, 1), "add")


# ---------------------------------------------------------------------------
# Stage 5: run assembly (ref :939-1085 / :1630-1777)
# ---------------------------------------------------------------------------

def _runs_emit(g, cls, sa_ord, slot_base, counter, tails_cnt, bwt_heads,
               ref_sa, ref_isa, ref_bwt, d: int, n: int, rle_quirk: bool):
    """Sorted-emission run assembly; returns this rank's slice of the
    merged global run list (len, char) and the run count n_runs."""
    lh, ln_, R = sa_ord.shape[0], ref_sa.shape[0], g.size
    idx_h = g.gidx(lh)
    idx_n = g.gidx(ln_)
    G_H = lh * R
    G_N = ln_ * R
    nec = cls["n_classes"] - 1
    evalid = idx_h < nec
    ecls = torch.clamp(dshift(g, sa_ord, 1, 0), 0, G_H - 1)
    sp = dgather(g, torch.stack([cls["size"], cls["pos"]], 1), ecls, 0)
    m_c = W(evalid, sp[:, 0], 0)
    bucket_rank = W(evalid, dgather(g, ref_isa, torch.clamp(
        sp[:, 1], 0, G_N - 1), 0), BIG)
    del sp
    new_b = (bucket_rank != dshift(g, bucket_rank, -1, -9)) & evalid
    bid = dcumsum(g, new_b.to(I64)) - 1
    bidc = torch.clamp(bid, 0, G_H - 1)
    # per-rank run counts (N domain)
    hn = dscatter_rows(g, _z(2 * ln_, g).reshape(2, ln_),
                       W(evalid, bucket_rank, -1),
                       torch.stack([m_c, torch.ones_like(m_c)]), "add")
    hb_at, ncls_at = hn[0], hn[1]
    one_cls = torch.clamp(ncls_at, max=1)
    extra = 2 * hb_at + (ncls_at if rle_quirk else one_cls) - one_cls
    rank_valid = (idx_n >= 1) & (idx_n < n)
    runs_per_rank = W(rank_valid, 1 + extra, 0)
    offsets = (dcumsum(g, runs_per_rank) - runs_per_rank) + (d - 1)

    # --- lane sources ---
    # A: prelude BWTheads[0..D-2]
    a_off = idx_h
    a_len = W(idx_h < d - 1, 1, 0)
    a_chr = bwt_heads
    # B: simple buckets
    simple = rank_valid & (extra == 0)
    b_len = W(simple, dgather(g, tails_cnt, torch.clamp(ref_sa, 0, G_N - 1),
                              0), 0)
    b_off = offsets
    b_chr = ref_bwt
    # class-level geometry
    brc = torch.clamp(bucket_rank, 0, G_N - 1)
    bo = dgather(g, torch.stack([ref_bwt, offsets, ref_sa], 1), brc, 0)
    bchar, off_at_br, sa_at_br = bo[:, 0], bo[:, 1], bo[:, 2]
    del bo
    ex_mc = dcumsum(g, m_c) - m_c
    firsts = dscatter_rows(g, _z(2 * lh, g).reshape(2, lh),
                           W(new_b, bid, -1), torch.stack([idx_h, ex_mc]),
                           "set")
    fm = dgather(g, firsts.t().contiguous(), bidc, 0)
    k_c = idx_h - fm[:, 0]
    mc_before = ex_mc - fm[:, 1]
    del firsts, fm
    cls_start = off_at_br + 2 * mc_before + (k_c if rle_quirk else 0)
    # C/D: per member slot
    mvalid = idx_h < all_sum(g, m_c.sum())
    base_c = dgather(g, slot_base, ecls, 0)
    cstart = dscatter(g, _z(lh, g), W(evalid & (m_c > 0), ex_mc, -1),
                      idx_h + 1, "max")
    cls_of = torch.clamp(dcummax(g, cstart) - 1, 0, G_H - 1)
    per = dgather(g, torch.stack([ex_mc, base_c, cls_start, bchar], 1),
                  cls_of, 0)
    within = idx_h - per[:, 0]
    slot_text = torch.clamp(per[:, 1] + within, 0, G_H - 1)
    rt = per[:, 2] + 2 * within
    cnt_slot = dgather(g, counter, slot_text, 0)
    c_off = rt
    c_len = W(mvalid, cnt_slot, 0)
    c_chr = per[:, 3]
    del per
    d_off = rt + 1
    d_len = W(mvalid, 1, 0)
    d_chr = dgather(g, bwt_heads, torch.clamp(d - 1 + idx_h, 0, G_H - 1), 0)
    # E: residuals
    ccnt = dcumsum(g, W(mvalid, cnt_slot, 0))
    csum_hi = dgather(g, ccnt, torch.clamp(ex_mc + m_c - 1, 0, G_H - 1), 0)
    csum_lo = W(ex_mc > 0, dgather(g, ccnt, torch.clamp(ex_mc - 1, 0,
                                                        G_H - 1), 0), 0)
    csum_c = W(evalid & (m_c > 0), csum_hi - csum_lo, 0)
    inc = csum_c + m_c
    cum_inc = dcumsum(g, inc)
    cum_exc_first = dscatter(g, _z(lh, g), W(new_b, bid, -1), cum_inc - inc,
                             "set")
    cum_inc_b = cum_inc - dgather(g, cum_exc_first, bidc, 0)
    hb_b = dscatter(g, _z(lh, g), W(evalid, bid, -1), m_c, "add")
    hb_c = dgather(g, hb_b, bidc, 0)
    b_total = hb_c + dgather(g, tails_cnt, torch.clamp(sa_at_br, 0, G_N - 1),
                             0)
    if rle_quirk:
        e_valid = evalid
        e_off = cls_start + 2 * m_c
    else:
        is_last_of_b = (dshift(g, new_b.to(I64), 1, 0) != 0) | \
            (idx_h + 1 == nec)
        e_valid = evalid & is_last_of_b
        e_off = off_at_br + 2 * hb_c
    e_len = W(e_valid, b_total - cum_inc_b, 0)
    e_chr = bchar

    off = torch.cat([a_off, b_off, c_off, d_off, e_off])
    lens = torch.cat([a_len, b_len, c_len, d_len, e_len])
    chars = torch.cat([a_chr, b_chr, c_chr, d_chr, e_chr])
    le = 4 * lh + ln_
    (k_s,), (len_s, chr_s) = dsort(g, [W(lens > 0, off, BIG)], [lens, chars],
                                   BIG)
    rows = g.gidx(le)
    valid_s = (k_s < BIG) & (len_s > 0)
    prv_chr = dshift(g, chr_s, -1, -1)
    prv_val = dshift(g, valid_s.to(I64), -1, 0) != 0
    nxt_chr = dshift(g, chr_s, 1, -1)
    nxt_val = dshift(g, valid_s.to(I64), 1, 0) != 0
    new_g = valid_s & (~prv_val | (prv_chr != chr_s))
    is_last = valid_s & (~nxt_val | (nxt_chr != chr_s))
    cum = dcumsum(g, len_s)
    exc = cum - len_s
    # exc never decreases, so a running max of the group starts' exc is
    # the latest start's (the JAX stage packs (row << 40) | exc, which
    # needs fewer than 2^23 lanes)
    fe = dcummax(g, W(new_g, exc, -1))
    lenm = W(is_last, cum - fe, 0)
    n_runs = all_sum(g, is_last.sum())
    _, (rl, rc) = dsort(g, [W(is_last, rows, BIG)], [lenm, chr_s], BIG)
    return rl, rc, n_runs


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def _merge_rank(g, inputs):
    """One rank of merge_heads_sharded: ``inputs`` (rank 0's) are the head
    records, the reference index and (h, n, sn, d, rle_quirk)."""
    with span("shm.shard"):
        arrays, meta = inputs if g.rank == 0 else (None, None)
        h, n, sn, d, rle_quirk = bcast_object(g, meta)
        R = g.size
        lh = -(-max(h + 2, 16) // R)
        ln_ = -(-max(n + 2, 16) // R)
        a = arrays or [None] * 8
        t, pos, ln, smaller, char = (shard(g, x, lh, 0, h) for x in a[:5])
        ref_sa, ref_isa, ref_bwt = (shard(g, x, ln_, 0, n) for x in a[5:])
        del arrays, a, inputs
        rounds = 1
        while (1 << rounds) < max(lh * R, 2):
            rounds += 1
    with span("shm.fixup_group"):
        to_next, isa_next, succ = _fixup(g, t, pos, ln, h, ref_isa)
        tails_cnt = _tail_counts(g, pos, to_next, h, ln_)
        cls = _group(g, t, pos, ln, smaller, to_next, isa_next, h, n)
        del t, pos, ln, smaller, to_next, isa_next
    with span("shm.rank_sa"):
        rank_to_head, sa_ord, cls_of_slot = _class_ranks(g, cls, ref_isa, h,
                                                         d, n)
        cls["cls_of_slot"] = cls_of_slot
        head_to_rank = _head_string_sa(g, rank_to_head, h, rounds)
        del rank_to_head
    with span("shm.pairs"):
        _, bwt_heads, _, member_rank_sorted = _rank_heads(
            g, cls, head_to_rank, char, succ, h)
        del head_to_rank, char, succ
        slot_base = cls["member_off"]
        pairs = _tail_pairs_count(g, cls)
    count("shm.tail_pairs", pairs["total"])
    lp = -(-max(pairs["total"], 16) // R)
    with span("shm.tail_good"):
        counter, n_exact, exact_members, e_pidx, e_fnd, src_cls = \
            _tail_good(g, cls, pairs, slot_base, n, lp)
    count("shm.exact", n_exact)
    if n_exact:
        lm = -(-max(exact_members, 16) // R)
        with span("shm.tail_exact"):
            counter = counter + _tail_exact(
                g, cls, pairs, slot_base, member_rank_sorted, cls_of_slot,
                e_pidx, e_fnd, src_cls, n_exact, h, lm)
    del e_pidx, e_fnd, src_cls, member_rank_sorted, pairs
    with span("shm.runs"):
        rl, rc, n_runs = _runs_emit(g, cls, sa_ord, slot_base, counter,
                                    tails_cnt, bwt_heads, ref_sa, ref_isa,
                                    ref_bwt, d, n, rle_quirk)
    count("shm.runs", n_runs)
    with span("shm.gather"):
        le = rl.shape[0]
        mine = min(max(n_runs - g.rank * le, 0), le)
        runs = gather_rows(g, torch.stack([rl, rc], 1), mine)
    if runs is None:
        return None
    runs = runs.cpu().numpy()
    return runs[:, 0].astype(np.int64), runs[:, 1].astype(np.uint8)


def merge_heads_sharded(head_t, head_pos, head_len, head_smaller, head_char,
                        ref_sa, ref_isa, ref_bwt, h: int, n: int, sn: int,
                        d: int, rle_quirk: bool, n_devices: int | None = None,
                        device="cuda"):
    """The full downstream merge over a group of ranks on ``device``: head
    records (stream order, the first h rows) and the reference index (the
    first n rows) as numpy arrays or tensors on any device, held by rank 0;
    (run_len int64, run_char uint8) numpy on rank 0, None on the others.
    Byte-equal to the device and the host merge. The ranks are the
    launcher's, or n_devices (default: the visible cards on cuda, 1 on
    cpu) started here (parallel/distributed.run)."""
    arrays = [head_t, head_pos, head_len, head_smaller, head_char, ref_sa,
              ref_isa, ref_bwt]
    return distributed.run(
        _merge_rank, (arrays, (int(h), int(n), int(sn), int(d),
                               bool(rle_quirk))),
        device, n_devices)
