"""Device-side downstream merge in torch: head fixup -> grouping -> ranking
-> tail positioning -> run assembly, on the device of its inputs — the
counterpart of cmsbwt_tpu/engine/device_merge.py, stage by stage.

Reference semantics mirrored per stage (ref = the C++ CMS-BWT tool):

* fixup           ref CMS-BWT-functions.cpp:566-586   (covering phrase)
* grouping        ref :594-603 + match.h:23-33        (class map + comparator)
* ranking         ref :627-695                        (SA walk + libsais_int)
* tail position   ref :1517-1603                      (incl. counterBad merge)
* run assembly    ref :939-1085 / :1630-1777          (plain + RLE quirk)

Translation rules from the JAX stages:

* a stable ``lax.sort`` becomes ``ops/sort.stable_argsort`` by the same
  keys (or the packed int64 key where the JAX code packs), each key's
  width stated from a bound the stage knows (``key_bits``), and a sort
  that brings flagged rows to the front becomes ``ops/sort.compact``
  given the count of set flags; a sort of a permutation (its inverse)
  becomes one scatter. Each stage reads the sorts' fault word
  (``check_faults``) at its next synchronisation;
* ``.at[].set/add/max(..., mode="drop")`` becomes a masked
  ``index_put_`` / ``scatter_reduce_``: out-of-range and masked lanes are
  filtered first (torch raises where JAX drops), and each scatter names
  its reduction;
* every stage returns the dtypes the JAX stage returns (int32 unless the
  JAX code computes under x64); ``torch.cumsum`` of int32 is cast back;
* ``lax.cummax`` / ``cummin`` and ``_rev_fill_min`` go through
  ``ops/fill.running_fill``; ``tail_good_dev``'s rows before its join
  sort are ``pair_expand``, its pass after the sort ``tail_good_join``,
  ``tail_exact_dev``'s after its join's fill ``exact_credit``,
  ``runs_emit_dev``'s three accumulating scatters ``bucket_sums``
  (segmented sums: its lanes come in bucket order) and its end
  ``run_merge``. Each picks by the device of its tensors: a CUDA kernel
  (``kernels/csrc/running_fill.cu``, ``pair_expand.cu``,
  ``tail_good_join.cu``, ``tail_exact_credit.cu``, ``run_merge.cu``) for
  CUDA tensors, the plain torch version (``running_fill_reference``,
  ``_pair_expand_reference``, ``_tail_good_join_reference``,
  ``_exact_credit_reference``, ``_bucket_sums_reference``,
  ``_run_merge_reference``) for CPU tensors. The head string's suffix
  sort (index/device.suffix_array_device, no history) ranks its rounds
  by ``index/device.dense_rank``.

All indices are int32 (n, sn < 2^31 — the reference's own caps).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.fill import running_fill, running_fill_reference
from ..ops.sort import check_faults, compact, key_bits, stable_argsort
from ..utils.buckets import bucket_size
from ..utils.timing import stage_timer

INT_MAX = 2**31 - 1
I64_BIG = 1 << 62
LOW30 = (1 << 30) - 1
LOW31 = (1 << 31) - 1
I32, I64 = torch.int32, torch.int64

# calls of the plain versions (the CUDA wrappers keep their own launch
# counts)
REFERENCE_CALLS = {"_pair_expand_reference": 0,
                   "_tail_good_join_reference": 0,
                   "_exact_credit_reference": 0, "_bucket_sums_reference": 0,
                   "_run_merge_reference": 0}
# downloads of a merge's run arrays to the host (download_runs): none on
# the device-merge routes, whose runs reach the host only as the output
# file's bytes (io/output.py)
RUN_DOWNLOADS = [0]


def sn_bound() -> int:
    """Collection-size cap of the int32-keyed device merge (and of the
    unblocked device scans); ``CMSBWT_SN_BOUND`` overrides it."""
    return int(os.environ.get("CMSBWT_SN_BOUND", 1 << 31))


# Peak device bytes of merge_device per collection char (torch's
# max_memory_allocated outside the dense scan's blocks, over sn), measured
# on an NVIDIA H100 80GB HBM3, 700 W: 88.3 at the 500 Mchar shape (44.2 GB;
# h = 34.9 M heads, P = 446 M tail pairs); 96 leaves ~8% to spare. With
# the merge's kernels it measured 76.6-76.8 there (38.4 GB), and with its
# sorts on ops/sort 57.5-57.6 (28.8 GB); the ceiling stays at 96 until a
# routing change moves it. The merge is not blocked,
# so this is the card's merge ceiling (~0.88 Gchars on 84 GB free;
# PERF.md): above it merge_backend='auto' takes the host merge.
MERGE_BYTES_PER_CHAR = 96


def merge_fits(sn: int, free_bytes: float) -> bool:
    """The device merge of ``sn`` collection chars fits ``free_bytes`` of
    device memory."""
    return MERGE_BYTES_PER_CHAR * sn <= free_bytes


def merge_memory_check(sn: int, free_bytes: float) -> None:
    """Refuse a device merge that would not fit ``free_bytes`` of device
    memory (asked for with merge_backend='device')."""
    if not merge_fits(sn, free_bytes):
        raise ValueError(
            f"collection has {sn} chars: the device merge needs "
            f"~{MERGE_BYTES_PER_CHAR * sn} B ({MERGE_BYTES_PER_CHAR} B per "
            f"char) and the device has {int(free_bytes)} B free; "
            "merge_backend='host' (or 'auto') merges it on the host")


def _check_sn(sn: int) -> None:
    if sn >= sn_bound():
        raise ValueError(
            f"collection has {sn} chars >= the device merge's int32 bound "
            f"({sn_bound()}): such collections take the blocked dense scan "
            "and the host merge (backend='dense', merge_backend='auto' or "
            "'host')")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _ar(k: int, like: torch.Tensor, dtype=I32) -> torch.Tensor:
    return torch.arange(k, dtype=dtype, device=like.device)


def _cat(*parts) -> torch.Tensor:
    return torch.cat(parts)


def _full(k: int, v, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.full((k,), v, dtype=dtype, device=like.device)


def _w32(c, a, b) -> torch.Tensor:
    return torch.where(c, a, b).to(I32)


def _w64(c, a, b) -> torch.Tensor:
    return torch.where(c, a, b).to(I64)


def _cumsum32(v: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(v, 0).to(I32)


def _cummax(v: torch.Tensor) -> torch.Tensor:
    return running_fill(v, "max")


def _suffix_min(v: torch.Tensor) -> torch.Tensor:
    """Nearest at-or-after fill: running min from the right."""
    return running_fill(v, "min", reverse=True)


def _set(dst, idx, vals, mask):
    """dst[idx] = vals where mask (JAX ``.at[].set``; masked lanes drop)."""
    dst[idx[mask].long()] = vals[mask].to(dst.dtype)
    return dst


def _add(dst, idx, vals, mask):
    """dst[idx] += vals where mask, duplicates accumulate (``.at[].add``)."""
    dst.index_put_((idx[mask].long(),), vals[mask].to(dst.dtype),
                   accumulate=True)
    return dst


def _max(dst, idx, vals, mask):
    """dst[idx] = max(dst[idx], vals) where mask (``.at[].max``)."""
    dst.scatter_reduce_(0, idx[mask].long(), vals[mask].to(dst.dtype),
                        reduce="amax", include_self=True)
    return dst


def _in_range(idx, size):
    return (idx >= 0) & (idx < size)


# ---------------------------------------------------------------------------
# Stage 1: head fixup (ref :566-586) + per-position tail counts (ref :368-377)
# ---------------------------------------------------------------------------

def fixup_dev(t, pos, ln, h: int, ref_isa, h_pad: int):
    """to_next / isa_next / succ per head (int32[h_pad] each)."""
    idx = _ar(h_pad, t)
    valid = idx < h
    ends = _w32(valid, t + ln, INT_MAX)
    pseudo = valid & (ln == 0)
    barrier = _suffix_min(_w32(pseudo, idx, h_pad))
    is_run_end = _cat(ends[1:] != ends[:-1], _full(1, True, torch.bool, t))
    run_end = _suffix_min(_w32(is_run_end, idx, h_pad))
    j = torch.minimum(run_end + 1, barrier)
    j = _w32(pseudo, idx, j)
    t_nxt = _cat(t[1:], t[-1:])
    to_next = _w32(valid & (ln > 0), t_nxt - t - 1, 0)
    jc = torch.clamp(j, 0, h_pad - 1)
    img = pos[jc] + (ends - t[jc])
    isa_next = _w32(valid, ref_isa[torch.clamp(img, 0, ref_isa.shape[0] - 1)],
                    0)
    return to_next, isa_next, j


def tail_counts_dev(pos, to_next, h: int, h_pad: int, n_pad: int):
    """Tails per reference text position, from head spans (difference
    array, add-scatters), int32[n_pad]."""
    idx = _ar(h_pad, pos)
    valid = (idx < h) & (to_next > 0)
    hp = pos + 1
    diff = torch.zeros(n_pad + 2, dtype=I32, device=pos.device)
    ones = torch.ones_like(pos)
    _add(diff, hp, ones, valid & _in_range(hp, n_pad + 2))
    hq = hp + to_next
    _add(diff, hq, -ones, valid & _in_range(hq, n_pad + 2))
    return _cumsum32(diff[:n_pad])


# ---------------------------------------------------------------------------
# Stage 2: class grouping (ref :594-603, match.h:27-33)
# ---------------------------------------------------------------------------

def group_dev(pos, ln, smaller, to_next, isa_next, h: int, n: int,
              h_pad: int) -> dict:
    """Group heads into (pos, len, isaNext) classes; classes come out in
    TEXT order (pos, K, isaNext) with members grouped per class in
    insertion (idx) order."""
    idx = _ar(h_pad, pos)
    valid = idx < h
    pk_li = _w64(valid, (ln.to(I64) << 30) | isa_next.to(I64), I64_BIG)
    key1 = _w32(valid, pos, INT_MAX)
    # by (pos, ln, isa_next), the packed key's fields apart (70 bits, so
    # the sort composes them): a head's match lies in the reference (ln
    # <= n) and isa_next < n
    order, p_s = stable_argsort(
        (key1, _w32(valid, ln, INT_MAX), _w32(valid, isa_next, INT_MAX)),
        (key_bits(n), key_bits(n + 1), key_bits(n)), values=True)
    li_s = pk_li[order]
    new_grp = _cat(_full(1, True, torch.bool, pos),
                   (p_s[1:] != p_s[:-1]) | (li_s[1:] != li_s[:-1]))
    valid_s = idx < h  # sorted: valid entries first
    firsts = new_grp & valid_s
    n_classes = int(firsts.sum())
    check_faults(pos.device)
    gid = _cumsum32(firsts.to(I32)) - 1  # class id, sorted order
    # compact class firsts; payloads packed (pos|head, len|isa)
    perm = compact(firsts, n_classes)
    fi = _w32(idx < n_classes, perm, INT_MAX)
    pay1_s = ((p_s.to(I64) << 31) | order.to(I64))[perm]
    pay2_s = li_s[perm]
    cls_pos = (pay1_s >> 31).to(I32)
    first_head = (pay1_s & LOW31).to(I32)
    cls_len = (pay2_s >> 30).to(I32)
    cls_isa = (pay2_s & LOW30).to(I32)
    cvalid = idx < n_classes
    fh = torch.clamp(first_head, 0, h_pad - 1)
    cls_smaller = cvalid & smaller[fh]
    cls_until = _w32(cvalid, to_next[fh], 0)
    fi_nxt = _cat(fi[1:], fi[-1:])
    cls_size = _w32(cvalid, _w32(idx + 1 < n_classes, fi_nxt, h) - fi, 0)
    key_k = _w32(cls_smaller, cls_len, 2 * n - cls_len)
    key_k = _w32(cvalid, key_k, INT_MAX)

    # text order: (pos, K, isaNext), payloads (order, until), (size, sml)
    pk_ki = _w64(cvalid, (key_k.to(I64) << 30) | cls_isa.to(I64), I64_BIG)
    cpos_key = _w32(cvalid, cls_pos, INT_MAX)
    tpay1 = (idx.to(I64) << 31) | cls_until.to(I64)
    tpay2 = (cls_size.to(I64) << 1) | cls_smaller.to(I64)
    # by (pos, K, isa), the packed key's fields apart: key_k = len or
    # 2n - len lies in [0, 2n]
    perm, tpos = stable_argsort(
        (cpos_key, key_k, _w32(cvalid, cls_isa, INT_MAX)),
        (key_bits(n), key_bits(2 * n + 1), key_bits(n)), values=True)
    tki = pk_ki[perm]
    tpay1_s, tpay2_s = tpay1[perm], tpay2[perm]
    torder = (tpay1_s >> 31).to(I32)
    tuntil = (tpay1_s & LOW31).to(I32)
    tsize = (tpay2_s >> 1).to(I32)
    tsml = (tpay2_s & 1).to(I32)
    tkk_raw = (tki >> 30).to(I32)
    tisa = (tki & LOW30).to(I32)
    tkk = _w32(cvalid, tkk_raw, INT_MAX)
    tlen = _w32(tsml != 0, tkk_raw, 2 * n - tkk_raw)
    # rank of each (grouped-order) class in text order: torder is a
    # permutation, so its inverse is one scatter
    text_rank = torch.empty(h_pad, dtype=I32, device=pos.device)
    text_rank[torder.long()] = idx
    # members regrouped by text-ordered class (stable keeps idx order)
    mkey = _w32(valid_s, text_rank[torch.clamp(gid, 0, h_pad - 1)], INT_MAX)
    member_head = order[stable_argsort((mkey,), (key_bits(h_pad),))]
    member_off = _cumsum32(tsize) - tsize  # exclusive prefix
    return dict(n_classes=n_classes, pos=tpos, length=tlen, isa_next=tisa,
                smaller=tsml != 0, until_next=tuntil, size=tsize,
                key_k=tkk, member_head=member_head, member_off=member_off,
                gid_sorted=gid, order_sorted=order, text_rank=text_rank)


# ---------------------------------------------------------------------------
# Stage 3: ranking (ref :627-695)
# ---------------------------------------------------------------------------

def class_ranks_dev(cls: dict, ref_isa, h: int, d: int, n: int,
                    h_pad: int):
    """rankToHead (text order over head idx, terminator 0 appended) + the
    SA-walk class order. Pseudo class members get ranks 1..D-1 in idx
    order; the class at SA-walk position c >= 1 gets rank D+c-1."""
    cidx = _ar(h_pad, ref_isa)
    cvalid = cidx < cls["n_classes"]
    isa_pos = _w32(cvalid, ref_isa[torch.clamp(cls["pos"], 0,
                                               ref_isa.shape[0] - 1)],
                   INT_MAX)
    pk = _w64(cvalid, cls["key_k"].to(I64) * (n + 1)
              + cls["isa_next"].to(I64), I64_BIG)
    # key_k <= 2n and isa_next < n
    sa_ord = stable_argsort((isa_pos, pk),
                            (key_bits(n), key_bits((2 * n + 1) * (n + 1))))
    # rank_value per text-order class id (sa_ord is a permutation: set)
    rank_value = torch.zeros(h_pad, dtype=I32, device=ref_isa.device)
    rank_value[sa_ord.long()] = _w32(cvalid, cidx + d, 0)
    pseudo_cls = sa_ord[0]
    midx = cidx
    mvalid = midx < h
    # class of each member slot: max-scatter class ids at their offsets
    starts = torch.zeros(h_pad, dtype=I32, device=ref_isa.device)
    _max(starts, torch.clamp(cls["member_off"], 0, h_pad - 1),
         _w32(cvalid & (cls["size"] > 0), cidx + 1, 0),
         torch.ones_like(cvalid))
    cls_of_slot = _cummax(starts) - 1
    csl = torch.clamp(cls_of_slot, 0, h_pad - 1)
    within = midx - cls["member_off"][csl]
    mrank = _w32(cls_of_slot == pseudo_cls, 1 + within, rank_value[csl])
    mrank = _w32(mvalid, mrank, 0)
    # rank_to_head[member_head] = mrank (member heads are distinct: set)
    rank_to_head = torch.zeros(h_pad + 1, dtype=I32, device=ref_isa.device)
    _set(rank_to_head, cls["member_head"], mrank, mvalid)
    rank_to_head[h] = 0
    return rank_to_head, sa_ord, cls_of_slot


def head_string_sa_dev(rank_to_head, h: int, h_pad: int):
    """Suffix sort of the head rank string (replaces libsais_int, ref :648).

    The [0, h] prefix is the real string (terminator 0 at h); positions
    beyond get distinct ascending values above every rank so their suffixes
    resolve immediately and cluster at the top of the SA."""
    from ..index.device import suffix_array_device
    L = h_pad + 1
    idx = _ar(L, rank_to_head)
    s = _w32(idx <= h, rank_to_head, (1 << 30) + idx)
    sa, _, _, _ = suffix_array_device(s, L, bound=(1 << 30) + L,
                                      history=False)
    # compact the real suffixes (sa <= h: h + 1 of them), preserving order
    return sa[compact(sa <= h, h + 1)]


def rank_heads_dev(cls: dict, head_to_rank, char, succ, h: int,
                   h_pad: int):
    """Final ranks, head BWT, successor re-rank, slot layout
    (ref :661-687 + prefixSumForPositions :697-707)."""
    idx = _ar(h_pad, succ)
    valid = idx < h
    sa_body = head_to_rank[1:]  # length h_pad; first h valid
    final_rank = torch.zeros(h_pad, dtype=I32, device=succ.device)
    _set(final_rank, sa_body, idx, valid & _in_range(sa_body, h_pad))
    bwt_heads = char[torch.clamp(sa_body, 0, h_pad - 1)]
    succ_rank = final_rank[torch.clamp(succ, 0, h_pad - 1)]
    member_rank = succ_rank[torch.clamp(cls["member_head"], 0, h_pad - 1)]
    pk = _w64(valid, cls["cls_of_slot"].to(I64) * (h_pad + 2)
              + member_rank.to(I64), I64_BIG)
    # cls_of_slot and member_rank lie in [0, h_pad)
    member_rank_sorted = member_rank[
        stable_argsort((pk,), (key_bits((h_pad + 2) ** 2),))]
    return final_rank, bwt_heads, succ_rank, member_rank_sorted


# ---------------------------------------------------------------------------
# Stage 4: tail positioning (ref :1517-1603) as sorted joins
# ---------------------------------------------------------------------------

def tail_pairs_count_dev(cls: dict, h_pad: int) -> dict:
    """Buckets (distinct head positions) + per-class interesting-bucket
    ranges; ``total`` is the pair count (int)."""
    pos = cls["pos"]
    cidx = _ar(h_pad, pos)
    cvalid = cidx < cls["n_classes"]
    new_b = _cat(_full(1, True, torch.bool, pos), pos[1:] != pos[:-1]) \
        & cvalid
    n_buckets = int(new_b.sum())
    bid = _cumsum32(new_b.to(I32)) - 1  # bucket of class (text order)
    perm = compact(new_b, n_buckets)
    bucket_pos, cls_lo = pos[perm], perm
    bvalid = cidx < n_buckets
    cls_hi = _w32(bvalid, _w32(cidx + 1 < n_buckets,
                               _cat(cls_lo[1:], cls_lo[-1:]),
                               cls["n_classes"]), 0)
    # per class: range of buckets intersecting [pos+1, pos+until]
    lo = _join_lower_bound(_w32(bvalid, bucket_pos, INT_MAX), n_buckets,
                           _w32(cvalid, pos + 1, INT_MAX))
    hi = _join_lower_bound(_w32(bvalid, bucket_pos, INT_MAX), n_buckets,
                           _w32(cvalid, pos + cls["until_next"] + 1,
                                INT_MAX))
    cnt = _w32(cvalid, torch.clamp(hi - lo, min=0), 0)
    total = int(cnt.to(I64).sum())
    check_faults(pos.device)
    return dict(bucket_pos=bucket_pos, n_buckets=n_buckets, cls_lo=cls_lo,
                cls_hi=cls_hi, bucket_of_class=bid, pair_lo=lo,
                pair_cnt=cnt, total=total)


def _join_lower_bound(sorted_vals, n_valid: int, queries):
    """Index of the first sorted_vals[j] >= queries[i] (values
    INT_MAX-padded, ascending), capped at n_valid."""
    j = torch.searchsorted(sorted_vals, queries, side="left").to(I32)
    return torch.clamp(j, max=n_valid)


def pair_expand(cls: dict, pairs: dict, slot_base, n: int, h_pad: int,
                p_pad: int):
    """tail_good's join rows before its sort, on the device of its
    tensors: the CUDA kernel (``kernels/csrc/pair_expand.cu``, given the
    inclusive sum of the classes' pair counts) for CUDA tensors,
    ``_pair_expand_reference`` for CPU tensors. Returns (key1 int32[J],
    key2f int64[J], srcidx int32[J], pay int32[J], src_cls int32[p_pad]),
    J = h_pad + p_pad: the class rows, then the pair rows."""
    dev = slot_base.device.type
    if dev == "cuda":
        from ..kernels import pair_expand_cuda
        return pair_expand_cuda(
            cls["pos"], cls["length"], cls["key_k"], cls["isa_next"],
            cls["size"], cls["smaller"], pairs["pair_lo"],
            _cumsum32(pairs["pair_cnt"]), slot_base[:h_pad],
            pairs["bucket_pos"], int(cls["n_classes"]), int(pairs["total"]),
            n, p_pad)
    if dev == "cpu":
        return _pair_expand_reference(cls, pairs, slot_base, n, h_pad, p_pad)
    raise ValueError(f"pair_expand: unsupported device {dev!r}")


def _pair_expand_reference(cls: dict, pairs: dict, slot_base, n: int,
                           h_pad: int, p_pad: int):
    """Expand the (class, bucket) pairs into the join's rows: targets =
    classes (pos, K*(n+1)+isa), queries = pairs (bucket, the query's
    K*(n+1)+isa); the tie flag (queries before equal targets) is key2's
    low bit; payloads slot_base (targets) and the class size (queries);
    each pair's class (pad pairs take the last class with pairs). Plain
    torch, on any device."""
    REFERENCE_CALLS["_pair_expand_reference"] += 1
    cidx = _ar(h_pad, slot_base)
    cvalid = cidx < cls["n_classes"]
    cnt = pairs["pair_cnt"]
    off = _cumsum32(cnt) - cnt  # exclusive
    pidx = _ar(p_pad, slot_base)
    total = int(pairs["total"])
    pvalid = pidx < total
    # each pair's class: the one whose pair range [off, off + cnt) holds
    # it, found by a binary search over the range ends. (The JAX stage
    # forward-fills packed class attributes over 5 x p_pad int64 rows; at
    # P ~ 4.5e8 pairs those rows and their running max alone would take
    # ~70 GB.)
    c_p = torch.searchsorted(off + cnt, pidx, right=True)
    last = int(torch.nonzero(cnt > 0)[-1]) if total else 0
    c_p = torch.where(pvalid, c_p, last)
    b_idx = (pidx + (pairs["pair_lo"] - off).to(I64)[c_p]).to(I32)
    b = pairs["bucket_pos"][torch.clamp(b_idx, 0, h_pad - 1)]
    del b_idx
    q_len = ((cls["length"].to(I64) + cls["pos"].to(I64))[c_p]
             - b.to(I64)).to(I32)
    q_k = _w32(cls["smaller"][c_p], q_len, 2 * n - q_len)
    del q_len
    q_k2 = _w64(pvalid, q_k.to(I64) * (n + 1)
                + cls["isa_next"][c_p].to(I64), I64_BIG)
    del q_k
    q_size = cls["size"][c_p].to(I32)
    src_cls = c_p.to(I32)
    del c_p
    t_k2 = _w64(cvalid, cls["key_k"].to(I64) * (n + 1)
                + cls["isa_next"].to(I64), I64_BIG)
    key1 = _cat(_w32(cvalid, cls["pos"], INT_MAX), _w32(pvalid, b, INT_MAX))
    del b
    key2f = _cat(_w64(cvalid, (t_k2 << 1) | 1, I64_BIG),
                 _w64(pvalid, q_k2 << 1, I64_BIG))
    del t_k2, q_k2
    return (key1, key2f, _cat(cidx, pidx), _cat(slot_base[:h_pad], q_size),
            src_cls)


def tail_good_dev(cls: dict, pairs: dict, slot_base, h: int, n: int,
                  h_pad: int, p_pad: int):
    """Expand (class, bucket) pairs, lower_bound each query key in its
    bucket via one global sorted join, and credit the good path. Returns
    (counter partial, n_exact, exact_members, exact pairs, src class)."""
    if p_pad + 1 > 1 << 30:
        raise ValueError("pair pack exceeds the 63-bit budget")
    dev = slot_base.device
    # global join: targets = classes, queries = pairs (pair_expand)
    key1, key2f, srcidx, paycat, src_cls = pair_expand(
        cls, pairs, slot_base, n, h_pad, p_pad)
    # bucket and class positions lie below n; key2f below 4(n + 1)^2
    perm, k1s = stable_argsort((key1, key2f),
                               (key_bits(n), key_bits(4 * (n + 1) ** 2)),
                               values=True)
    del key1
    i_s, pay_s = srcidx[perm], paycat[perm]
    del srcidx, paycat
    k2fs = key2f[perm]
    del key2f, perm
    counter, ekey, f_cls, n_exact, exact_members = tail_good_join(
        k1s, k2fs, i_s, pay_s, h_pad)
    check_faults(dev)   # after the join's read of its counts
    del k1s, k2fs, pay_s
    # exact pairs as (pair idx, found class), by pair idx: the sort of
    # ekey (the exact rows' i_s, INT_MAX elsewhere) is the exact rows
    # compacted to the front and sorted by i_s among themselves
    eperm = compact(ekey < INT_MAX, n_exact)[:p_pad]
    del ekey
    head = eperm[:n_exact]
    eperm[:n_exact] = head[stable_argsort((i_s[head],), (key_bits(p_pad),))]
    e_pidx, e_fnd = i_s[eperm], f_cls[eperm]
    return (counter, n_exact, exact_members, e_pidx, e_fnd, src_cls)


def tail_good_join(k1s, k2fs, i_s, pay_s, h_pad: int):
    """The join's pass after its sort, on the device of its tensors: the
    CUDA kernel for CUDA tensors, ``_tail_good_join_reference`` for CPU
    tensors. Returns (counter int32[h_pad + 2], exact_key int32[J], f_cls
    int32[J], n_exact, exact_members)."""
    dev = k1s.device.type
    if dev == "cuda":
        from ..kernels import tail_good_join_cuda
        return tail_good_join_cuda(k1s, k2fs, i_s, pay_s, h_pad)
    if dev == "cpu":
        return _tail_good_join_reference(k1s, k2fs, i_s, pay_s, h_pad)
    raise ValueError(f"tail_good_join: unsupported device {dev!r}")


def _tail_good_join_reference(k1s, k2fs, i_s, pay_s, h_pad: int):
    """Over the J join rows sorted by (k1, k2f) — classes are targets (bit
    0 of k2f set), pairs are queries: each row's nearest at-or-after
    target, the exact test (that target lies in the query's own (k1, k2)
    run) and the good test (it lies later in the same bucket), the good
    path's credit at each target's slot ``pay_s``, and each row's exact
    key (its ``i_s`` if exact, else INT_MAX) and found class ``f_cls``.
    Plain torch throughout (its fills too), on any device."""
    REFERENCE_CALLS["_tail_good_join_reference"] += 1
    dev = k1s.device
    f_s = (k2fs & 1).to(I32)
    k2s = k2fs >> 1
    # nearest at-or-after target's attributes for every row, by packed
    # (row << 31 | payload) suffix minima
    jn_pad = int(k1s.shape[0])
    rowsi = _ar(jn_pad, k1s)
    rows = rowsi.to(I64)
    FILL_BIG = (1 << 62) - 1

    def rev_fill(payload31):
        return running_fill_reference(
            _w64(f_s == 1, (rows << 31) | payload31.to(I64), FILL_BIG),
            "min", reverse=True)

    fp = rev_fill(k1s)
    f_pos = (fp & LOW31).to(I32)
    t_row = (fp >> 31).to(I32)
    del fp
    f_cls = (rev_fill(i_s) & LOW31).to(I32)
    change_next = _cat((k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1]),
                       _full(1, True, torch.bool, k1s))
    del k2s
    run_end = running_fill_reference(_w32(change_next, rowsi, jn_pad),
                                     "min", reverse=True)
    del change_next, rowsi
    is_q = f_s == 0
    # pad rows (class and query alike) carry k1 == INT_MAX and never pass
    in_range_s = is_q & (f_pos == k1s) & (k1s < INT_MAX)
    del is_q, f_pos
    exact_s = in_range_s & (t_row <= run_end)
    del t_row, run_end
    good_s = in_range_s & ~exact_s
    del in_range_s
    # good-path credit: cumsum difference at each target row
    gcum = torch.cumsum(_w64(good_s, pay_s, 0), 0)
    del good_s
    is_t = f_s == 1
    prev_t = _cat(_full(1, -1, I64, gcum),
                  running_fill_reference(_w64(is_t, rows, -1))[:-1])
    del rows
    pt = torch.clamp(prev_t, 0, jn_pad - 1)
    base_cum = _w64(prev_t >= 0, gcum[pt], 0)
    del pt, prev_t
    credit = (gcum - base_cum).to(I32)
    del gcum, base_cum
    counter = torch.zeros(h_pad + 2, dtype=I32, device=dev)
    _add(counter, pay_s, credit, is_t & _in_range(pay_s, h_pad + 2))
    n_exact = int(exact_s.sum())
    exact_members = int(_w64(exact_s, pay_s, 0).sum())
    return (counter, _w32(exact_s, i_s, INT_MAX), f_cls, n_exact,
            exact_members)


def tail_exact_dev(counter_in, cls: dict, pairs: dict, slot_base,
                   member_rank_sorted, cls_of_slot, e_pidx, e_fnd, src_cls,
                   n_exact: int, h: int, h_pad: int, e_pad: int,
                   em_pad: int):
    """Exact-key (counterBad) path: member-wise sorted-list merge
    (ref :1567-1589) as one upper_bound join over the global slot array.
    Returns ``counter_in`` plus this path's credits."""
    dev = counter_in.device
    eidx = _ar(e_pad, counter_in)
    evalid = eidx < n_exact
    ep = torch.clamp(e_pidx[:e_pad], 0, src_cls.shape[0] - 1)
    e_src = src_cls[ep]
    e_fnd = e_fnd[:e_pad]
    msz = _w32(evalid, cls["size"][e_src], 0)
    off = _cumsum32(msz) - msz
    midx = _ar(em_pad, counter_in)
    tot = int(msz.to(I64).sum())
    check_faults(dev)
    mvalid = midx < tot
    starts = torch.zeros(em_pad, dtype=I32, device=dev)
    _max(starts, off, eidx + 1, evalid & (msz > 0) & _in_range(off, em_pad))
    pair_of = torch.clamp(_cummax(starts) - 1, 0, e_pad - 1)
    within = midx - off[pair_of]
    src = e_src[pair_of]
    dst = e_fnd[pair_of]
    q = member_rank_sorted[torch.clamp(slot_base[src] + within, 0,
                                       h_pad - 1)]
    # upper_bound join: targets = (class-of-slot, member rank), queries =
    # (dst, q); equal targets sort BEFORE the query, so the fill lands on
    # the first rank strictly greater
    hvalid = _ar(h_pad, counter_in) < h
    W = (h_pad + 2) * 4
    tkey = _w64(hvalid, cls_of_slot.to(I64) * W
                + member_rank_sorted.to(I64) * 4 + 1, I64_BIG)
    qkey = _w64(mvalid, dst.to(I64) * W + q.to(I64) * 4 + 2, I64_BIG)
    keys = _cat(tkey, qkey)
    flag = _cat(torch.ones(h_pad, dtype=I32, device=dev),
                torch.zeros(em_pad, dtype=I32, device=dev))
    srcidx = _cat(_ar(h_pad, counter_in), midx)
    # tkey and qkey lie below (h_pad + 2) * W; the flag is 0 or 1
    perm = stable_argsort((keys, flag),
                          (key_bits(4 * (h_pad + 2) ** 2), key_bits(2)))
    f_s, i_s = flag[perm], srcidx[perm]
    tgt = _suffix_min(_w32(f_s == 1, i_s, h_pad))
    return exact_credit(counter_in, f_s, i_s, tgt, dst, tot, cls_of_slot,
                        slot_base, pairs["cls_hi"], pairs["bucket_of_class"],
                        h_pad)


def exact_credit(counter_in, f_s, i_s, tgt, dst, tot: int, cls_of_slot,
                 slot_base, cls_hi, bucket_of_class, h_pad: int):
    """The exact path's credit pass after its join's sort and fill, on the
    device of its tensors: the CUDA kernel for CUDA tensors,
    ``_exact_credit_reference`` for CPU tensors. Returns counter_in plus
    this path's credits."""
    dev = f_s.device.type
    if dev == "cuda":
        from ..kernels import tail_exact_credit_cuda
        return tail_exact_credit_cuda(counter_in, f_s, i_s, tgt, dst, tot,
                                      cls_of_slot, slot_base, cls_hi,
                                      bucket_of_class, h_pad)
    if dev == "cpu":
        return _exact_credit_reference(counter_in, f_s, i_s, tgt, dst, tot,
                                       cls_of_slot, slot_base, cls_hi,
                                       bucket_of_class, h_pad)
    raise ValueError(f"exact_credit: unsupported device {dev!r}")


def _exact_credit_reference(counter_in, f_s, i_s, tgt, dst, tot: int,
                            cls_of_slot, slot_base, cls_hi, bucket_of_class,
                            h_pad: int):
    """Each query row of the sorted join (f_s 0; i_s its id) finds its
    slot ``tgt`` (clamped); it credits that slot when the slot lies in its
    destination class ``dst``, else the next class's base slot when that
    class is in the same bucket; every lane that credits nothing adds to
    the dump slot h_pad + 1, as in JAX. Plain torch throughout."""
    REFERENCE_CALLS["_exact_credit_reference"] += 1
    dev = counter_in.device
    em_pad = int(dst.shape[0])
    mvalid = _ar(em_pad, dst) < tot
    # route answers back to query slots (query ids are a permutation)
    is_q = f_s == 0
    p_slot = torch.empty(em_pad, dtype=I32, device=dev)
    p_slot[i_s[is_q].long()] = torch.clamp(tgt, 0, h_pad - 1)[is_q]
    inb = mvalid & (cls_of_slot[p_slot] == dst)
    # lanes that credit nothing add to the dump slot h_pad + 1, as in JAX
    counter = torch.zeros(h_pad + 2, dtype=I32, device=dev)
    ones = torch.ones_like(p_slot)
    at = _w32(inb, p_slot, h_pad + 1)
    _add(counter, at, ones, _in_range(at, h_pad + 2))
    # spill: next class's base slot, only if it exists in the same bucket
    has_next = (dst + 1) < cls_hi[
        torch.clamp(bucket_of_class[dst], 0, h_pad - 1)]
    spill_ok = mvalid & ~inb & has_next
    at = _w32(spill_ok, slot_base[torch.clamp(dst + 1, 0, h_pad - 1)],
              h_pad + 1)
    _add(counter, at, ones, _in_range(at, h_pad + 2))
    return counter_in + counter


# ---------------------------------------------------------------------------
# Stage 5: run assembly (ref :939-1085 / :1630-1777)
# ---------------------------------------------------------------------------

def bucket_lanes(cls: dict, sa_ord, ref_isa, h_pad: int, n_pad: int):
    """runs_emit_dev's class lanes in SA-walk order (the pseudo class
    dropped): returns (nec, evalid, ecls, m_c, bucket_rank, new_b, bid) —
    the valid lanes are the first nec, m_c is each class's size (0 beyond
    nec), bucket_rank its reference rank (INT_MAX beyond nec), new_b marks
    a lane that starts a bucket and bid is its bucket's index."""
    dev = ref_isa.device
    nec = cls["n_classes"] - 1
    evalid = _ar(h_pad, ref_isa) < nec
    ecls = _cat(torch.clamp(sa_ord[1:], 0, h_pad - 1),
                torch.zeros(1, dtype=I32, device=dev))  # drop pseudo
    m_c = _w32(evalid, cls["size"][ecls], 0)
    bucket_rank = _w32(evalid, ref_isa[torch.clamp(cls["pos"][ecls], 0,
                                                   n_pad - 1)], INT_MAX)
    new_b = _cat(_full(1, True, torch.bool, ref_isa),
                 bucket_rank[1:] != bucket_rank[:-1]) & evalid
    bid = _cumsum32(new_b.to(I32)) - 1
    return nec, evalid, ecls, m_c, bucket_rank, new_b, bid


def runs_emit_dev(cls: dict, sa_ord, slot_base, counter, tails_cnt,
                  bwt_heads, ref_sa, ref_isa, ref_bwt, d: int, n: int,
                  h_pad: int, n_pad: int, rle_quirk: bool):
    """Assemble the output run list by sorted emission: every run source
    yields (offset, len, char) lanes, one sort by offset orders them,
    adjacent equal-char runs merge (both writers merge them anyway), and
    the merged list is compacted to the front.

    Returns (run_len int32, run_char uint8, n_runs)."""
    dev = counter.device
    cidx = _ar(h_pad, counter)
    nec, evalid, ecls, m_c, bucket_rank, new_b, bid = bucket_lanes(
        cls, sa_ord, ref_isa, h_pad, n_pad)
    bidc = torch.clamp(bid, 0, h_pad - 1)
    # per-rank run counts: 1 per simple rank; mixed = 2*hb + (ncls | 1)
    hb_at, ncls_at, hb_b, fault = bucket_sums(bucket_rank, bid, m_c, nec,
                                              n_pad)
    one_cls = torch.clamp(ncls_at, max=1)
    extra = 2 * hb_at + (ncls_at if rle_quirk else one_cls) - one_cls
    ridx = _ar(n_pad, counter)
    rank_valid = (ridx >= 1) & (ridx < n)
    runs_per_rank = _w32(rank_valid, 1 + extra, 0)
    offsets = (_cumsum32(runs_per_rank) - runs_per_rank) + (d - 1)

    # --- lane sources (offset, len, char) ---
    # A: prelude BWTheads[0..D-2] (ref :946)
    a_off = cidx
    a_len = (cidx < d - 1).to(I32)
    a_chr = bwt_heads[cidx].to(I32)
    # B: simple buckets — one tails run each
    simple = rank_valid & (extra == 0)
    b_off = offsets
    b_len = _w32(simple, tails_cnt[torch.clamp(ref_sa, 0, n_pad - 1)], 0)
    b_chr = ref_bwt.to(I32)
    # class-level geometry (identical to the runs layout of engine/merge.py)
    brc = torch.clamp(bucket_rank, 0, n_pad - 1)
    bchar = ref_bwt[brc].to(I32)
    first_of_b = _set(torch.zeros(h_pad, dtype=I32, device=dev), bid, cidx,
                      new_b)
    k_c = cidx - first_of_b[bidc]
    ex_mc = _cumsum32(m_c) - m_c
    mc_first = _set(torch.zeros(h_pad, dtype=I32, device=dev), bid, ex_mc,
                    new_b)
    mc_before = ex_mc - mc_first[bidc]
    cls_start = offsets[brc] + 2 * mc_before + (k_c if rle_quirk else 0)
    # C/D: per member slot — tails run + the head's own char
    midx = cidx
    tot_slots = int(m_c.to(I64).sum())
    mvalid = midx < tot_slots
    base_c = slot_base[ecls]
    cstart = _max(torch.zeros(h_pad, dtype=I32, device=dev), ex_mc,
                  cidx + 1, evalid & (m_c > 0) & _in_range(ex_mc, h_pad))
    cls_of = torch.clamp(_cummax(cstart) - 1, 0, h_pad - 1)
    within = midx - ex_mc[cls_of]
    slot_text = torch.clamp(base_c[cls_of] + within, 0, h_pad - 1)
    rt = cls_start[cls_of] + 2 * within
    cnt_slot = counter[slot_text]
    c_off = rt
    c_len = _w32(mvalid, cnt_slot, 0)
    c_chr = bchar[cls_of]
    d_off = rt + 1
    d_len = mvalid.to(I32)
    d_chr = bwt_heads[torch.clamp(d - 1 + midx, 0, h_pad - 1)].to(I32)
    # E: residuals — per class (quirk) / per last class of bucket
    ccnt = _cumsum32(c_len)
    csum_hi = ccnt[torch.clamp(ex_mc + m_c - 1, 0, h_pad - 1)]
    csum_lo = _w32(ex_mc > 0, ccnt[torch.clamp(ex_mc - 1, 0, h_pad - 1)], 0)
    csum_c = _w32(evalid & (m_c > 0), csum_hi - csum_lo, 0)
    inc = csum_c + m_c
    cum_inc = _cumsum32(inc)
    cum_exc_first = _set(torch.zeros(h_pad, dtype=I32, device=dev), bid,
                         cum_inc - inc, new_b)
    cum_inc_b = cum_inc - cum_exc_first[bidc]
    b_total = hb_b[bidc] + tails_cnt[torch.clamp(ref_sa[brc], 0, n_pad - 1)]
    if rle_quirk:
        e_valid = evalid
        e_off = cls_start + 2 * m_c
    else:
        # new_b is False beyond the valid classes, so the shifted flag
        # misses the final class — or it in explicitly
        is_last_of_b = _cat(new_b[1:], _full(1, True, torch.bool, counter)) \
            | (cidx + 1 == nec)
        e_valid = evalid & is_last_of_b
        e_off = offsets[brc] + 2 * hb_b[bidc]
    e_len = _w32(e_valid, b_total - cum_inc_b, 0)
    e_chr = bchar

    off = _cat(a_off, b_off, c_off, d_off, e_off)
    lens = _cat(a_len, b_len, c_len, d_len, e_len)
    chars = _cat(a_chr, b_chr, c_chr, d_chr, e_chr)
    # run offsets are distinct by construction; zero-length and invalid
    # lanes sort to the tail and drop out. A valid lane's offset lies
    # below the run slots, d - 1 + sum(runs_per_rank) <= n + 4 h_pad, so
    # below the lane count
    perm, k_s = stable_argsort((_w32(lens > 0, off, INT_MAX),),
                               (key_bits(off.shape[0]),), values=True)
    len_s, chr_s = lens[perm], chars[perm]
    out = run_merge(k_s, len_s, chr_s)
    # after run_merge's read of the run count
    bucket_sums_check(fault)
    check_faults(dev)
    return out


def bucket_sums(bucket_rank, bid, m_c, nec: int, n_pad: int):
    """runs_emit_dev's per-bucket sums over its class lanes (int32[h_pad]
    each, in SA-walk order, the first ``nec`` valid), on the device of its
    tensors: the CUDA kernel for CUDA tensors, ``_bucket_sums_reference``
    for CPU tensors. Returns (hb_at int32[n_pad], ncls_at int32[n_pad],
    hb_b int32[h_pad], fault int32[1]); bucket_sums_check(fault) raises if
    the lanes were out of order."""
    dev = bucket_rank.device.type
    if dev == "cuda":
        from ..kernels import bucket_sums_cuda
        return bucket_sums_cuda(bucket_rank, bid, m_c, nec, n_pad)
    if dev == "cpu":
        return _bucket_sums_reference(bucket_rank, bid, m_c, nec, n_pad)
    raise ValueError(f"bucket_sums: unsupported device {dev!r}")


def _bucket_sums_reference(bucket_rank, bid, m_c, nec: int, n_pad: int):
    """The three accumulating scatters of JAX's runs_emit_dev: each class's
    size m_c and a count of 1 added at its bucket_rank (every pad lane at
    index 0), and m_c at its bucket ``bid`` (valid lanes only); ``fault``
    sets bit 0 where a valid lane's bucket_rank is below its
    predecessor's, bit 1 where one lies outside [0, n_pad) and bit 2
    where a valid lane's bid is not the count of segment starts (lanes
    whose bucket_rank differs from their predecessor's) up to it less
    one, as the kernel does (whose segmented sums need that order, and
    which writes each bucket's sum at its index among the segments).
    Plain torch, on any device."""
    REFERENCE_CALLS["_bucket_sums_reference"] += 1
    dev = bucket_rank.device
    h_pad = int(bucket_rank.shape[0])
    k = max(nec, 0)
    br = bucket_rank[:k]
    starts = _cat(_full(min(k, 1), True, torch.bool, br), br[1:] != br[:-1])
    fault = (int(bool((br[1:] < br[:-1]).any()))
             | 2 * int(bool(((br < 0) | (br >= n_pad)).any()))
             | 4 * int(bool((bid[:k] != _cumsum32(starts.to(I32)) - 1)
                            .any())))
    evalid = _ar(h_pad, bucket_rank) < nec
    br0 = _w32(evalid, bucket_rank, 0)
    every = torch.ones_like(evalid)
    hb_at = _add(torch.zeros(n_pad, dtype=I32, device=dev), br0, m_c, every)
    ncls_at = _add(torch.zeros(n_pad, dtype=I32, device=dev), br0,
                   torch.ones_like(br0), every)
    hb_b = _add(torch.zeros(h_pad, dtype=I32, device=dev),
                torch.clamp(bid, 0, h_pad - 1), m_c, evalid)
    return hb_at, ncls_at, hb_b, torch.tensor([fault], dtype=I32,
                                              device=dev)


def bucket_sums_check(fault) -> None:
    """Raise if bucket_sums found its lanes out of order (``fault``, its
    fourth output; reading it waits for the kernel)."""
    f = int(fault[0])
    if f & 1:
        raise RuntimeError(
            "runs_emit_dev: bucket_sums found a valid class lane whose "
            "bucket_rank is below its predecessor's (the lanes must come "
            "in SA-walk order); its sums would be wrong")
    if f & 2:
        raise RuntimeError(
            "runs_emit_dev: bucket_sums found a valid class lane whose "
            "bucket_rank lies outside [0, n_pad)")
    if f:
        raise RuntimeError(
            "runs_emit_dev: bucket_sums found a valid class lane whose bid "
            "is not its bucket's index")


def run_merge(k_s, len_s, chr_s):
    """The lanes' merge after the sort by offset, on the device of its
    tensors: the CUDA kernel for CUDA tensors, ``_run_merge_reference``
    for CPU tensors. Returns (run_len int32, run_char uint8, n_runs)."""
    dev = k_s.device.type
    if dev == "cuda":
        from ..kernels import run_merge_cuda
        return run_merge_cuda(k_s, len_s, chr_s)
    if dev == "cpu":
        return _run_merge_reference(k_s, len_s, chr_s)
    raise ValueError(f"run_merge: unsupported device {dev!r}")


def _run_merge_reference(k_s, len_s, chr_s):
    """Adjacent valid lanes (k < INT_MAX, len > 0) of one char merge into
    one run; the runs' lengths and chars, compacted to the front in lane
    order, and their count. Plain torch throughout, on any device."""
    REFERENCE_CALLS["_run_merge_reference"] += 1
    dev = k_s.device
    L = k_s.shape[0]
    rowi = _ar(L, k_s)
    valid_s = (k_s < INT_MAX) & (len_s > 0)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    prv_chr = _cat(_full(1, -1, I32, k_s), chr_s[:-1])
    prv_valid = _cat(no, valid_s[:-1])
    nxt_chr = _cat(chr_s[1:], _full(1, -1, I32, k_s))
    nxt_valid = _cat(valid_s[1:], no)
    new_g = valid_s & (~prv_valid | (prv_chr != chr_s))
    is_last = valid_s & (~nxt_valid | (nxt_chr != chr_s))
    # merged length at each group's last lane: cumsum difference, the
    # group-start exclusive sum forward-filled by a packed cummax
    cum = torch.cumsum(len_s.to(I64), 0)
    exc = cum - len_s
    fe = running_fill_reference(
        _w64(new_g, (rowi.to(I64) << 32) | exc, -1)) & ((1 << 32) - 1)
    lenm = _w32(is_last, cum - fe, 0)
    keep = torch.nonzero(is_last).squeeze(1)
    return lenm[keep], chr_s[keep].to(torch.uint8), int(keep.shape[0])


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def merge_device(head_t, head_pos, head_len, head_smaller, head_char,
                 ref_sa, ref_isa, ref_bwt, h: int, n: int, sn: int, d: int,
                 rle_quirk: bool, want_counter: bool = True):
    """Full downstream merge on the device of its inputs; returns
    (run_len int32[R], run_char uint8[R], counter int64[h+1] numpy or
    None): the runs where they lie on the device (merged, every length > 0
    and neighbouring chars different, as io/output's writers take them;
    download_runs gives them as the host writers take them).

    Inputs: heads padded to h_pad (valid prefix h, stream order), the
    reference index padded to n_pad, zero pads. ``want_counter`` gates the
    counter download, needed only for the small-path debug artifact."""
    # tail_good_dev packs (class key)*(n+1)+isa and a tie flag into one
    # int64 sort key: needs 2n(n+1) < 2^61
    if n >= 1 << 30:
        raise ValueError("device merge supports references < 2^30 chars")
    mark = stage_timer(head_t.device)
    h_pad = int(head_t.shape[0])
    n_pad = int(ref_sa.shape[0])
    to_next, isa_next, succ = fixup_dev(head_t, head_pos, head_len, h,
                                        ref_isa, h_pad)
    tails_cnt = tail_counts_dev(head_pos, to_next, h, h_pad, n_pad)
    mark("fixup")
    cls = group_dev(head_pos, head_len, head_smaller, to_next, isa_next,
                    h, n, h_pad)
    mark("group")
    rank_to_head, sa_ord, cls_of_slot = class_ranks_dev(
        cls, ref_isa, h, d, n, h_pad)
    cls["cls_of_slot"] = cls_of_slot
    head_to_rank = head_string_sa_dev(rank_to_head, h, h_pad)
    mark("head_string_sa")
    final_rank, bwt_heads, succ_rank, member_rank_sorted = rank_heads_dev(
        cls, head_to_rank, head_char, succ, h, h_pad)
    slot_base = cls["member_off"]
    mark("rank_heads")
    pairs = tail_pairs_count_dev(cls, h_pad)
    total_pairs = pairs["total"]
    if total_pairs >= 1 << 30:  # tail_good_dev's 63-bit pair pack
        raise ValueError("tail pair volume exceeds the int32 device merge")
    p_pad = bucket_size(total_pairs + 1)
    mark("tail_pairs_count(P=%d)" % total_pairs)
    counter, n_exact, exact_members, e_pidx, e_fnd, src_cls = \
        tail_good_dev(cls, pairs, slot_base, h, n, h_pad, p_pad)
    mark("tail_good(exact=%d)" % n_exact)
    if n_exact:
        counter = tail_exact_dev(
            counter, cls, pairs, slot_base, member_rank_sorted, cls_of_slot,
            e_pidx, e_fnd, src_cls, n_exact, h, h_pad,
            bucket_size(n_exact), bucket_size(max(exact_members, 1)))
        mark("tail_exact")
    rl, rc, n_runs = runs_emit_dev(
        cls, sa_ord, slot_base, counter, tails_cnt, bwt_heads,
        ref_sa, ref_isa, ref_bwt, d, n, h_pad, n_pad, rle_quirk)
    mark("runs_emit(R=%d)" % n_runs)
    # counterSmallerThanHead, slot-indexed (debug artifact parity,
    # ref :919-924); host layout is int64[h+1]
    counter_np = (counter[: h + 1].cpu().numpy().astype(np.int64)
                  if want_counter else None)
    return rl, rc, counter_np


def download_runs(run_len, run_char):
    """A device run list as the host writers take it (run_len int64,
    run_char uint8 numpy arrays); counted in RUN_DOWNLOADS."""
    RUN_DOWNLOADS[0] += 1
    return (run_len.cpu().numpy().astype(np.int64),
            run_char.cpu().numpy())


def merge_heads_device_resident(dres, d: int, rle_quirk: bool,
                                want_counter: bool = True):
    """Merge a DeviceHeadsResult (ops/ms_jump.ms_jump_heads) where it lies:
    the head records and reference index are already in merge layout; the
    runs stay on the device (merge_device)."""
    _check_sn(int(dres.sn))
    return merge_device(
        dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
        dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
        dres.h, dres.n, dres.sn, d, rle_quirk, want_counter=want_counter)

