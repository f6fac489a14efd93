"""Head (phrase) extraction, fixup, and class grouping — array-parallel;
the port's copy of cmsbwt_tpu/engine/heads.py (the host merge's first
stages).

Replaces the reference's per-head scalar fixup loop and the per-position
``std::map<MatchInSet, ItemMatchInSet>`` (ref ``CMS-BWT-functions.cpp:566-603``
and ``match.h``) with flat sorted arrays + segmented boundaries:

* covering-phrase search: a single global ``searchsorted`` — phrase factor
  ends ``t + len`` are globally non-decreasing (MS lengths satisfy
  ``len[t+1] >= len[t] - 1``), so the reference's monotone two-pointer
  (ref :566-571) is a vectorized binary search clipped at the document's
  pseudo-head barrier (the ``len != 0`` condition).
* class grouping: classes are (pos, len, isaNext) groups — the map's
  equality ignores ``smaller`` (match.h:23-25) — with the class's
  ``smaller``/``untilNext`` taken from its first-inserted (minimum idx)
  member, exactly as ``ItemMatchInSet``'s constructor semantics.
* class ordering: the map comparator (match.h:27-33) orders, within a
  position, smaller=True classes by increasing len before smaller=False
  classes by decreasing len, ties by isaNext. We realize it as the total
  key ``K = len`` (smaller) / ``K = 2*n - len`` (not smaller). NOTE: for
  the pathological case of two same-pos classes with equal len and opposite
  ``smaller`` the reference comparator is cyclic (not a strict weak order;
  behavior depends on red-black tree internals) — our total order is one
  consistent linearization.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.host import ReferenceIndex
from ..io.native import (argsort_native, lexsort2_native,
                         searchsorted_right_native)
from .ms_host import MSArrays


@dataclass
class HeadArrays:
    """Per-head data in stream (idx) order."""

    t: np.ndarray          # int64 global collection position of the head
    pos: np.ndarray        # int64 match position in reference
    length: np.ndarray     # int64 match length (0 for doc-end pseudo-heads)
    smaller: np.ndarray    # bool
    char: np.ndarray       # uint8 BWT char of the head (listOfChars)
    to_next: np.ndarray    # int64 #tails before the next head (ref toNext)
    isa_next: np.ndarray   # int64 ISA of the successor image (ref 'start' after fixup)
    succ: np.ndarray       # int64 idx of the covering phrase of the successor
                           # (ref idx + nextHead[idx])
    h: int                 # number of heads


@dataclass
class ClassArrays:
    """Per-class data; classes are (pos, len, isaNext) groups of heads.

    ``order`` fields are permutations of class ids.
    """

    pos: np.ndarray        # int64
    length: np.ndarray     # int64
    isa_next: np.ndarray   # int64
    smaller: np.ndarray    # bool (first-inserted member's)
    until_next: np.ndarray  # int64 (first-inserted member's to_next)
    size: np.ndarray       # int64 member count
    member_head: np.ndarray  # int64 [h] head idx, grouped by class (text order)
    member_off: np.ndarray   # int64 [C+1] offsets into member_head
    key_k: np.ndarray      # int64 comparator key K within pos
    n_classes: int


def extract_heads(index: ReferenceIndex, ms: MSArrays,
                  sx: np.ndarray) -> HeadArrays:
    """Build head arrays from the MS scan output.

    Head BWT chars (ref listOfChars, :364-367): the char preceding the head
    in SX, cyclically — position 0 wraps to the final separator, matching the
    reference's per-document ``i==0 -> sequenceSeparator`` rule.
    """
    hmask = ms.is_head
    t = np.nonzero(hmask)[0].astype(np.int64)
    char = sx[(t - 1) % len(sx)]
    return HeadArrays(
        t=t,
        pos=ms.pos[t],
        length=ms.length[t],
        smaller=ms.smaller[t],
        char=char,
        to_next=np.zeros(len(t), dtype=np.int64),
        isa_next=np.zeros(len(t), dtype=np.int64),
        succ=np.zeros(len(t), dtype=np.int64),
        h=len(t),
    )


def fixup_heads(index: ReferenceIndex, heads: HeadArrays) -> None:
    """Vectorized covering-phrase fixup (ref :566-586).

    Fills to_next, isa_next, succ in place.
    """
    h = heads.h
    ends = heads.t + heads.length                      # non-decreasing globally
    pseudo = heads.length == 0
    # pseudo-head (doc barrier) index covering each head: next pseudo at or
    # after each head position in stream order. The count of pseudos strictly
    # before i is an exclusive prefix sum — no binary search needed.
    pseudo_idx = np.nonzero(pseudo)[0]
    doc_of_head = np.cumsum(pseudo, dtype=np.int32) - pseudo
    barrier = pseudo_idx[doc_of_head]                  # this doc's pseudo idx

    j = searchsorted_right_native(ends, ends)
    j = np.minimum(j, barrier)
    j[pseudo] = np.nonzero(pseudo)[0]                  # pseudo covers itself

    nxt_t = np.empty(h, dtype=np.int64)
    nxt_t[:-1] = heads.t[1:]
    nxt_t[-1] = heads.t[-1]                            # unused (last is pseudo)
    heads.to_next = np.where(heads.length > 0, nxt_t - heads.t - 1, 0)
    heads.succ = j
    # isaNext = ISA[pos_j + (end_i - t_j)]; the reference's final phrase gets
    # start=0 explicitly (:586) — identical since ISA[n-1] == 0.
    img = heads.pos[j] + (ends - heads.t[j])
    heads.isa_next = index.isa[img].astype(np.int64)


def build_classes(index: ReferenceIndex, heads: HeadArrays) -> ClassArrays:
    """Group heads into (pos, len, isaNext) classes (ref map insert :594-603)."""
    n = index.n
    # pack (length, isaNext) into one int64 key (both < n+1 <= 2^31) so the
    # grouping sort is 2 stable passes instead of 4; stability preserves
    # idx (insertion) order within groups
    scale = np.int64(n + 1)
    pack_li = heads.length * scale + heads.isa_next
    order = lexsort2_native(heads.pos, pack_li)
    p = heads.pos[order]
    la = pack_li[order]
    new_grp = np.ones(heads.h, dtype=bool)
    new_grp[1:] = (p[1:] != p[:-1]) | (la[1:] != la[:-1])
    gid = np.cumsum(new_grp) - 1
    n_classes = int(gid[-1]) + 1 if heads.h else 0
    first = np.nonzero(new_grp)[0]
    cls_pos = p[first]
    # unpack (len, isaNext) from the packed key at class firsts only —
    # avoids two full-H gathers
    la_first = la[first]
    cls_len = la_first // scale
    cls_isa = la_first - cls_len * scale
    first_head = order[first]                     # min-idx member
    cls_smaller = heads.smaller[first_head]
    cls_until = heads.to_next[first_head]
    cls_size = np.diff(np.append(first, heads.h))

    # comparator key K within a position (see module docstring)
    key_k = np.where(cls_smaller, cls_len, 2 * np.int64(n) - cls_len)

    # member storage grouped by class in TEXT order (pos, K, isaNext):
    pack_ki = key_k * scale + cls_isa
    text_order = lexsort2_native(cls_pos, pack_ki)
    rank_of_class = np.empty(n_classes, dtype=np.int64)
    rank_of_class[text_order] = np.arange(n_classes)
    # reorder members: stable sort by text-ordered class alone — within a
    # gid group the grouping sort already left `order` ascending (stable on
    # equal keys), so one pass replaces the (class, head idx) lexsort
    member_sort = argsort_native(rank_of_class[gid])
    member_head = order[member_sort]
    sizes_text = cls_size[text_order]
    member_off = np.concatenate([[0], np.cumsum(sizes_text)])

    return ClassArrays(
        pos=cls_pos[text_order],
        length=cls_len[text_order],
        isa_next=cls_isa[text_order],
        smaller=cls_smaller[text_order],
        until_next=cls_until[text_order],
        size=sizes_text,
        member_head=member_head,
        member_off=member_off.astype(np.int64),
        key_k=key_k[text_order],
        n_classes=n_classes,
    )
