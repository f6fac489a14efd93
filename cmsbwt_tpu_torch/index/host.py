"""Host (numpy) reference-index construction — the port's copy of
cmsbwt_tpu/index/host.py.

Replaces libsais / libsais_plcp / libsais_lcp / rmq_tree of the reference
(ref ``CMS-BWT-functions.cpp:151-310``, ``rmq_tree.h``) with array-parallel
algorithms whose structure is shared with the device (torch) implementation
in ``index/device.py``:

* suffix array: Manber–Myers prefix doubling driven by ``np.lexsort``
* LCP: binary-lifting comparison over the rank history produced by doubling
  (fully parallel, no Kasai sequential dependency)
* PLCP skip bound: ``max(LCP[ISA[i]], LCP[ISA[i]+1])`` (ref :272-274)
* PSV/NSV: device queries use the sparse tables of ``index/device.py`` and
  the native engine a three-level block-minima structure
  (``io/csrc/cmsbwt_scan.cpp``); the methods here are simple vector scans
  serving as the test oracle.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def suffix_array_doubling(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Return (sa, isa_final_rank, rank_history) via prefix doubling.

    ``rank_history[k]`` holds the rank of the length-``2**k`` substring
    starting at each position (dense, ties allowed). The final entry may
    resolve all ties early.
    """
    n = len(x)
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), [])
    # level 0: ranks = dense char ranks
    vals = np.asarray(x, dtype=np.int64)
    order = np.argsort(vals, kind="stable")
    sorted_vals = vals[order]
    changed = np.ones(n, dtype=bool)
    changed[1:] = sorted_vals[1:] != sorted_vals[:-1]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.cumsum(changed) - 1
    history = [rank.astype(np.int32)]

    k = 1
    while rank[order[-1]] != n - 1:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.ones(n, dtype=bool)
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.cumsum(changed) - 1
        history.append(rank.astype(np.int32))
        k <<= 1
        if rank[order[-1]] == n - 1:
            break
    return order.astype(np.int32), rank.astype(np.int32), history


def lcp_from_rank_history(sa: np.ndarray, history: list[np.ndarray],
                          n: int) -> np.ndarray:
    """LCP[i] = lcp(SA[i-1], SA[i]) for i in [1, n); LCP[0] = 0.

    Binary lifting: compare rank windows from the largest doubling level
    down. Because the text ends with a unique smallest sentinel, window-rank
    equality of two distinct suffix tails implies a full in-bounds match.
    """
    if n == 0:
        return np.zeros(0, np.int32)
    a = sa[:-1].astype(np.int64)
    b = sa[1:].astype(np.int64)
    h = np.zeros(n - 1, dtype=np.int64)
    for k in range(len(history) - 1, -1, -1):
        rk = history[k]
        va = a + h
        vb = b + h
        ok = (va < n) & (vb < n)
        ai = np.where(ok, va, 0)
        bi = np.where(ok, vb, 0)
        eq = ok & (rk[ai] == rk[bi])
        h = h + np.where(eq, 1 << k, 0)
    lcp = np.zeros(n, dtype=np.int32)
    lcp[1:] = h
    return lcp


def plcp_skip_bound(lcp_ext: np.ndarray, isa: np.ndarray) -> np.ndarray:
    """Reference's redefined _PLCP (ref :272-274): per text position i,
    max(LCP[ISA[i]], LCP[ISA[i]+1]) with LCP[n] = -1 sentinel."""
    return np.maximum(lcp_ext[isa], lcp_ext[isa.astype(np.int64) + 1])


@dataclass
class ReferenceIndex:
    """Immutable reference index (replaces the file-static globals of
    ref CMS-BWT.h:34-53)."""

    x: np.ndarray          # uint8 augmented reference, length n
    x_padded: np.ndarray   # uint8 length n+1 with x_padded[n] = 0 (c_str() read)
    n: int
    sa: np.ndarray         # int32
    isa: np.ndarray        # int32 (uint32 in ref)
    lcp: np.ndarray        # int32 length n+1, lcp[n] = -1 (ref :260-261)
    plcp: np.ndarray       # int32 skip bound per text position (ref :272-274)
    bwt: np.ndarray        # uint8 reference BWT (ref :294-297)
    rank_history: list     # doubling rank history (device LCP/debug)

    def psv(self, i: int, ub: int) -> int:
        """max{j <= i : lcp[j] < ub} else -1 (rmq_tree.h:184-205 semantics:
        the scan starts at i itself)."""
        sl = self.lcp[: i + 1]
        hits = np.nonzero(sl < ub)[0]
        return int(hits[-1]) if len(hits) else -1

    def nsv(self, i: int, ub: int) -> int:
        """min{j >= i : lcp[j] < ub, j < n} else -1 (rmq_tree.h:208-225)."""
        if i >= self.n:
            return -1
        sl = self.lcp[i: self.n]
        hits = np.nonzero(sl < ub)[0]
        return int(i + hits[0]) if len(hits) else -1

    def adjust_interval(self, lo: int, hi: int, offset: int) -> tuple[int, int]:
        """Maximal SA interval containing [lo,hi] with internal LCP >= offset
        (ref CMS-BWT-functions.cpp:11-25)."""
        p = self.psv(lo, offset)
        p = 0 if p == -1 else p
        q = self.nsv(hi + 1, offset)
        q = self.n - 1 if q == -1 else q - 1
        return p, q

    def contract_left(self, lo: int, hi: int, offset: int) -> tuple[int, int]:
        """Ref CMS-BWT-functions.cpp:34-43."""
        suflo = int(self.sa[lo])
        sufhi = int(self.sa[hi])
        if suflo == self.n - 1 or sufhi == self.n - 1:
            return 0, self.n - 1
        return self.adjust_interval(int(self.isa[suflo + 1]),
                                    int(self.isa[sufhi + 1]), offset)


def build_reference_index(x_aug: np.ndarray) -> ReferenceIndex:
    """Build the full index from the augmented reference (host backend)."""
    n = len(x_aug)
    sa, isa, history = suffix_array_doubling(x_aug)
    lcp_core = lcp_from_rank_history(sa, history, n)
    lcp = np.empty(n + 1, dtype=np.int32)
    lcp[:n] = lcp_core
    lcp[n] = -1
    plcp = plcp_skip_bound(lcp, isa)
    bwt = np.where(sa > 0, x_aug[np.maximum(sa.astype(np.int64) - 1, 0)],
                   np.uint8(0)).astype(np.uint8)
    x_padded = np.concatenate([x_aug, np.zeros(1, dtype=np.uint8)])
    return ReferenceIndex(x=x_aug, x_padded=x_padded, n=n, sa=sa, isa=isa,
                          lcp=lcp, plcp=plcp, bwt=bwt, rank_history=history)
