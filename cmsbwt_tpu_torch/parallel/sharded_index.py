"""Sharded reference index: a prefix-doubling suffix sort over a group of
ranks with int64 global indices — the counterpart of
cmsbwt_tpu/parallel/sharded_index.py, the index of the giant-reference
route (references at or above the int32 bound; the reference tool caps
them there, int32 libsais SA, ref CMS-BWT-functions.cpp:246,
CMS-BWT.h:44). No rank holds n contiguous int64 elements.

Per round, on the primitives of parallel/dist.py:

* ``rank[i + w]``, the round's only non-local read, is ``dshift``: two
  sends and two receives per rank;
* the global key sort is ``dsort`` (sample sort, exact splits);
* global ranks are a boundary flag's ``dcumsum``, routed back to the
  text positions by ``dscatter_rows``.

Rounds quadruple, as in the JAX program: keys (rank, rank@+w, rank@+2w,
rank@+3w) refine two doubling levels per sort, both kept in the rank
history, with no packing (ranks up to 2^62), and the rounds stop once
every rank is distinct. The LCP is a binary-lifting equality walk over
that history whose cross-rank reads are ``dgather``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..index.host import ReferenceIndex, plcp_skip_bound
from . import distributed
from .dist import bcast_object, dcumsum, dgather, dscatter, dscatter_rows, \
    dshift, dsort, gather_rows, shard

I64 = torch.int64
KMAX = 1 << 62


def _rounds(n: int) -> int:
    rounds = 1
    while (1 << rounds) < max(n, 2):
        rounds += 1
    return rounds


def _index_rank(g, inputs):
    """One rank of the sharded build; ``inputs`` (rank 0's): x, want_lcp.
    Returns (sa, isa[, lcp]) int64 numpy on rank 0."""
    x, want = inputs if g.rank == 0 else (None, None)
    n, want_lcp = bcast_object(g, (len(x), want) if g.rank == 0 else None)
    local = -(-max(n, 1) // g.size)
    gidx = g.gidx(local)
    in_n = gidx < n
    rank = torch.where(in_n, shard(g, x, local, 0, n), KMAX)
    rounds = _rounds(n)
    hist = [rank]          # level k: ranks of the 2^k-char windows
    done = False
    for k in range(0, rounds, 2):
        if not done:
            w = 1 << k
            padded = torch.where(in_n, rank, -1)
            keys = [torch.where(in_n, rank, KMAX)] + [
                torch.where(in_n, dshift(g, padded, s * w, -1), -1)
                for s in (1, 2, 3)]
            mk, (mi,) = dsort(g, keys, [gidx], KMAX)
            prev = [dshift(g, c, -1, -3) for c in mk]
            live = gidx < n          # sorted: the n real suffixes first
            eq12 = (mk[0] == prev[0]) & (mk[1] == prev[1])
            eq4 = eq12 & (mk[2] == prev[2]) & (mk[3] == prev[3])
            gr = torch.stack([dcumsum(g, (live & ~eq12).to(I64)) - 1,
                              dcumsum(g, (live & ~eq4).to(I64)) - 1])
            back = dscatter_rows(g, torch.zeros((2, local), dtype=I64,
                                                device=g.device),
                                 torch.where(live, mi, -1), gr, "set")
            mid = torch.where(in_n, back[0], KMAX)
            rank = torch.where(in_n, back[1], KMAX)
            hist += [mid, rank]
            nmax = torch.where(in_n, rank, -1).max().reshape(1)
            if g.size > 1:
                dist.all_reduce(nmax, op=dist.ReduceOp.MAX)
            done = int(nmax) == n - 1
        else:
            hist += [rank, rank]
    sa = dscatter(g, torch.zeros(local, dtype=I64, device=g.device),
                  torch.where(in_n, rank, -1), gidx, "set")
    outs = [sa, rank]
    if want_lcp:
        a = dshift(g, sa, -1, -1)                 # SA[i-1]
        inner = in_n & (gidx >= 1)
        h = torch.zeros(local, dtype=I64, device=g.device)
        for k in range(rounds, -1, -1):
            va, vb = a + h, sa + h
            ok = inner & (va < n) & (vb < n) & (a >= 0)
            got = dgather(g, hist[k], torch.cat([torch.where(ok, va, 0),
                                                 torch.where(ok, vb, 0)]), -1)
            h += torch.where(ok & (got[:local] == got[local:]), 1 << k, 0)
        outs.append(torch.where(inner, h, 0))
    mine = min(max(n - g.rank * local, 0), local)
    cols = gather_rows(g, torch.stack(outs, 1), mine)
    if cols is None:
        return None
    return tuple(c.copy() for c in cols.cpu().numpy().T)


def sharded_suffix_array(x: np.ndarray, n_devices: int | None = None,
                         device="cuda"):
    """(sa, isa) int64[n] of ``x`` (uint8, unique terminator), computed
    over a group of ranks on ``device``; on rank 0, None on the others."""
    return distributed.run(_index_rank, (x, False), device, n_devices)


def sharded_suffix_array_with_lcp(x: np.ndarray,
                                  n_devices: int | None = None,
                                  device="cuda"):
    """(sa, isa, lcp) int64 over a group of ranks; the LCP in the layout of
    index/device.lcp_device: int64[n+1], LCP[0] = 0, LCP[n] = -1. On rank
    0, None on the others."""
    out = distributed.run(_index_rank, (x, True), device, n_devices)
    if out is None:
        return None
    sa, isa, lcp = out
    return sa, isa, np.concatenate([lcp, [-1]]).astype(np.int64)


def build_sharded_reference_index(x_aug: np.ndarray,
                                  n_devices: int | None = None,
                                  device="cuda") -> ReferenceIndex | None:
    """The full ReferenceIndex of the giant-reference route, from the
    sharded int64 build: SA/ISA/LCP over the ranks, then the PLCP skip
    bound and the reference BWT by the host builder's O(n) maps (ref
    :272-274, :294-297), on int64 indices. None on ranks other than 0."""
    out = sharded_suffix_array_with_lcp(x_aug, n_devices, device)
    if out is None:
        return None
    sa, isa, lcp = out
    x_aug = np.asarray(x_aug, np.uint8)
    return ReferenceIndex(
        x=x_aug, x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=len(x_aug), sa=sa, isa=isa, lcp=lcp,
        plcp=plcp_skip_bound(lcp, isa),
        bwt=np.where(sa > 0, x_aug[np.maximum(sa - 1, 0)],
                     np.uint8(0)).astype(np.uint8),
        rank_history=[])
