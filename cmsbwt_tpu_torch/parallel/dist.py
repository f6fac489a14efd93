"""Distributed-array primitives over a group of ranks — the counterpart of
cmsbwt_tpu/parallel/dist.py, the collective vocabulary of the sharded
merge (parallel/sharded_merge.py) and the sharded index
(parallel/sharded_index.py).

Layout: a distributed array of global length G = R*local is one
``(local,)`` int64 tensor per rank (parallel/distributed.Ranks); rank r
owns rows [r*local, (r+1)*local). Every rank calls the same primitives in
the same order (one program, R processes). Validity is by convention: pad
rows carry sentinel keys.

* ``dsort``    — global stable sample sort back to the regular layout
* ``dcumsum`` / ``dcumsum_rev`` / ``dcummax`` / ``dcummin_rev`` /
  ``dcummax_rev`` / ``dcummax_rows`` — local scan plus the exclusive
  prefix (suffix) of the other ranks' totals (one all_gather); the 1-D
  running max / min is ``ops/fill.running_fill`` (the CUDA kernel on a
  card)
* ``dgather``  — routed gather (out[j] = vals[q[j]])
* ``dscatter`` / ``dscatter_rows`` — routed scatter, mode set|add|max
* ``dshift``   — out[i] = vals[i + w] (ppermute: batch_isend_irecv)
* ``shard`` / ``gather_rows`` / ``bcast_object`` / ``bcast_array`` —
  rank 0's host or device arrays in and out of the group

The JAX primitives send through static ``(n_shards, cap)`` grids and drop
and retry rows past a bucket's capacity. Here every exchange is one
``all_to_all_single`` with exact split sizes, the counts sent first in a
small ``all_to_all_single``: nothing can overflow, so the capacity factor,
the overflow scopes and the retry loop have no counterpart. A group of one
rank runs the plain local op, as the JAX 1-shard paths do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.fill import running_fill
from .distributed import Ranks

I64 = torch.int64
I64_MAX = 1 << 62
SAMPLES = 256     # splitter candidates per rank in dsort
# all_gather into one flat tensor (renamed all_gather_single in torch 2.12)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort by several keys, most significant first (ties keep
    input order, like a stable ``lax.sort`` with num_keys=len(keys)), as
    stable ``torch.sort`` passes: the mesh's keys are int64 of no stated
    width."""
    order = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _dmin(dt):
    return torch.iinfo(dt).min


def _dmax(dt):
    return torch.iinfo(dt).max


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_gather(g: Ranks, t: torch.Tensor) -> torch.Tensor:
    """(R, *t.shape): every rank's ``t``."""
    if g.size == 1:
        return t[None].clone()
    out = t.new_empty(g.size * t.numel())
    _ALL_GATHER(out, t.reshape(-1).contiguous())
    return out.view((g.size,) + tuple(t.shape))


def all_sum(g: Ranks, v) -> int:
    """Sum over the ranks of a local integer (or 0-d tensor) as an int."""
    t = torch.as_tensor(v, dtype=I64, device=g.device).reshape(1).clone()
    if g.size > 1:
        dist.all_reduce(t)
    return int(t)


def exchange(g: Ranks, rows: torch.Tensor, counts):
    """Send ``counts[d]`` consecutive rows of ``rows`` to rank d (dest-major
    order); returns (received rows in source order, counts received)."""
    counts = [int(c) for c in counts]
    if g.size == 1:
        return rows[:counts[0]], counts
    sc = torch.tensor(counts, dtype=I64, device=g.device)
    rc = torch.empty_like(sc)
    dist.all_to_all_single(rc, sc)
    rcounts = rc.tolist()
    rows = rows[:sum(counts)].contiguous()
    out = rows.new_empty((sum(rcounts),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows, rcounts, counts)
    return out, rcounts


def send_recv(sends, recvs) -> None:
    """One batch_isend_irecv of (tensor, peer) pairs; empty ones skipped."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), p)
           for t, p in sends if t.numel()]
    ops += [dist.P2POp(dist.irecv, t, p) for t, p in recvs if t.numel()]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def bcast_object(g: Ranks, obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if g.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=g.device)
    return box[0]


def bcast_array(g: Ranks, a):
    """Rank 0's numpy array on every rank (as numpy)."""
    if g.size == 1:
        return np.asarray(a)
    meta = bcast_object(g, (a.shape, a.dtype.str) if g.rank == 0 else None)
    t = (torch.from_numpy(np.ascontiguousarray(a)).to(g.device)
         if g.rank == 0 else
         torch.empty(meta[0], dtype=torch.from_numpy(
             np.zeros(0, np.dtype(meta[1]))).dtype, device=g.device))
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def shard(g: Ranks, a, local: int, pad_val=0, valid: int | None = None):
    """Rank 0's array (numpy, or a tensor on any device; the first
    ``valid`` rows) as a distributed int64 array of ``local`` rows per
    rank, padded with ``pad_val`` (the JAX ``shard`` / ``shard_dev``)."""
    full = None
    if g.rank == 0:
        src = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                              else a)
        k = min(src.shape[0], valid if valid is not None else src.shape[0])
        full = torch.full((g.size * local,), pad_val, dtype=I64,
                          device=g.device)
        full[:k] = src[:k].to(device=g.device, dtype=I64)
        if g.size == 1:
            return full
    out = torch.empty(local, dtype=I64, device=g.device)
    if g.rank == 0:
        dist.all_to_all_single(out, full, [local] + [0] * (g.size - 1),
                               [local] * g.size)
    else:
        dist.all_to_all_single(out, torch.empty(0, dtype=I64,
                                                device=g.device),
                               [local] + [0] * (g.size - 1), [0] * g.size)
    return out


def gather_rows(g: Ranks, rows: torch.Tensor, count: int):
    """The first ``count`` rows of every rank, concatenated in rank order
    on rank 0 (None elsewhere)."""
    got, _ = exchange(g, rows, [count] + [0] * (g.size - 1))
    return got if g.rank == 0 else None


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def _prefix(g: Ranks, total: torch.Tensor, op: str, init, before: bool):
    """Exclusive prefix (``before``) or suffix of a per-rank scalar (or
    K-vector) under op."""
    allv = all_gather(g, total)
    r = torch.arange(g.size, device=g.device)
    mask = (r < g.rank) if before else (r > g.rank)
    mask = mask.reshape((-1,) + (1,) * (allv.dim() - 1))
    masked = torch.where(mask, allv, init)
    if op == "sum":
        return masked.sum(0)
    return masked.amax(0) if op == "max" else masked.amin(0)


def dcumsum(g: Ranks, vals):
    c = torch.cumsum(vals, 0)
    if g.size == 1:
        return c
    return c + _prefix(g, c[-1], "sum", 0, True)


def dcumsum_rev(g: Ranks, vals):
    c = torch.flip(torch.cumsum(torch.flip(vals, [0]), 0), [0])
    if g.size == 1:
        return c
    return c + _prefix(g, c[0], "sum", 0, False)


def dcummax(g: Ranks, vals):
    c = running_fill(vals, "max")
    if g.size == 1:
        return c
    return torch.maximum(c, _prefix(g, c[-1], "max", _dmin(vals.dtype), True))


def dcummin_rev(g: Ranks, vals):
    """Reverse running min (the merge engine's rev_fill idiom)."""
    c = running_fill(vals, "min", reverse=True)
    if g.size == 1:
        return c
    return torch.minimum(c, _prefix(g, c[0], "min", _dmax(vals.dtype), False))


def dcummax_rev(g: Ranks, vals):
    c = running_fill(vals, "max", reverse=True)
    if g.size == 1:
        return c
    return torch.maximum(c, _prefix(g, c[0], "max", _dmin(vals.dtype), False))


def dcummax_rows(g: Ranks, vals2):
    """Row-wise dcummax of (K, local): one all_gather of the K tails."""
    c = torch.cummax(vals2, 1).values
    if g.size == 1:
        return c
    pre = _prefix(g, c[:, -1], "max", _dmin(vals2.dtype), True)
    return torch.maximum(c, pre[:, None])


# ---------------------------------------------------------------------------
# shift, gather, scatter
# ---------------------------------------------------------------------------

def dshift(g: Ranks, vals, w: int, pad_val):
    """Global out[i] = vals[i + w] for an int w; rows shifted past either
    end take pad_val. With w = q*local + r, rank s reads rows [r, local) of
    rank s+q and rows [0, r) of rank s+q+1: two sends and two receives."""
    local = vals.shape[0]
    out = torch.full_like(vals, pad_val)
    q, r = divmod(int(w), local)
    s, R = g.rank, g.size
    sends, recvs = [], []
    # (my piece, its source rank, the rows it takes there)
    for src, dst_sl, src_sl in ((s + q, slice(0, local - r), slice(r, local)),
                                (s + q + 1, slice(local - r, local),
                                 slice(0, r))):
        if 0 <= src < R:
            if src == s:
                out[dst_sl] = vals[src_sl]
            else:
                recvs.append((out[dst_sl], src))
    for dst, src_sl in ((s - q, slice(r, local)), (s - q - 1, slice(0, r))):
        if 0 <= dst < R and dst != s:
            sends.append((vals[src_sl], dst))
    if sends or recvs:
        bufs = [(torch.empty_like(t), p) for t, p in recvs]
        send_recv(sends, bufs)
        for (t, _), (b, _) in zip(recvs, bufs):
            t.copy_(b)
    return out


def _route(g: Ranks, idx, size_per_rank: int):
    """The live rows of ``idx`` (global indices in range) grouped by owner
    rank, stably: (their positions in ``idx``, their slots on the owner,
    the rows for each rank)."""
    live = (idx >= 0) & (idx < size_per_rank * g.size)
    dest = torch.where(live, idx // size_per_rank, g.size)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=g.size + 1)[:g.size].tolist()
    k = sum(counts)
    order = order[:k]
    slot = (idx[order] - dest[order] * size_per_rank)
    return order, slot, counts


def dgather(g: Ranks, vals, q, oob_val):
    """out[j] = global vals[q[j]] for int64 global indices (out of range ->
    oob_val); ``vals`` may be (local_v,) or (local_v, C) (C channels over
    one routing). Queries go to their owner, answers come back on the
    inverse splits."""
    local_v = vals.shape[0]
    n_total = local_v * g.size
    inr = (q >= 0) & (q < n_total)
    shape = (q.shape[0],) + tuple(vals.shape[1:])
    if g.size == 1:
        res = vals[torch.clamp(q, 0, n_total - 1)]
        m = inr.reshape((-1,) + (1,) * (vals.dim() - 1))
        return torch.where(m, res, torch.full_like(res, oob_val))
    order, slot, counts = _route(g, q, local_v)
    recv_q, rcounts = exchange(g, slot, counts)
    ans = vals[recv_q]
    back, _ = exchange(g, ans, rcounts)
    out = torch.full(shape, oob_val, dtype=vals.dtype, device=vals.device)
    out[order] = back
    return out


def _scatter_local(base, at, v, mode: str):
    if mode == "set":
        base[..., at] = v
    elif mode == "add":
        base.index_add_(base.dim() - 1, at, v)
    elif mode == "max":
        if base.dim() == 1:
            base.scatter_reduce_(0, at, v, reduce="amax", include_self=True)
        else:
            base.scatter_reduce_(1, at.expand(base.shape[0], -1), v,
                                 reduce="amax", include_self=True)
    else:
        raise ValueError(f"unknown scatter mode {mode!r}")
    return base


def dscatter(g: Ranks, base, idx, val, mode: str):
    """Distributed base.at[idx].{set,add,max}(val) over int64 global idx;
    out-of-range rows drop. ``set`` needs unique live indices. The mode is
    always named (the JAX defaults differ: dscatter 'set', dscatter_rows
    'max')."""
    local_b = base.shape[0]
    if g.size == 1:
        live = (idx >= 0) & (idx < local_b)
        return _scatter_local(base, idx[live], val[live].to(base.dtype), mode)
    order, slot, counts = _route(g, idx, local_b)
    both, _ = exchange(g, torch.stack([slot, val[order].to(I64)], 1), counts)
    return _scatter_local(base, both[:, 0], both[:, 1].to(base.dtype), mode)


def dscatter_rows(g: Ranks, base2, idx, vals2, mode: str):
    """K-channel dscatter over one routing of ``idx``: base2 (K, local_b),
    vals2 (K, L)."""
    local_b = base2.shape[1]
    if g.size == 1:
        live = (idx >= 0) & (idx < local_b)
        return _scatter_local(base2, idx[live], vals2[:, live].to(base2.dtype),
                              mode)
    order, slot, counts = _route(g, idx, local_b)
    rows, _ = exchange(g, torch.cat([slot[:, None], vals2[:, order].t()], 1),
                       counts)
    return _scatter_local(base2, rows[:, 0], rows[:, 1:].t().to(base2.dtype),
                          mode)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def _ge(spl, rows) -> torch.Tensor:
    """spl <= row lexicographically, per row of rows (n, nk)."""
    below = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    eq = torch.ones_like(below)
    for c in range(rows.shape[1]):
        below |= eq & (spl[c] < rows[:, c])
        eq &= spl[c] == rows[:, c]
    return below | eq


def dsort(g: Ranks, keys, payloads, kmax=I64_MAX):
    """Globally and stably sort rows by ``keys`` (int64 tensors, most
    significant first) carrying ``payloads``; returns (keys_out,
    payloads_out) in the regular layout. Rows with keys[0] >= kmax are pads:
    they come out at the global tail as fills (keys kmax, payloads 0).

    Sample sort: local sort -> splitters from every rank's live rows
    (weighted quantiles, aimed at global rank b*local so that bucket b
    holds roughly rank b's final rows) -> one exact-split exchange ->
    local re-sort (stable: ties keep rank, then local, order) -> one
    exact-split exchange to each row's home at its global rank."""
    nk = len(keys)
    local = keys[0].shape[0]
    cols = torch.stack([*keys, *payloads], 1)
    cols = cols[_lexsort(*keys)]
    nl = int((cols[:, 0] < kmax).sum())      # live rows: a prefix
    if g.size > 1:
        S = min(nl, SAMPLES)
        cand = torch.full((SAMPLES, nk + 1), kmax, dtype=I64, device=g.device)
        cand[:, nk] = 0
        if S:
            pick = (torch.arange(S, device=g.device) * nl) // S
            cand[:S, :nk] = cols[pick, :nk]
            cand[:S, nk] = torch.diff(pick, append=torch.tensor(
                [nl], device=g.device))
        allc = all_gather(g, cand).reshape(-1, nk + 1)
        allc = allc[_lexsort(*allc[:, :nk].unbind(1))]
        below = torch.cumsum(allc[:, nk], 0) - allc[:, nk]
        dest = torch.zeros(nl, dtype=I64, device=g.device)
        for b in range(1, g.size):
            j = int(torch.searchsorted(below, b * local))
            if j < allc.shape[0] and allc[j, nk] > 0:
                dest += _ge(allc[j, :nk], cols[:nl, :nk]).to(I64)
        counts = torch.bincount(dest, minlength=g.size).tolist()
        got, _ = exchange(g, cols[:nl], counts)
        got = got[_lexsort(*got[:, :nk].unbind(1))]
        mine = got.shape[0]
        pre = int(_prefix(g, torch.tensor(mine, device=g.device), "sum", 0,
                          True))
        home = (pre + torch.arange(mine, device=g.device)) // local
        cols, _ = exchange(g, got, torch.bincount(
            home, minlength=g.size).tolist())
        nl = cols.shape[0]
    out = torch.zeros((local, nk + len(payloads)), dtype=I64,
                      device=g.device)
    out[:nl] = cols[:nl]
    out[nl:, :nk] = kmax
    return ([out[:, c].contiguous() for c in range(nk)],
            [out[:, nk + c].contiguous() for c in range(len(payloads))])
