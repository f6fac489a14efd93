"""Device reference-index construction in torch — the counterpart of
cmsbwt_tpu/index/device.py, function by function.

* suffix array: Manber–Myers prefix doubling; each round is one stable
  ``ops/sort.stable_argsort`` by the two keys (rank, next + 1), each of
  the bits of n (the JAX version sorts them packed into one int64 word),
  then the round's rank step, ``dense_rank``, by the CUDA kernel
  ``kernels/csrc/sa_round.cu``'s dense_rank for CUDA tensors, by
  ``_dense_rank_reference`` for CPU tensors; the step also writes the
  next round's shifted key. The JAX version inverts each round's order
  by a second sort; here the rank lands through the order. The JAX
  version skips converged rounds with ``lax.cond``; here a host loop
  reads one word pair a round (the largest rank or the unresolved count,
  and the sorts' fault word), breaks early and fills the remaining
  history rows.
* with the rank history (the reference index) every round ranks all n
  rows densely, as JAX's history rows are. Without it (the head string's
  sort in engine/device_merge.py and engine/ranking.py) a row's rank is
  the sorted index at which its group starts, which stays fixed once the
  row is resolved, and every round after the first ranks only the rows
  still in groups of two or more: a slice of their text positions and
  ranks in sorted order, so each group's rows are contiguous and only
  need sorting by key 1 among themselves (``comp_rank``: on CUDA
  ``dense_rank_comp``, which sorts each group of at most ``COMP_CAP``
  rows in shared memory and larger groups on ``radix_sort``; on the CPU
  ``_comp_rank_reference``), writing each row's rank and its place in the
  suffix array in place. Once the slice has at most ``COMP_CAP`` rows one
  call runs every round left (``comp_tail``: one block on CUDA). At
  convergence every group is a singleton, so the rank, the order and
  k_star are JAX's.
* rank history: a [LEVELS, n] int32 buffer, kept where asked for
  (``history``); LCP is computed by binary lifting over it.
* PSV/NSV: a power-of-two sparse table of LCP window minima.

All tensors are int32 (n < 2^31; the rank step's kernel takes n < 2^30).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import COMP_CAP
from ..ops.sort import (COUNT_FAULT, fault_word, key_bits, raise_faults,
                        stable_argsort)
from ..utils.timing import count, span

INT_MAX = 2**31 - 1
I32 = torch.int32

# calls of the plain versions (the CUDA wrappers keep their own launch
# counts)
REFERENCE_CALLS = {"_dense_rank_reference": 0, "_comp_rank_reference": 0}


def _rank_work(n: int, steps: int, dev, comp_steps: int = 0):
    """One suffix sort's scratch and stagings for its rank steps on CUDA
    (kernels.RankWork); None on the CPU."""
    if torch.device(dev).type != "cuda":
        return None
    from ..kernels import RankWork
    return RankWork(n, steps, dev, comp_steps)


def dense_rank(order, s0, key1=None, out=None, *, nxt=None, shift: int = 0,
               slice_=None, work=None):
    """The full rank step after a round's sort, on the device of its
    tensors: the CUDA kernel for CUDA tensors, ``_dense_rank_reference``
    for CPU tensors (``work``: the CUDA kernel's RankWork). Returns (rank
    int32[n] in text order, into ``out`` where given; top int32[2]: the
    largest rank and the sorts' fault word as it stood after the sort, on
    the device; with ``slice_`` int32[3]: the unresolved count, the fault
    word, and the slice's rows in groups larger than COMP_CAP)."""
    dev = order.device
    if dev.type == "cuda":
        from ..kernels import dense_rank_cuda
        return dense_rank_cuda(order, s0, key1, fault_word(dev), out,
                               nxt=nxt, shift=shift, slice_=slice_,
                               work=work)
    if dev.type == "cpu":
        return _dense_rank_reference(order, s0, key1, out, nxt=nxt,
                                     shift=shift, slice_=slice_)
    raise ValueError(f"dense_rank: unsupported device {dev.type!r}")


def _starts(order, s0, key1):
    """Over the rows in ``order``: whether each starts a rank (key 0 or
    key 1 differs from the row before's, or it is the first row)."""
    n = order.shape[0]
    diff = s0[1:] != s0[:-1]
    if key1 is not None:
        ks = key1[order]
        diff |= ks[1:] != ks[:-1]
    changed = torch.ones(n, dtype=torch.bool, device=s0.device)
    changed[1:] = diff
    return changed


def _last_row(flag):
    """The last row at or before each row where ``flag`` is set (-1:
    none)."""
    at = torch.arange(flag.shape[0], dtype=I32, device=flag.device)
    return torch.cummax(torch.where(flag, at, -1), 0).values.to(I32)


def _unresolved(starts):
    """Rows not a rank start followed by a rank start (the row after the
    last is one): those in groups of two or more."""
    nxt = torch.ones_like(starts)
    nxt[:-1] = starts[1:]
    return ~(starts & nxt)


def _shifted(rank, at, shift: int):
    """rank[at + shift] + 1, 0 past the end (int32)."""
    n = rank.shape[0]
    j = at.long() + shift
    return torch.where(j < n, rank[torch.clamp(j, max=n - 1)] + 1,
                       0).to(I32)


def _dense_rank_reference(order, s0, key1=None, out=None, *, nxt=None,
                          shift: int = 0, slice_=None):
    """Over the n rows in ``order`` (the stable order by (key 0, key 1);
    ``s0`` key 0 in that order, ``key1`` key 1 in text order or None):
    each row's rank at its text position: the dense rank (ties share a
    rank: JAX's cumsum(changed) - 1), with ``nxt`` = rank[t + shift] + 1
    (0 past the end); or with ``slice_`` = (ti, k0, k1) the group-start
    rank (the last rank start row at or before it), the unresolved rows'
    text positions, ranks and key 1 at ``shift`` (sorted order, the first
    cap = len(ti) of them) into ti, k0 and k1. top = (the largest rank,
    the fault word), or with ``slice_`` (the unresolved count, the fault
    word, the slice's rows in groups larger than COMP_CAP). Plain torch,
    on any device."""
    REFERENCE_CALLS["_dense_rank_reference"] += 1
    n = order.shape[0]
    starts = _starts(order, s0, key1)
    rank = torch.empty(n, dtype=I32, device=s0.device) if out is None \
        else out
    if slice_ is None:
        ranks = (torch.cumsum(starts.to(I32), 0) - 1).to(I32)
        word = ranks[-1:]
    else:
        ranks = _last_row(starts)
        un = _unresolved(starts)
        u = int(un.sum())
        ti, k0, k1 = slice_
        rows = torch.nonzero(un).flatten()[:ti.shape[0]]
        ti[:len(rows)] = order[rows]
        k0[:len(rows)] = ranks[rows]
        word = torch.tensor([u], dtype=I32, device=s0.device)
    rank[order.long()] = ranks  # a permutation
    if slice_ is not None:
        c = len(rows)
        k1[:c] = _shifted(rank, ti[:c], shift)
    elif nxt is not None:
        nxt.copy_(_shifted(rank, torch.arange(n, device=s0.device), shift))
    top = torch.cat([word, fault_word(s0.device)])
    if slice_ is not None:
        big = _big_rows(starts)
        top = torch.cat([top, torch.tensor([big], dtype=I32,
                                           device=s0.device)])
    return rank, top


def _big_rows(starts) -> int:
    """The rows in runs (from a rank start up to the next) of more than
    COMP_CAP rows: the next slice's rows in groups too large to sort in
    shared memory."""
    run = torch.cumsum(starts.to(torch.int64), 0)
    size = torch.bincount(run - 1)
    return int(size[size > COMP_CAP].sum())


def comp_rank(slice_, u: int, large: int, rank, sa, nxt_slice,
              shift: int, work=None):
    """A compacted round's rank step over the slice of unresolved rows,
    on the device of its tensors: ``dense_rank_comp`` for CUDA tensors,
    ``_comp_rank_reference`` for CPU tensors. Returns top int32[4] (the
    next slice's rows, the sorts' fault word, its rows in groups larger
    than COMP_CAP, the rounds run: 1), on the device."""
    dev = rank.device
    if dev.type == "cuda":
        from ..kernels import dense_rank_comp_cuda
        return dense_rank_comp_cuda(slice_, u, large, rank, sa, nxt_slice,
                                    shift, fault_word(dev), work)
    if dev.type == "cpu":
        return _comp_rank_reference(slice_, u, large, rank, sa, nxt_slice,
                                    shift)
    raise ValueError(f"comp_rank: unsupported device {dev.type!r}")


def comp_tail(slice_, u: int, rank, sa, nxt_slice, shift: int, rounds: int,
              work=None):
    """Every compacted round left, from a slice of u <= COMP_CAP rows
    whose key 1 is at ``shift``, until no row is unresolved or ``rounds``
    have run: one block of ``dense_rank_comp`` for CUDA tensors,
    ``_comp_tail_reference`` for CPU tensors. Returns top as comp_rank's,
    with the rounds run."""
    dev = rank.device
    if dev.type == "cuda":
        from ..kernels import dense_rank_comp_cuda
        return dense_rank_comp_cuda(slice_, u, 0, rank, sa, nxt_slice,
                                    shift, fault_word(dev), work,
                                    tail=rounds)
    if dev.type == "cpu":
        return _comp_tail_reference(slice_, u, rank, sa, nxt_slice, shift,
                                    rounds)
    raise ValueError(f"comp_tail: unsupported device {dev.type!r}")


def _comp_rank_reference(slice_, u: int, large: int, rank, sa, nxt_slice,
                         shift: int):
    """Over the first u rows of the slice ``slice_`` = (ti, k0, k1): text
    positions, key 0 (the rank the row had: its group's start, in sorted
    order) and key 1, sorted stably by (key 0, key 1) here; with G and F
    the last group (key 0) and rank (key 0 or key 1) start rows at or
    before a sorted row r: rank[t] = key 0 + (F - G), sa[key 0 + (r - G)]
    = t for the rows now resolved (a later round places the others), the
    unresolved rows' text positions and ranks (sorted order) into
    ``nxt_slice`` = (ti_n, k0_n), and with ``shift`` > 0 their key 1 at
    that shift into k1 (after the ranks land). ``large``: the slice's
    rows in groups larger than COMP_CAP, as the round before counted them
    (COUNT_FAULT in the fault word if not). Returns top = (the unresolved
    count, the fault word, the next slice's rows in groups larger than
    COMP_CAP, 1). Plain torch, on any device."""
    REFERENCE_CALLS["_comp_rank_reference"] += 1
    ti, k0, k1 = (v[:u] for v in slice_)
    dev = rank.device
    p = torch.sort(k1, stable=True).indices
    p = p[torch.sort(k0[p], stable=True).indices]
    s0, tis, k1s = k0[p], ti[p], k1[p]
    g_start = torch.ones(u, dtype=torch.bool, device=dev)
    g_start[1:] = s0[1:] != s0[:-1]
    starts = g_start.clone()
    starts[1:] |= k1s[1:] != k1s[:-1]
    G, F = _last_row(g_start), _last_row(starts)
    at = torch.arange(u, dtype=I32, device=dev)
    new = (s0 + (F - G)).to(I32)
    rank[tis.long()] = new
    un = _unresolved(starts)
    sa[(s0 + (at - G))[~un].long()] = tis[~un]
    c = int(un.sum())
    ti_n, k0_n = nxt_slice
    ti_n[:c] = tis[un]
    k0_n[:c] = new[un]
    if shift > 0 and c:
        slice_[2][:c] = _shifted(rank, ti_n[:c], shift)
    size = torch.bincount(torch.cumsum(g_start.to(torch.int64), 0) - 1)
    fault = fault_word(dev).clone()
    if int(size[size > COMP_CAP].sum()) != large:
        fault |= COUNT_FAULT
    return torch.cat([torch.tensor([c], dtype=I32, device=dev), fault,
                      torch.tensor([_big_rows(starts), 1], dtype=I32,
                                   device=dev)])


def _comp_tail_reference(slice_, u: int, rank, sa, nxt_slice, shift: int,
                         rounds: int):
    """comp_tail's plain version: _comp_rank_reference round by round on
    copies of the slice, each round's key 1 gathered from the rank at
    ``shift``, 2 ``shift``, ...; a slice left when the rounds run out into
    ``nxt_slice``. Returns (the rows left, the fault word, 0, the rounds
    run)."""
    cur = tuple(v[:u].clone() for v in slice_)
    h, run = shift, 0
    fault = fault_word(rank.device)
    while u and run < rounds:
        cur[2][:u] = _shifted(rank, cur[0][:u], h)
        nxt = tuple(torch.empty(u, dtype=I32, device=rank.device)
                    for _ in range(2))
        top = _comp_rank_reference(cur, u, 0, rank, sa, nxt, 0)
        fault = top[1:2]
        u = int(top[0])
        cur = (nxt[0], nxt[1], cur[2])
        h, run = 2 * h, run + 1
    nxt_slice[0][:u] = cur[0][:u]
    nxt_slice[1][:u] = cur[1][:u]
    return torch.cat([torch.tensor([u], dtype=I32, device=rank.device),
                      fault, torch.tensor([0, run], dtype=I32,
                                          device=rank.device)])


def _dense_rank(keys, bounds, out=None, **step):
    """Rank (dense, or as ``step`` asks: see dense_rank) of the rows by one
    or two int32 keys (most significant first, each below its bound),
    int32; returns (rank, the stable order of the rows, top: the largest
    rank or the unresolved count and the sorts' fault word, on the
    device)."""
    order, s0 = stable_argsort(keys, [key_bits(b) for b in bounds],
                               values=True)
    rank, top = dense_rank(order, s0, keys[1] if len(keys) > 1 else None,
                           out, **step)
    return rank, order, top


def _read_top(top: torch.Tensor) -> int:
    """A dense round's first word (the largest rank), from one copy of
    ``top`` that also brings the sorts' fault word (raised on, as
    check_faults does)."""
    word, fault = top.tolist()
    raise_faults(top.device, fault)
    return word


def _read_round(top: torch.Tensor) -> tuple:
    """A head-string round's words from one copy of ``top`` (raising on
    the sorts' fault word): (the unresolved count, its rows in groups
    larger than COMP_CAP, the rounds the call ran: 1 unless the tail's)."""
    words = top.tolist()
    raise_faults(top.device, words[1])
    return words[0], words[2], words[3] if len(words) > 3 else 1


def n_levels(n: int) -> int:
    """Doubling levels: level k covers windows of 2**k; we need 2**k >= n."""
    lv = 1
    while (1 << lv) < n:
        lv += 1
    return lv + 1  # include level 0


def suffix_array_device(x: torch.Tensor, n: int, bound: int = 256,
                        history: bool = True):
    """Return (sa int32[n], isa int32[n], history int32[LEVELS, n] or None
    when ``history`` is False, k_star) for the integer string ``x`` of
    length n, whose values lie in [0, ``bound``) (bytes by default)."""
    if not history:
        return _suffix_array_starts(x, n, bound)
    dev = x.device
    levels = n_levels(n)
    work = _rank_work(n, levels, dev)
    hist = torch.empty((levels, n), dtype=I32, device=dev)
    # each step writes the next round's key 1 into nxt
    nxt = torch.empty(n, dtype=I32, device=dev)
    rank, _, _ = _dense_rank((x.to(I32),), (bound,), hist[0], nxt=nxt,
                             shift=1, work=work)
    k_star = levels
    for k in range(levels - 1):     # round k: shift 2^k, level k + 1
        rank, sa, top = _dense_rank((rank, nxt), (n, n + 1), hist[k + 1],
                                    nxt=nxt, shift=2 << k, work=work)
        if _read_top(top) == n - 1:
            k_star = k + 1
            hist[k + 2:] = hist[k + 1]
            break
    # converged, the rank is a permutation and its order the SA
    return sa, rank, hist, k_star


def _suffix_array_starts(x: torch.Tensor, n: int, bound: int):
    """suffix_array_device without the history: the first round sorts the
    pairs (x[t], x[t + 1] + 1) (0 past the end) as JAX's seed packs them,
    with no one-key step before it; group-start ranks, and every later
    round over the unresolved rows only (a slice of their text positions,
    ranks and key 1, carried from round to round, with no sort), the
    rounds from a slice of COMP_CAP rows or fewer in one call. One host
    read a call. Spans ``sa.round0`` (the first round), ``sa.comp`` (each
    compacted round) and ``sa.tail`` (the tail call), each up to its host
    read; counters ``sa.comp_rounds`` (the compacted rounds run, the
    tail's among them), ``sa.comp_rows`` (the rows each compacted call
    starts from) and ``sa.large_rows`` (those in groups larger than
    COMP_CAP), counted once a sort."""
    dev = x.device
    levels = n_levels(n)
    work = _rank_work(n, 1, dev, levels - 2)
    ti, k0, k1 = (torch.empty(n, dtype=I32, device=dev) for _ in range(3))
    rank = torch.empty(n, dtype=I32, device=dev)
    nxt = torch.zeros(n, dtype=I32, device=dev)
    xi = x.to(I32)
    torch.add(xi[1:], 1, out=nxt[:n - 1])
    # round 0 (shift 1): level 1's ranks, JAX's rank1
    with span("sa.round0"):
        _, sa, top = _dense_rank((xi, nxt), (bound, bound + 1), rank,
                                 shift=2, slice_=(ti, k0, k1), work=work)
        del xi, nxt
        u, large, _ = _read_round(top)
    # each round's slice holds at most the round before's rows
    ti_n, k0_n = (torch.empty(max(u, 1), dtype=I32, device=dev)
                  for _ in range(2))
    k = 1                                      # round k: shift 2^k
    n_rounds = n_rows = n_large = 0
    while u and k < levels - 1:
        n_rows += u
        tail = u <= COMP_CAP
        with span("sa.tail" if tail else "sa.comp"):
            if tail:
                top = comp_tail((ti, k0, k1), u, rank, sa, (ti_n, k0_n),
                                1 << k, levels - 1 - k, work)
            else:
                n_large += large
                top = comp_rank((ti, k0, k1), u, large, rank, sa,
                                (ti_n, k0_n), 2 << k, work)
                ti, ti_n, k0, k0_n = ti_n, ti, k0_n, k0
            u, large, rounds = _read_round(top)
        n_rounds += rounds
        k += rounds
    count("sa.comp_rounds", n_rounds)
    count("sa.comp_rows", n_rows)
    count("sa.large_rows", n_large)
    return sa, rank, None, levels if u else k


def lcp_device(sa: torch.Tensor, history: torch.Tensor, n: int
               ) -> torch.Tensor:
    """LCP int32[n+1]: LCP[i] = lcp(SA[i-1], SA[i]), LCP[0]=0, LCP[n]=-1."""
    levels = history.shape[0]
    a = sa[:-1]
    b = sa[1:]
    h = torch.zeros(n - 1, dtype=I32, device=sa.device)
    for k in range(levels - 1, -1, -1):
        rk = history[k]
        va = a + h
        vb = b + h
        ok = (va < n) & (vb < n)
        eq = ok & (rk[torch.clamp(va, max=n - 1)]
                   == rk[torch.clamp(vb, max=n - 1)])
        h = h + torch.where(eq, 1 << k, 0).to(I32)
    lcp = torch.empty(n + 1, dtype=I32, device=sa.device)
    lcp[0] = 0
    lcp[1:n] = h
    lcp[n] = -1
    return lcp


def sparse_table_levels(n: int) -> int:
    lv = 1
    while (1 << lv) <= n:
        lv += 1
    return lv


def _window_table(base: torch.Tensor, n: int, fill: int, op):
    """table[k][i] = op over base[i .. i+2^k), ``fill`` past n."""
    levels = sparse_table_levels(n)
    table = torch.empty((levels, n), dtype=I32, device=base.device)
    table[0] = base
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev = table[k - 1]
        other = torch.full((n,), fill, dtype=I32, device=base.device)
        if half < n:
            other[:n - half] = prev[half:]
        table[k] = op(prev, other)
    return table


def build_lcp_sparse_table(lcp: torch.Tensor, n: int) -> torch.Tensor:
    """jump[k][i] = min(LCP[i .. i+2^k)), padded with INF past n."""
    return _window_table(lcp[:n], n, INT_MAX, torch.minimum)


def psv_device(jump: torch.Tensor, i: torch.Tensor, ub: torch.Tensor,
               n: int) -> torch.Tensor:
    """Vector PSV: largest j <= i with LCP[j] < ub, else -1."""
    d = torch.zeros_like(i)
    for k in range(jump.shape[0] - 1, -1, -1):
        w = 1 << k
        s = i - d - w + 1
        mins = jump[k][torch.clamp(s, min=0)]
        d = d + torch.where((s >= 0) & (mins >= ub), w, 0).to(I32)
    res = i - d
    return torch.where(res >= 0, res, -1).to(I32)


def nsv_device(jump: torch.Tensor, i: torch.Tensor, ub: torch.Tensor,
               n: int) -> torch.Tensor:
    """Vector NSV: smallest j >= i (j < n) with LCP[j] < ub, else -1."""
    d = torch.zeros_like(i)
    for k in range(jump.shape[0] - 1, -1, -1):
        w = 1 << k
        s = i + d
        mins = jump[k][torch.clamp(s, max=n - 1)]
        d = d + torch.where((s + w <= n) & (mins >= ub), w, 0).to(I32)
    res = i + d
    return torch.where(res < n, res, -1).to(I32)


@dataclass
class DeviceIndex:
    """Reference index resident on one device (int32 throughout)."""

    x_padded: torch.Tensor   # uint8 [n + PAD] (x_padded[n] = 0, rest 0xFF)
    n: int
    sa: torch.Tensor         # int32 [n]
    isa: torch.Tensor        # int32 [n]
    lcp: torch.Tensor        # int32 [n+1]
    plcp: torch.Tensor       # int32 [n]
    bwt: torch.Tensor        # uint8 [n]
    jump: torch.Tensor       # int32 [levels, n] sparse-table minima

    PAD = 1024  # text overrun pad for windowed compares (mismatching bytes)


FIELDS = ("x_padded", "sa", "isa", "lcp", "plcp", "bwt", "jump")


def _index_tail(x, sa, isa, lcp, n: int):
    """PLCP skip bound, reference BWT, sparse table, padded text."""
    plcp = torch.maximum(lcp[isa], lcp[torch.clamp(isa + 1, max=n)])
    bwt = torch.where(sa > 0, x[torch.clamp(sa - 1, min=0)],
                      torch.zeros((), dtype=torch.uint8, device=x.device))
    jump = build_lcp_sparse_table(lcp, n)
    pad = torch.full((DeviceIndex.PAD,), 255, dtype=torch.uint8,
                     device=x.device)
    pad[0] = 0
    return plcp.to(I32), bwt, jump, torch.cat([x, pad])


def build_device_index(x_aug: np.ndarray, device) -> DeviceIndex:
    """The reference index on ``device``. Span ``index.build``: the upload,
    then ``index.sa`` (the doubling rounds), ``index.lcp`` and
    ``index.tail`` (PLCP, BWT, sparse table)."""
    with span("index.build"):
        n = len(x_aug)
        x = torch.from_numpy(np.ascontiguousarray(x_aug, np.uint8)).to(
            device)
        with span("index.sa"):
            sa, isa, history, _ = suffix_array_device(x, n)
        with span("index.lcp"):
            lcp = lcp_device(sa, history, n)
        del history
        with span("index.tail"):
            plcp, bwt, jump, x_padded = _index_tail(x, sa, isa, lcp, n)
    return DeviceIndex(x_padded=x_padded, n=n, sa=sa, isa=isa, lcp=lcp,
                       plcp=plcp, bwt=bwt, jump=jump)


def export_reference_index(d: DeviceIndex, x_aug: np.ndarray):
    """Host ReferenceIndex view of a device-built index (one download of
    each array; the JAX pipeline's ``_export_device_index``)."""
    from .host import ReferenceIndex
    return ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=d.n, sa=d.sa.cpu().numpy(), isa=d.isa.cpu().numpy(),
        lcp=d.lcp.cpu().numpy(), plcp=d.plcp.cpu().numpy(),
        bwt=d.bwt.cpu().numpy(), rank_history=[])


def build_reference_index_device(x_aug: np.ndarray, device):
    """Device-built index exported to the host ReferenceIndex container."""
    return export_reference_index(build_device_index(x_aug, device), x_aug)


def index_from_numpy(arrays: dict, device) -> DeviceIndex:
    """A DeviceIndex from host arrays named as its fields (for example the
    JAX package's DeviceIndex fields through ``np.asarray``)."""
    t = {k: torch.from_numpy(np.array(arrays[k], order="C")).to(device)
         for k in FIELDS}
    return DeviceIndex(n=int(t["sa"].shape[0]), **t)
