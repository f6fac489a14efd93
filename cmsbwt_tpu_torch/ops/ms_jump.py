"""Head-jumping matching-statistics scan — the counterpart of
cmsbwt_tpu/ops/ms_jump.py.

Each lane walks one chunk of the collection and emits candidate head
records (t, pos, len, smaller) only at factor ends; the tail run after a
factor is skipped by finding the first p with g[p] = p + PLCP[p] past it,
and the SA interval is re-expanded by PSV/NSV over the LCP array. The
candidates are then concatenated in text order and the global head test
``pos != prev.pos + (t - prev.t)`` keeps the true heads
(``_compact_candidates``).

The scan has two forms with one contract:

* ``ms_jump_scan_reference`` — lane-vectorised, masked torch ops, a
  line-by-line port of the JAX ``ms_jump_step`` wave loop, reading the JAX
  package's [levels, n] sparse tables (``index.jump`` and
  ``build_gmax_table``). It is what the port runs on the CPU; on the card
  only tests and chip_smoke.py call it.
* the CUDA kernel ``kernels/csrc/ms_jump_scan.cu`` — one warp per lane
  running the same per-lane state machine to completion in one launch,
  reading 128-wide block trees (``build_block_trees``) in place of the
  sparse tables. ``tree_next_ge`` and ``tree_psv_nsv`` are the plain torch
  form of its tree queries.

``ms_jump_scan`` picks between them by the device of its tensors, and
``scan_tables`` builds what each form reads.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SEPARATOR
from ..index.device import (DeviceIndex, build_device_index,
                            sparse_table_levels)
from ..utils.buckets import bucket_size
from .ms_dense import DeviceHeadsResult

INT_MAX = 2**31 - 1
I32 = torch.int32

STATE_FIELDS = ("t", "length", "lb", "rb", "pos", "fin", "done", "nrec",
                "viol", "out_t", "out_pos", "out_len", "out_sml")

# calls of the plain scan (the CUDA wrapper keeps its own launch count)
REFERENCE_CALLS = {"ms_jump_scan_reference": 0}


def _bs_rounds(n: int) -> int:
    r = 1
    while (1 << r) < n:
        r += 1
    return r + 1


def build_gmax_table(plcp: torch.Tensor, n: int) -> torch.Tensor:
    """gmax[k][p] = max(g[p .. p+2^k)) for g[p] = p + PLCP[p] (padded with
    -1 past n)."""
    levels = sparse_table_levels(n)
    g = torch.arange(n, dtype=I32, device=plcp.device) + plcp[:n]
    gmax = torch.empty((levels, n), dtype=I32, device=plcp.device)
    gmax[0] = g
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev = gmax[k - 1]
        other = torch.full((n,), -1, dtype=I32, device=plcp.device)
        if half < n:
            other[:n - half] = prev[half:]
        gmax[k] = torch.maximum(prev, other)
    return gmax


def next_ge_device(gmax: torch.Tensor, start: torch.Tensor,
                   t_val: torch.Tensor, n: int) -> torch.Tensor:
    """Vector query: smallest p >= start with g[p] >= t_val (p < n), else
    n."""
    d = torch.zeros_like(start)
    for k in range(gmax.shape[0] - 1, -1, -1):
        w = 1 << k
        s = start + d
        mx = gmax[k][torch.clamp(s, 0, n - 1)]
        d = d + torch.where((s + w <= n) & (mx < t_val), w, 0).to(I32)
    return torch.clamp(start + d, max=n)


def _psv_nsv_fused(jump: torch.Tensor, pi: torch.Tensor, ni: torch.Tensor,
                   ub: torch.Tensor, n: int):
    """(psv_device(jump, pi, ub, n), nsv_device(jump, ni, ub, n)) in one
    descent."""
    dp = torch.zeros_like(pi)
    dn = torch.zeros_like(ni)
    for k in range(jump.shape[0] - 1, -1, -1):
        w = 1 << k
        sp = pi - dp - w + 1
        sn_ = ni + dn
        vp = jump[k][torch.clamp(sp, min=0)]
        vn = jump[k][torch.clamp(sn_, max=n - 1)]
        dp = dp + torch.where((sp >= 0) & (vp >= ub), w, 0).to(I32)
        dn = dn + torch.where((sn_ + w <= n) & (vn >= ub), w, 0).to(I32)
    rp = pi - dp
    rn = ni + dn
    return (torch.where(rp >= 0, rp, -1).to(I32),
            torch.where(rn < n, rn, -1).to(I32))


# Block trees: level 0 is a base row padded to a multiple of TREE_BLOCK
# with a value that answers no query; level k >= 1 holds the min (or max)
# of TREE_ARITY nodes of level k-1 (of TREE_BLOCK base entries for k = 1),
# padded to a multiple of TREE_ARITY likewise; levels are added while the
# one below spans more than one group. A 128-entry block and a 32-node
# group are each one coalesced warp load in the CUDA kernel.
TREE_BLOCK = 128
TREE_ARITY = 32
TREE_MAX_LEVELS = 6        # the kernel's bound: enough for n < 2^31


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def tree_geometry(n: int) -> tuple[tuple[int, ...], tuple[int, ...], int]:
    """(offsets, counts, size) of a block tree over a base row of n >= 1
    entries: level k starts at offsets[k] and has counts[k] real
    entries."""
    offsets, counts = [0], [n]
    size = _ceil_to(n, TREE_BLOCK)
    group = TREE_BLOCK
    while counts[-1] > group:
        c = -(-counts[-1] // group)
        offsets.append(size)
        counts.append(c)
        size += _ceil_to(c, TREE_ARITY)
        group = TREE_ARITY
    return tuple(offsets), tuple(counts), size


@dataclass
class BlockTrees:
    """What the CUDA scan reads in place of the two sparse tables: one
    geometry (``tree_geometry(n)``), two int32 trees."""

    lcp: torch.Tensor          # minima over LCP[0..n), padded with INT_MAX
    g: torch.Tensor            # maxima over p + PLCP[p], padded with -1
    offsets: tuple[int, ...]   # start of each level in both
    n: int


def _block_tree(base: torch.Tensor, n: int, fill: int, reduce):
    offsets, counts, size = tree_geometry(n)
    data = torch.full((size,), fill, dtype=I32, device=base.device)
    data[:n] = base[:n]
    for k in range(1, len(offsets)):
        width = TREE_BLOCK if k == 1 else TREE_ARITY
        lo = offsets[k - 1]
        children = data[lo:lo + counts[k] * width].view(counts[k], width)
        data[offsets[k]:offsets[k] + counts[k]] = reduce(children, dim=1)
    return data


def build_block_trees(lcp: torch.Tensor, plcp: torch.Tensor,
                      n: int) -> BlockTrees:
    """The min tree over LCP[0..n) and the max tree over g[p] = p +
    PLCP[p], on the device of ``lcp``."""
    offsets = tree_geometry(n)[0]
    if len(offsets) > TREE_MAX_LEVELS:
        raise ValueError(f"block tree of n={n}: more than "
                         f"{TREE_MAX_LEVELS} levels")
    g = torch.arange(n, dtype=I32, device=plcp.device) + plcp[:n]
    return BlockTrees(lcp=_block_tree(lcp, n, INT_MAX, torch.amin),
                      g=_block_tree(g, n, -1, torch.amax),
                      offsets=offsets, n=n)


def _tree_search(data, offsets, s, thr, hit, forward: bool):
    """Per query, as the kernel walks a tree: the first base index p >= s
    (``forward``) or the last p <= s with ``hit(value, thr)``, else -1;
    0 <= s < padded base length. Scans s's own block, climbs to the lowest
    level whose group holds an answering node past (before) s's ancestor,
    and descends the first (last) answering child at each level."""
    s = s.to(torch.int64)
    thr = thr.to(torch.int64)[:, None]
    big = torch.iinfo(torch.int64).max

    def first_hit(idx, ok):
        """Per row: the first (last) column index with ok, else -1."""
        if forward:
            v = torch.where(ok, idx, big).amin(dim=1)
            return torch.where(v == big, -1, v)
        return torch.where(ok, idx, -1).amax(dim=1)

    def block(start):
        return start[:, None] + torch.arange(TREE_BLOCK, device=s.device)

    j = block((s // TREE_BLOCK) * TREE_BLOCK)
    side = (j >= s[:, None]) if forward else (j <= s[:, None])
    res = first_hit(j, side & hit(data[j], thr))
    level = torch.zeros_like(s)
    node = torch.zeros_like(s)
    idx = s // TREE_BLOCK
    for k in range(1, len(offsets)):
        j = (idx & ~(TREE_ARITY - 1))[:, None] + torch.arange(
            TREE_ARITY, device=s.device)
        past = (j > idx[:, None]) if forward else (j < idx[:, None])
        found = first_hit(j, past & hit(data[offsets[k] + j], thr))
        take = (res < 0) & (level == 0) & (found >= 0)
        level = torch.where(take, k, level)
        node = torch.where(take, found, node)
        idx = idx // TREE_ARITY
    for k in range(len(offsets) - 2, 0, -1):
        down = level > k
        j = (node * TREE_ARITY)[:, None] + torch.arange(TREE_ARITY,
                                                        device=s.device)
        child = first_hit(j, hit(data[offsets[k] + torch.where(
            down[:, None], j, 0)], thr))
        node = torch.where(down, child, node)
    j = block(node * TREE_BLOCK)
    deep = first_hit(j, hit(data[j], thr))
    return torch.where(res >= 0, res, torch.where(level > 0, deep, -1))


def tree_next_ge(trees: BlockTrees, start: torch.Tensor,
                 t_val: torch.Tensor) -> torch.Tensor:
    """next_ge_device over the g max tree: smallest p >= start with g[p] >=
    t_val (p < n), else n; 0 <= start <= n."""
    n = trees.n
    inside = start < n
    p = _tree_search(trees.g, trees.offsets, torch.where(inside, start, 0),
                     t_val, lambda v, t: v >= t, True)
    return torch.where(inside & (p >= 0) & (p < n), p, n).to(I32)


def tree_psv_nsv(trees: BlockTrees, pi: torch.Tensor, ni: torch.Tensor,
                 ub: torch.Tensor):
    """_psv_nsv_fused over the LCP min tree: (largest p <= pi with LCP[p]
    < ub, else -1; smallest p >= ni, p < n, with LCP[p] < ub, else -1);
    0 <= pi < n, 0 <= ni <= n."""
    n = trees.n
    hit = lambda v, u: v < u
    p = _tree_search(trees.lcp, trees.offsets, pi, ub, hit, False)
    inside = ni < n
    q = _tree_search(trees.lcp, trees.offsets, torch.where(inside, ni, 0),
                     ub, hit, True)
    return p.to(I32), torch.where(inside & (q >= 0) & (q < n), q,
                                  -1).to(I32)


def _where(c, a, b):
    return torch.where(c, a, b).to(I32)


def _extend(x_padded, sa, sx_padded, st, chunk_ends, n, sn, cap, W,
            rounds):
    """One masked extension step over all lanes (JAX ``extend_body``),
    updating ``st`` in place."""
    dev = chunk_ends.device
    L = chunk_ends.shape[0]
    row = torch.arange(L, device=dev)
    kar = torch.arange(W, dtype=I32, device=dev)
    sx_hi = sn + W - 1
    x_hi = x_padded.shape[0] - 1
    t, length, lb, rb, pos = (st[k] for k in ("t", "length", "lb", "rb",
                                               "pos"))
    fin, done = st["fin"], st["done"]

    act = ~done & ~fin
    cur_char = sx_padded[torch.clamp(t, 0, sx_hi)]
    sep_emit = act & (length == 0) & (cur_char == SEPARATOR)
    singleton = act & ~sep_emit & (lb == rb)
    j_abs = t + length
    win_sx = sx_padded[torch.clamp(j_abs[:, None] + kar[None, :], 0, sx_hi)]
    win_x = x_padded[torch.clamp((pos + length)[:, None] + kar[None, :],
                                 0, x_hi)]
    neq = win_sx != win_x
    any_neq = neq.any(dim=1)
    dmm = _where(any_neq, neq.to(torch.uint8).argmax(dim=1).to(I32), W)
    sgl_final = singleton & any_neq
    dcl = torch.clamp(dmm, 0, W - 1).long()
    sgl_smaller = win_x[row, dcl] > win_sx[row, dcl]   # unsigned bytes

    nons = act & ~sep_emit & (lb != rb)
    c = sx_padded[torch.clamp(j_abs, 0, sx_hi)]
    lo1, hi1, lo2, hi2 = lb, rb + 1, lb, rb + 1
    for _ in range(rounds):
        if not bool((nons & ((lo1 < hi1) | (lo2 < hi2))).any()):
            break
        m1 = (lo1 + hi1) >> 1
        m2 = (lo2 + hi2) >> 1
        k1 = x_padded[torch.clamp(sa[torch.clamp(m1, 0, n - 1)] + length,
                                  0, x_hi)]
        k2 = x_padded[torch.clamp(sa[torch.clamp(m2, 0, n - 1)] + length,
                                  0, x_hi)]
        go1 = k1 < c
        a1 = lo1 < hi1
        lo1, hi1 = (_where(a1 & go1, m1 + 1, lo1),
                    _where(a1 & ~go1, m1, hi1))
        go2 = k2 <= c
        a2 = lo2 < hi2
        lo2, hi2 = (_where(a2 & go2, m2 + 1, lo2),
                    _where(a2 & ~go2, m2, hi2))
    lower, upper = lo1, lo2
    bs_found = nons & (lower < upper)
    at_end = lower == rb + 1
    bs_maxmatch = _where(at_end, rb, lower)
    bs_final = nons & (lower >= upper)

    new_lb = _where(bs_found, lower, lb)
    new_rb = _where(bs_found, upper - 1, rb)
    new_pos = _where(bs_found, sa[torch.clamp(lower, 0, n - 1)], pos)
    new_len = (length + bs_found.to(I32)
               + _where(singleton, dmm, 0)).to(I32)
    final = sgl_final | bs_final
    fpos = _where(bs_final, sa[torch.clamp(bs_maxmatch, 0, n - 1)], new_pos)
    fsml = torch.where(bs_final, ~at_end, sgl_smaller)

    emit = final | sep_emit
    nrec = st["nrec"]
    w = emit & (nrec < cap)   # a record past the capacity is dropped
    if bool(w.any()):
        r, col = row[w], nrec[w].long()
        st["out_t"][r, col] = t[w]
        st["out_pos"][r, col] = _where(sep_emit, n - 1, fpos)[w]
        st["out_len"][r, col] = _where(sep_emit, 0, new_len)[w]
        st["out_sml"][r, col] = (fsml & ~sep_emit)[w]
    st["viol"] = st["viol"] | (emit & (nrec >= cap))
    st["nrec"] = nrec + emit.to(I32)

    t = t + emit.to(I32)
    st["t"] = t
    st["length"] = _where(sep_emit, 0,
                          _where(final, new_len - 1,
                                 _where(act, new_len, length)))
    st["lb"] = _where(sep_emit, 0, _where(act & ~final, new_lb, lb))
    st["rb"] = _where(sep_emit, n - 1, _where(act & ~final, new_rb, rb))
    st["pos"] = _where(sep_emit, n - 1,
                       _where(final, fpos, _where(act, new_pos, pos)))
    st["fin"] = fin | final
    st["done"] = done | (act & (t >= chunk_ends))


def _skip_adjust(sa, isa, jump, gmax, st, chunk_ends, n):
    """Batched skip + adjust for parked lanes (JAX ``skip_adjust_body``),
    updating ``st`` in place."""
    t, length, lb, rb, pos = (st[k] for k in ("t", "length", "lb", "rb",
                                               "pos"))
    done = st["done"]
    park = st["fin"] & ~done
    p_found = next_ge_device(gmax, torch.clamp(pos + 1, 0, n),
                             pos + length + 1, n)
    q = torch.clamp(p_found - (pos + 1), min=0)
    q = _where(park, torch.minimum(q, chunk_ends - t), 0)
    t = t + q
    pos = pos + q
    length = length - _where(park, q, 0)
    done = done | (park & (t >= chunk_ends))
    alive = park & ~(t >= chunk_ends)
    adj_sgl = alive & (lb == rb)
    adj_wide = alive & (lb != rb)
    suflo = sa[torch.clamp(lb, 0, n - 1)]
    sufhi = sa[torch.clamp(rb, 0, n - 1)]
    at_root = adj_wide & ((suflo == n - 1) | (sufhi == n - 1))
    isa_next = isa[torch.clamp(pos + 1, 0, n - 1)]
    qlo = _where(adj_sgl, isa_next, isa[torch.clamp(suflo + 1, 0, n - 1)])
    qhi = _where(adj_sgl, isa_next, isa[torch.clamp(sufhi + 1, 0, n - 1)])
    p, qn = _psv_nsv_fused(jump, qlo, qhi + 1, length, n)
    p = _where(p == -1, 0, p)
    qn = _where(qn == -1, n - 1, qn - 1)
    adj_apply = alive & ~at_root
    lb = _where(adj_apply, p, _where(at_root, 0, lb))
    rb = _where(adj_apply, qn, _where(at_root, n - 1, rb))
    st.update(t=t, pos=_where(alive, sa[torch.clamp(lb, 0, n - 1)], pos),
              length=length, lb=lb, rb=rb, done=done,
              fin=st["fin"] & ~alive)


def ms_jump_scan_reference(x_padded, sa, isa, jump, gmax, sx_padded,
                           state: dict, chunk_ends, *, n: int, sn: int,
                           cap: int, window: int) -> dict:
    """Plain torch form of the scan: run every lane to the end of its
    chunk. ``state`` is the dict of ``jump_init_state``; the returned dict
    holds the final lane state and the record buffers, equal to repeated
    JAX ``ms_jump_step`` calls until every lane is done."""
    REFERENCE_CALLS["ms_jump_scan_reference"] += 1
    st = dict(state)
    rounds = _bs_rounds(n)
    while not bool(st["done"].all()):
        _extend(x_padded, sa, sx_padded, st, chunk_ends, n, sn, cap,
                window, rounds)
        _skip_adjust(sa, isa, jump, gmax, st, chunk_ends, n)
    return st


def scan_tables(index: DeviceIndex):
    """What the scan reads beside the text, SA and ISA, on the device of
    ``index``: the block trees for the CUDA kernel, the sparse tables
    ``(jump, gmax)`` for the plain version."""
    if index.sa.device.type == "cuda":
        return build_block_trees(index.lcp, index.plcp, index.n)
    return index.jump, build_gmax_table(index.plcp, index.n)


def ms_jump_scan(x_padded, sa, isa, tables, sx_padded, state: dict,
                 chunk_ends, *, n: int, sn: int, cap: int,
                 window: int) -> dict:
    """The scan on the device of its tensors: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; ``tables`` as
    ``scan_tables`` builds them for that device."""
    dev = chunk_ends.device.type
    if dev == "cuda":
        from ..kernels import ms_jump_scan_cuda
        return ms_jump_scan_cuda(x_padded, sa, isa, tables, sx_padded,
                                 state, chunk_ends, n=n, sn=sn, cap=cap,
                                 window=window)
    if dev == "cpu":
        jump, gmax = tables
        return ms_jump_scan_reference(x_padded, sa, isa, jump, gmax,
                                      sx_padded, state, chunk_ends, n=n,
                                      sn=sn, cap=cap, window=window)
    raise ValueError(f"ms_jump_scan: unsupported device {dev!r}")


def _initial_cap(chunk_len: int) -> int:
    """Record slots per lane for the first try; the scan retries with the
    capacity doubled while any lane overflows (viol)."""
    return max(64, bucket_size(int(3 * chunk_len // 16 + 64)))


@dataclass
class LaneSplit:
    """The collection cut into one contiguous chunk per lane, as the scan
    is launched on it."""

    lanes: int
    chunk_len: int
    starts: np.ndarray        # int32 [lanes] host chunk starts
    ends: np.ndarray          # int32 [lanes] host chunk ends
    ends_dev: torch.Tensor    # int32 [lanes] on the device
    sx_padded: torch.Tensor   # uint8 [sn + window] (window zero bytes)
    cap: int                  # record slots per lane on the first try

    def init_state(self, n: int, cap: int | None = None) -> dict:
        return jump_init_state(self.starts, self.ends, self.lanes, n,
                               self.cap if cap is None else cap,
                               self.ends_dev.device)


def split_lanes(sx: np.ndarray, lanes: int, window: int, device) -> LaneSplit:
    """Cut ``sx`` into at most ``lanes`` equal chunks (the last may be
    short) and upload it padded for the scan's window compares."""
    sn = int(len(sx))
    lanes = max(1, min(lanes, sn))
    chunk_len = -(-sn // lanes)
    starts = (np.arange(lanes) * chunk_len).astype(np.int32)
    ends = np.minimum(starts + chunk_len, sn).astype(np.int32)
    sx_padded = torch.from_numpy(np.concatenate(
        [np.asarray(sx, np.uint8), np.zeros(window, np.uint8)])).to(device)
    return LaneSplit(lanes=lanes, chunk_len=chunk_len, starts=starts,
                     ends=ends, ends_dev=torch.from_numpy(ends).to(device),
                     sx_padded=sx_padded, cap=_initial_cap(chunk_len))


def jump_init_state(chunk_starts, chunk_ends, L: int, n: int, cap: int,
                    device) -> dict:
    state = {
        "t": np.asarray(chunk_starts, np.int32),
        "length": np.zeros(L, np.int32),
        "lb": np.zeros(L, np.int32),
        "rb": np.full(L, n - 1, np.int32),
        "pos": np.full(L, n - 1, np.int32),
        "fin": np.zeros(L, bool),
        "done": np.asarray(chunk_starts >= chunk_ends),
        "nrec": np.zeros(L, np.int32),
        "viol": np.zeros(L, bool),
    }
    st = {k: torch.from_numpy(v).to(device) for k, v in state.items()}
    for k in ("out_t", "out_pos", "out_len"):
        st[k] = torch.zeros((L, cap), dtype=I32, device=device)
    st["out_sml"] = torch.zeros((L, cap), dtype=torch.bool, device=device)
    return st


def _compact_candidates(out_t, out_pos, out_len, out_sml, nrec, sx_padded,
                        cap: int, sn: int, h_pad: int):
    """Concatenate per-lane candidate records in text order, apply the
    global head test, and compact true heads (+ the head char = previous
    collection char, cyclic). Returns zero-padded [h_pad] arrays and h."""
    dev = out_t.device
    slot = torch.arange(cap, dtype=I32, device=dev)[None, :]
    valid = slot < nrec[:, None]
    key = torch.where(valid, out_t, INT_MAX).reshape(-1)
    t_f, order = torch.sort(key, stable=True)
    pos_f = out_pos.reshape(-1)[order]
    len_f = out_len.reshape(-1)[order]
    sml_f = out_sml.reshape(-1)[order]
    total = int(valid.sum())
    t_f, pos_f, len_f, sml_f = (a[:total] for a in (t_f, pos_f, len_f,
                                                    sml_f))
    is_head = torch.ones(total, dtype=torch.bool, device=dev)
    is_head[1:] = pos_f[1:] != pos_f[:-1] + (t_f[1:] - t_f[:-1])
    hidx = torch.nonzero(is_head).squeeze(1)
    h = int(hidx.shape[0])

    def pad(a, dtype):
        out = torch.zeros(h_pad, dtype=dtype, device=dev)
        out[:h] = a[hidx]
        return out
    t_h = pad(t_f, I32)
    prev_idx = torch.where(t_h[:h] > 0, t_h[:h] - 1, sn - 1)
    chr_h = torch.zeros(h_pad, dtype=torch.uint8, device=dev)
    chr_h[:h] = sx_padded[torch.clamp(prev_idx, 0, sn - 1)]
    return (t_h, pad(pos_f, I32), pad(len_f, I32), pad(sml_f, torch.bool),
            chr_h, h)


def _ref_pad(sa, isa, bwt, n: int, n_pad: int):
    """Reference index in merge layout: zero-padded (or cut) to n_pad."""
    def pad(a):
        out = torch.zeros(n_pad, dtype=a.dtype, device=a.device)
        m = min(n, n_pad)
        out[:m] = a[:m]
        return out
    return pad(sa), pad(isa), pad(bwt)


def ms_jump_heads(x_aug: np.ndarray, sx: np.ndarray, device,
                  lanes: int = 4096, window: int = 64,
                  index: DeviceIndex | None = None,
                  timer=None) -> DeviceHeadsResult:
    """Run the jump scan end to end on ``device``; returns a
    DeviceHeadsResult ready for engine/device_merge. ``timer`` (a
    PhaseTimer) records the jump_index, ms_scan and compact phases."""
    device = torch.device(device)

    def phase(name):
        if timer is None:
            return contextlib.nullcontext()
        return timer.phase(name)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sn = int(len(sx))
    with phase("jump_index"):
        if index is None:
            index = build_device_index(np.asarray(x_aug), device)
        n = index.n
        tables = scan_tables(index)
        sync()
    with phase("ms_scan"):
        split = split_lanes(sx, lanes, window, device)
        sx_dev, cap = split.sx_padded, split.cap
        while True:
            state = ms_jump_scan(index.x_padded, index.sa, index.isa,
                                 tables, sx_dev,
                                 split.init_state(n, cap), split.ends_dev,
                                 n=n, sn=sn, cap=cap, window=window)
            if not bool(state["viol"].any()):
                break
            cap = bucket_size(cap * 2 + 1)
            if cap > max(2 * split.chunk_len, 1024):
                raise RuntimeError("ms_jump: record capacity runaway")
        sync()
    with phase("compact"):
        total = int(state["nrec"].to(torch.int64).sum())
        h_pad = min(bucket_size(total + 1), split.lanes * cap)
        t_h, pos_h, len_h, sml_h, chr_h, h = _compact_candidates(
            state["out_t"], state["out_pos"], state["out_len"],
            state["out_sml"], state["nrec"], sx_dev, cap, sn, h_pad)
        n_pad = bucket_size(n + 1)
        ref_sa, ref_isa, ref_bwt = _ref_pad(index.sa, index.isa, index.bwt,
                                            n, n_pad)
        hb = bucket_size(h + 1)
        if hb < h_pad:
            t_h, pos_h, len_h, sml_h, chr_h = (
                a[:hb] for a in (t_h, pos_h, len_h, sml_h, chr_h))
        sync()
    return DeviceHeadsResult(
        head_t=t_h, head_pos=pos_h, head_len=len_h, head_smaller=sml_h,
        head_char=chr_h, ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, n=n, sn=sn, irreducible=0)
