"""The decomposition of the CUDA dense_neighbors kernel
(cmsbwt_tpu_torch/kernels/csrc/dense_neighbors.cu), emulated in numpy and
held to the port's plain neighbor scans (ops/ms_dense.neighbors_reference).

The emulation mirrors the kernel step for step: tiles of THREADS threads
of ITEMS consecutive slots (zeros loaded past m), each thread's serial
fold, warp scans of 32 lanes as strided combines (the __shfl_up_sync /
__shfl_down_sync steps, a lane past the warp's edge reading its own
value), warp 0's scan of the warp aggregates, the carry blocks' scans of
chunks of CARRY_THREADS x CARRY_ITEMS tile aggregates (exclusive within
the chunk), the last carry block's scan of the chunk aggregates
(CHUNKS_PER_LANE per lane) into chunk prefixes, each tile's carry from
its chunk's prefix and its carry within the chunk,
and the one-slot halos, by shuffle from the neighbouring lane and from
memory across warps and tiles. Inputs are random sa/ell rows made with numpy
from seeds. Tolerance: exact."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pytest
import torch

from cmsbwt_tpu_torch.ops.ms_dense import neighbors_reference

INT_MIN, INT_MAX = -(2**31), 2**31 - 1
F_RESET, F_HAS = 1, 2


@dataclass(frozen=True)
class Geometry:
    threads: int = 512          # the kernel's constants
    items: int = 8
    carry_threads: int = 256
    carry_items: int = 16
    chunks_per_lane: int = 4

    @property
    def tile(self):
        return self.threads * self.items

    @property
    def chunk(self):
        return self.carry_threads * self.carry_items


KERNEL = Geometry()
SMALL = Geometry(64, 4, 32, 2)   # 256-slot tiles, 64-tile carry chunks
TINY = Geometry(32, 2, 32, 1)    # 64-slot tiles, 32-tile carry chunks


class Seg:
    """Arrays of scan states (v, sa, fl), as the kernel's three words."""

    def __init__(self, v, sa, fl):
        self.v, self.sa, self.fl = (np.asarray(a, np.int64) for a in
                                    (v, sa, fl))

    @staticmethod
    def identity(shape):
        return Seg(np.full(shape, INT_MAX), np.full(shape, -1),
                   np.zeros(shape))

    def where(self, mask, other):
        return Seg(*(np.where(mask, a, b) for a, b in
                     zip(self.words(), other.words())))

    def words(self):
        return self.v, self.sa, self.fl

    def map(self, f):
        return Seg(*(f(a) for a in self.words()))


def combine(x: Seg, y: Seg) -> Seg:
    """x then y in scan order (the kernel's combine)."""
    return Seg(np.where(y.fl & F_RESET, y.v, np.minimum(x.v, y.v)),
               np.where(y.fl & F_HAS, y.sa, x.sa), x.fl | y.fl)


def shfl(x: Seg, d: int, bwd: bool) -> Seg:
    """__shfl_up_sync / __shfl_down_sync by d over the last axis (32
    lanes): a lane whose source is past the warp's edge keeps its value."""
    def one(a):
        out = a.copy()
        if bwd:
            out[..., :32 - d] = a[..., d:]
        else:
            out[..., d:] = a[..., :32 - d]
        return out
    return x.map(one)


def warp_scan(x: Seg, bwd: bool):
    """(exclusive prefix per lane, fold of the 32 lanes); last axis = 32."""
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        y = shfl(x, d, bwd)
        act = lane + d < 32 if bwd else lane >= d
        x = combine(y, x).where(act, x)
    ex = shfl(x, 1, bwd).where(lane != (31 if bwd else 0),
                               Seg.identity(x.v.shape))
    total = x.map(lambda a: a[..., 0 if bwd else 31])
    return ex, total


def block_scan(x: Seg, carry: Seg, bwd: bool):
    """x: [blocks, threads]; carry: [blocks]. Returns (each thread's
    exclusive prefix from carry, the block's fold without the carry)."""
    blocks, threads = x.v.shape
    nw = threads // 32
    ex, wtot = warp_scan(x.map(lambda a: a.reshape(blocks, nw, 32)), bwd)
    lanes = Seg.identity((blocks, 32))
    for a, w in zip(lanes.words(), wtot.words()):
        a[:, :nw] = w
    wex, total = warp_scan(lanes, bwd)
    wagg = combine(carry.map(lambda a: a[:, None]),
                   wex.map(lambda a: a[:, :nw]))
    r = combine(wagg.map(lambda a: a[:, :, None]), ex)
    return r.map(lambda a: a.reshape(blocks, threads)), total


def tile_items(sa, ell, m: int, g: Geometry):
    """The kernel's register items and halos, [tiles, threads, items]."""
    tiles = -(-m // g.tile)
    flat_sa = np.zeros(tiles * g.tile, np.int64)
    flat_ell = np.zeros(tiles * g.tile, np.int64)
    flat_sa[:m], flat_ell[:m] = sa, ell
    s = flat_sa.reshape(tiles, g.threads, g.items)
    e = flat_ell.reshape(tiles, g.threads, g.items)
    t = np.arange(g.threads)
    lane = t % 32
    # halos by shuffle inside a warp
    w = lambda a: a.reshape(tiles, g.threads // 32, 32)
    sa_prev = shfl(Seg(w(s[:, :, -1]), w(s[:, :, -1]), w(s[:, :, -1])), 1,
                   False).v.reshape(tiles, g.threads)
    nxt = shfl(Seg(w(s[:, :, 0]), w(e[:, :, 0]), w(e[:, :, 0])), 1, True)
    sa_next = nxt.v.reshape(tiles, g.threads)
    ell_next = nxt.sa.reshape(tiles, g.threads)
    # lanes 0 and 31 load theirs from memory (across warps and tiles)
    r0 = np.arange(tiles)[:, None] * g.tile + t[None, :] * g.items
    from_mem = (lane == 0)[None, :] & (r0 > 0)
    sa_prev = np.where(from_mem, flat_sa[np.maximum(r0 - 1, 0)], sa_prev)
    nx = r0 + g.items
    from_mem = (lane == 31)[None, :] & (nx < m)
    at = np.minimum(nx, m - 1)
    sa_next = np.where(from_mem, flat_sa[at], sa_next)
    ell_next = np.where(from_mem, flat_ell[at], ell_next)
    return s, e, sa_prev, sa_next, ell_next


def element(items, j: int, n: int, m: int, g: Geometry, bwd: bool) -> Seg:
    """Element j of every thread ([tiles, threads])."""
    s, e, sa_prev, sa_next, ell_next = items
    tiles = s.shape[0]
    r = (np.arange(tiles)[:, None] * g.tile
         + np.arange(g.threads)[None, :] * g.items + j)
    has = np.where(s[:, :, j] < n, F_HAS, 0)
    if bwd:
        sn = s[:, :, j + 1] if j + 1 < g.items else sa_next
        en = e[:, :, j + 1] if j + 1 < g.items else ell_next
        end = r == m - 1
        fl = has | np.where(end | (sn < n), F_RESET, 0)
        return Seg(np.where(end, 0, en), s[:, :, j], fl)
    sp = s[:, :, j - 1] if j > 0 else sa_prev
    fl = has | np.where((r == 0) | (sp < n), F_RESET, 0)
    return Seg(e[:, :, j], s[:, :, j], fl)


def valid(tiles: int, j: int, m: int, g: Geometry):
    r = (np.arange(tiles)[:, None] * g.tile
         + np.arange(g.threads)[None, :] * g.items + j)
    return r < m


def order(g_items: int, bwd: bool):
    return range(g_items - 1, -1, -1) if bwd else range(g_items)


def thread_fold(items, n, m, g, bwd) -> Seg:
    tiles = items[0].shape[0]
    acc = Seg.identity((tiles, g.threads))
    for j in order(g.items, bwd):
        acc = combine(acc, element(items, j, n, m, g, bwd)).where(
            valid(tiles, j, m, g), acc)
    return acc


def carry_chunks(agg: Seg, g: Geometry, bwd: bool):
    """nb_tile_carry: per chunk, the exclusive scan of its tile aggregates
    and the chunk's fold. Returns (car [tiles], cagg [chunks])."""
    tiles = agg.v.shape[0]
    nch = -(-tiles // g.chunk)
    gi = np.arange(nch * g.chunk)
    x = agg.map(lambda a: a[np.minimum(gi, tiles - 1)]).where(
        gi < tiles, Seg.identity(gi.shape))
    x = x.map(lambda a: a.reshape(nch, g.carry_threads, g.carry_items))
    acc = Seg.identity((nch, g.carry_threads))
    for j in order(g.carry_items, bwd):
        acc = combine(acc, x.map(lambda a: a[:, :, j]))
    acc, cagg = block_scan(acc, Seg.identity(nch), bwd)
    out = Seg.identity((nch, g.carry_threads, g.carry_items))
    for j in order(g.carry_items, bwd):
        for o, a in zip(out.words(), acc.words()):
            o[:, :, j] = a
        acc = combine(acc, x.map(lambda a: a[:, :, j]))
    return out.map(lambda a: a.reshape(-1)[:tiles]), cagg


def chunk_prefixes(cagg: Seg, g: Geometry, bwd: bool) -> Seg:
    """The last carry block's warp: lane l holds chunks [l*K, l*K + K),
    folds them, scans the lanes (exclusive) and hands each chunk the fold
    of the chunks before it in scan order."""
    nch = cagg.v.shape[0]
    k = np.arange(32 * g.chunks_per_lane)
    x = cagg.map(lambda a: a[np.minimum(k, nch - 1)]).where(
        k < nch, Seg.identity(k.shape))
    x = x.map(lambda a: a.reshape(32, g.chunks_per_lane))
    acc = Seg.identity(32)
    for j in order(g.chunks_per_lane, bwd):
        acc = combine(acc, x.map(lambda a: a[:, j]))
    acc, _ = warp_scan(acc, bwd)
    pre = Seg.identity((32, g.chunks_per_lane))
    for j in order(g.chunks_per_lane, bwd):
        for p, a in zip(pre.words(), acc.words()):
            p[:, j] = a
        acc = combine(acc, x.map(lambda a: a[:, j]))
    return pre.map(lambda a: a.reshape(-1)[:nch])


def emulate(sa: np.ndarray, ell: np.ndarray, n: int, g: Geometry):
    """(pred_pos, succ_pos, a, b) as the kernel computes them."""
    m = len(sa)
    items = tile_items(sa, ell, m, g)
    tiles = items[0].shape[0]
    none = Seg.identity(tiles)
    outs = {}
    for bwd in (False, True):
        # nb_tile_reduce
        _, agg = block_scan(thread_fold(items, n, m, g, bwd), none, bwd)
        # nb_tile_carry
        car, cagg = carry_chunks(agg, g, bwd)
        # nb_tile_emit
        cpre = chunk_prefixes(cagg, g, bwd)
        c = np.arange(tiles) // g.chunk
        car = combine(cpre.map(lambda a: a[c]), car)
        acc, _ = block_scan(thread_fold(items, n, m, g, bwd), car, bwd)
        pos = np.zeros((tiles, g.threads, g.items), np.int64)
        val = np.zeros_like(pos)
        for j in order(g.items, bwd):
            acc = combine(acc, element(items, j, n, m, g, bwd)).where(
                valid(tiles, j, m, g), acc)
            has = (acc.fl & F_HAS) != 0
            pos[:, :, j] = np.where(has, acc.sa, -1)
            val[:, :, j] = np.where(has, acc.v, INT_MIN)
        outs[bwd] = (pos.reshape(-1)[:m], val.reshape(-1)[:m])
    return outs[False][0], outs[True][0], outs[False][1], outs[True][1]


def _inputs(m: int, seed: int, ref_share: float, dead_tiles=None,
            g: Geometry = KERNEL):
    """sa/ell rows: a share ``ref_share`` of reference slots (sa < n), none
    in the tiles of ``dead_tiles``."""
    rng = np.random.default_rng(seed)
    n = 1000
    is_ref = rng.random(m) < ref_share
    if dead_tiles is not None:
        lo, hi = dead_tiles
        is_ref[lo * g.tile:hi * g.tile] = False
    sa = np.where(is_ref, rng.integers(0, n, m), rng.integers(n, 4 * n, m))
    ell = rng.integers(0, 50, m)
    return sa.astype(np.int32), ell.astype(np.int32), n


T = KERNEL.tile
CASES = {
    "m1": (1, 0.5, None, KERNEL),
    "m31": (31, 0.2, None, KERNEL),
    "m32": (32, 0.2, None, KERNEL),
    "m33": (33, 0.2, None, KERNEL),
    "tile-1": (T - 1, 0.05, None, KERNEL),
    "tile": (T, 0.05, None, KERNEL),
    "tile+1": (T + 1, 0.05, None, KERNEL),
    "3tiles-1": (3 * T - 1, 0.01, None, KERNEL),
    "3tiles+1": (3 * T + 1, 0.01, None, KERNEL),
    "dead_tiles": (6 * T + 5, 0.01, (1, 5), KERNEL),
    "all_ref": (2 * T + 7, 1.0, None, KERNEL),
    "no_ref": (2 * T + 7, 0.0, None, KERNEL),
    "small_chunks": (150 * SMALL.tile + 3, 0.002, (20, 90), SMALL),
    "many_chunks": (70 * TINY.chunk * TINY.tile + 5, 0.0003, (900, 1500),
                    TINY),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tile_decomposition_matches_reference(case):
    m, share, dead, g = CASES[case]
    sa, ell, n = _inputs(m, len(case) * 7 + m, share, dead, g)
    if case == "no_ref":
        n = 0
    got = emulate(sa, ell, n, g)
    want = neighbors_reference(torch.from_numpy(sa), torch.from_numpy(ell),
                               n, m)
    for k, a, b in zip(("pred_pos", "succ_pos", "a", "b"), want, got):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
