"""The tile decomposition of the device merge's single-pass kernels,
checked on the CPU without a card: a numpy emulation of what
cmsbwt_tpu_torch/kernels/csrc/running_fill.cu, tail_good_join.cu and
run_merge.cu (bucket_sums and run_merge) compute per tile, held to the
plain versions, running_fill_reference, _tail_good_join_reference,
_bucket_sums_reference and _run_merge_reference, at several tile sizes,
the kernels' among them. Each kernel is one launch of a decoupled
look-back: a tile takes its place in scan order from a ticket, publishes
its aggregate, looks back over the tiles before it 32 flags at a time
(folding aggregates until it meets a published inclusive state, waiting
while a flag it needs is still empty), publishes its inclusive state and
scans its rows from the exclusive prefix. A tile whose aggregate absorbs
every state before it (the join: a target and a run end; the bucket
sums: a segment start) publishes its inclusive state at once, and a join
tile whose 64-row halo after it holds a target and a run end (or the
last row), or a bucket-sums tile whose 32 lanes before it hold a
segment start, takes its prefix from the halo and does not look back. The
emulation lets the tiles run their steps in a seeded random order, and
the result must not depend on it. For the fill, tiles in the input's
16-byte frame (rows before the first aligned address shift every tile,
and the rows outside [0, m) of a tile read as the identity), run
backward for reverse, and the swizzled shared tile through which a warp
hands its threads their rows; for the join, the forward segmented credit
inside a tile and the tile's trailing good rows credited to the first
target after it; for the bucket sums, outputs that start as garbage and
get every slot written once: each segment's last lane storing its sums,
each segment's first lane zeroing the ranks between the previous
segment's and its own, and every block its share of the ranks past the
last lane's and of the buckets past the last one. Inside a tile the
kernels scan with warp shuffles; the scan's operator is associative, so
a fold in row order gives the same states. Change this emulation with
the kernels' design. Tolerance: exact."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from test_torch_merge_kernels import BUILT_BUCKETS, BUILT_JOINS, \
    BUILT_LANES, _bucket_lanes, _fill_values
from cmsbwt_tpu_torch.engine import device_merge as tm
from cmsbwt_tpu_torch.ops.fill import running_fill_reference

INT_MAX = 2**31 - 1
NONE = INT_MAX
TILES = [1, 3, 8, 64, 2048, 4096, 8192]
ORDERS = (0, 1)   # seeds of the tiles' step order
WINDOW = 32       # tiles a look-back reads at once (one warp's lanes)
HALO = 64         # rows tail_good_join reads after its tile
EMPTY, AGG, INCL = 0, 1, 2


def _lookback(aggs: list, combine, identity, seed: int,
              resident: int = 300, window: int = WINDOW,
              absorbs=lambda a: False, known=None) -> list:
    """Each tile's exclusive prefix in scan order (tile t after tiles 0 ..
    t-1), reached as the kernels reach it: tiles start in ticket order,
    at most ``resident`` at once (the blocks the card holds); a started
    tile publishes its aggregate (flag AGG), then looks back ``window``
    flags at a time — waiting while any flag up to the nearest published
    inclusive state is EMPTY, folding the aggregates up to it — then
    publishes its inclusive state (flag INCL) and leaves. Tile 0, and a tile whose
    aggregate ``absorbs`` (hides every state before it), publishes its
    aggregate as its inclusive state at once; a tile whose prefix is
    ``known`` (a dict: tile -> prefix) publishes the prefix folded with
    its aggregate at once and does not look back.
    The started tiles' steps interleave in an order drawn from ``seed``."""
    T = len(aggs)
    rng = np.random.default_rng(seed)
    flag, incl = [EMPTY] * T, [None] * T
    prefix = [None] * T
    step = [0] * T          # 0: publish, 1: look back
    live, ticket = [], 0
    while live or ticket < T:
        while ticket < T and len(live) < resident:
            live.append(ticket)
            ticket += 1
        t = live[int(rng.integers(len(live)))]
        if step[t] == 0:
            if t == 0:
                incl[0], flag[0], prefix[0] = aggs[0], INCL, identity
                live.remove(0)
            elif known and t in known:
                prefix[t] = known[t]
                incl[t], flag[t] = combine(known[t], aggs[t]), INCL
                live.remove(t)
            elif absorbs(aggs[t]):
                incl[t], flag[t], step[t] = aggs[t], INCL, 1
            else:
                flag[t], step[t] = AGG, 1
            continue
        run, p = identity, t - 1
        while True:
            seen = list(range(p, max(p - window, -1), -1))
            stop = next((i for i, q in enumerate(seen)
                         if flag[q] == INCL), None)
            needed = seen if stop is None else seen[:stop + 1]
            if any(flag[q] == EMPTY for q in needed):
                run = None                  # spin: another tile goes first
                break
            part = identity
            for q in reversed(seen[:len(seen) if stop is None
                                   else stop + 1]):
                part = combine(part, incl[q] if flag[q] == INCL
                               else aggs[q])
            run = combine(part, run)
            if stop is not None:
                break
            p -= window
        if run is not None:
            prefix[t] = run
            if flag[t] != INCL:
                incl[t], flag[t] = combine(run, aggs[t]), INCL
            live.remove(t)
    return prefix


def _join_emulation(k1, k2f, i_s, pay, h_pad: int, tile: int, seed: int):
    J = len(k1)
    k2 = k2f >> 1

    def element(r):
        change = r + 1 >= J or k1[r + 1] != k1[r] or k2[r + 1] != k2[r]
        target = bool(k2f[r] & 1)
        return ((r, int(k1[r]), int(i_s[r])) if target else (NONE, 0, 0),
                r if change else NONE)

    def combine(x, y):              # y: later in the backward scan
        return (y[0] if y[0][0] != NONE else x[0],
                y[1] if y[1] != NONE else x[1])

    ident = ((NONE, 0, 0), NONE)
    bounds = [(lo, min(J, lo + tile)) for lo in range(0, J, tile)]
    agg = []
    for lo, hi in bounds:                            # reduce
        acc = ident
        for r in range(hi - 1, lo - 1, -1):
            acc = combine(acc, element(r))
        agg.append(acc)
    # the halo: the first HALO rows after a tile give its prefix (their
    # first target and first run end) unless they hold neither before the
    # last row
    known = {}
    for t, (lo, hi) in enumerate(bounds):
        pre = ident
        for r in range(min(J, hi + HALO) - 1, hi - 1, -1):
            pre = combine(pre, element(r))
        if (pre[0][0] != NONE and pre[1] != NONE) or hi + HALO >= J:
            known[len(bounds) - 1 - t] = pre
    # look-back, backward: the ticket hands out the last tile first; a
    # tile with a target and a run end hides every row after it
    carry = _lookback(agg[::-1], combine, ident, seed,
                      absorbs=lambda a: a[0][0] != NONE and a[1] != NONE,
                      known=known)[::-1]
    counter = np.zeros(h_pad + 2, np.int64)
    f_cls = np.empty(J, np.int32)
    ekey = np.empty(J, np.int32)
    n_exact = members = 0

    def credit(slot, s):
        if 0 <= slot < h_pad + 2:
            counter[slot] += s
    for t, (lo, hi) in enumerate(bounds):            # emit
        st, good = carry[t], {}
        for r in range(hi - 1, lo - 1, -1):
            st = combine(st, element(r))
            (t_row, t_k1, t_cls), e_row = st
            has = t_row != NONE
            is_q = not k2f[r] & 1
            inn = is_q and has and t_k1 == k1[r] and k1[r] < INT_MAX
            exact = inn and t_row <= e_row
            f_cls[r] = t_cls if has else INT_MAX
            ekey[r] = i_s[r] if exact else INT_MAX
            good[r] = int(pay[r]) if inn and not exact else 0
            n_exact += exact
            members += int(pay[r]) if exact else 0
        s = 0                                        # forward, in the tile
        for r in range(lo, hi):
            if k2f[r] & 1:
                credit(int(pay[r]), s)
                s = 0
            else:
                s += good[r]
        if s and carry[t][0][0] != NONE:             # the tile's trailing
            credit(int(pay[carry[t][0][0]]), s)      # rows: one atomic
    wrapped = ((counter + 2**31) % 2**32 - 2**31).astype(np.int32)
    return wrapped, ekey, f_cls, n_exact, members


def _runs_emulation(k_s, len_s, chr_s, tile: int, seed: int):
    L = len(k_s)
    valid = (k_s < INT_MAX) & (len_s > 0)

    def element(r):
        if not valid[r]:
            return (0, 1, 0), False
        first = r == 0 or not valid[r - 1] or chr_s[r - 1] != chr_s[r]
        last = r + 1 == L or not valid[r + 1] or chr_s[r + 1] != chr_s[r]
        return (int(len_s[r]), int(first), int(last)), last

    def combine(x, y):
        return (y[0] if y[1] else x[0] + y[0], x[1] | y[1], x[2] + y[2])

    bounds = [(lo, min(L, lo + tile)) for lo in range(0, L, tile)]
    agg = []
    for lo, hi in bounds:
        acc = (0, 0, 0)
        for r in range(lo, hi):
            acc = combine(acc, element(r)[0])
        agg.append(acc)
    carry = _lookback(agg, combine, (0, 0, 0), seed)
    run = combine(carry[-1], agg[-1])   # the last tile's inclusive state
    out_len = np.zeros(run[2], np.int32)
    out_chr = np.zeros(run[2], np.uint8)
    for t, (lo, hi) in enumerate(bounds):
        st = carry[t]
        for r in range(lo, hi):
            el, last = element(r)
            st = combine(st, el)
            if last:
                out_len[st[2] - 1] = st[0]
                out_chr[st[2] - 1] = chr_s[r] & 0xFF
    return out_len, out_chr, run[2]


BS_TILE = 4096          # run_merge.cu: BS_TILE
BS_HALO = 32            # run_merge.cu: the lanes before a tile it reads
GARBAGE = 0x5A5A5A5A    # what the outputs' memory held before the launch
# buckets at bucket_sums' tile edges, and rank gaps far longer than a
# thread zeroes alone (run_merge.cu: GAP_SERIAL)
EDGE_BUCKETS = {
    f"straddle_{BS_TILE - 1}": _bucket_lanes(
        [5, BS_TILE - 1, BS_TILE - 1, 9], 3, 100),
    f"straddle_{BS_TILE}": _bucket_lanes(
        [5, BS_TILE, BS_TILE, 1], BS_TILE, 100),
    f"straddle_{BS_TILE + 1}": _bucket_lanes(
        [BS_TILE + 1, BS_TILE + 1, 3], 1, 100, rank0=True),
    "long_gaps": _bucket_lanes(list(range(1, 60)), 9, 200_000, seed=3),
}
BUCKETS = {**BUILT_BUCKETS, **EDGE_BUCKETS}


class _Outputs:
    """Output arrays that start as garbage and count each slot's writes;
    a write outside an array fails."""

    def __init__(self, **sizes):
        self.a = {k: np.full(n, GARBAGE, np.int64) for k, n in sizes.items()}
        self.n = {k: np.zeros(n, np.int64) for k, n in sizes.items()}

    def put(self, k, lo, hi, value):
        assert 0 <= lo <= hi <= len(self.a[k]), (k, lo, hi)
        self.a[k][lo:hi] = value
        self.n[k][lo:hi] += 1


def _bucket_emulation(br, bid, m_c, nec: int, n_pad: int, tile: int,
                      seed: int):
    """bucket_sums by tiles of ``tile`` lanes over the nv = max(nec, 0)
    valid lanes, on outputs that start as garbage. Every block zeroes a
    share of the ranks past the last lane's (index 0 gets the pad lanes'
    count) and of the buckets past the last one (bid[nv - 1] + 1 of them).
    A tile [lo, hi) scans the forward segmented (sum, count) state, reset
    where the rank changes, from its prefix (from the 32 lanes before it
    when a segment starts there, else from the look-back), and owns the
    ranks
    [A, B) = [rank(lo - 1) + 1, rank(hi - 1)) (clamped to [0, n_pad)) and
    the buckets J0 + 1 .. J0 + S - 1 (J0 = bid(lo - 1), S its segment
    starts): it writes them whole, zeros and sums, as its shared stage
    does; a segment's last lane whose rank lies outside [A, B) (the two
    buckets the tile shares with its neighbours) stores its sums
    directly. Returns the three outputs, their write counts and the fault
    word."""
    h_pad = len(br)
    nv = max(nec, 0)
    pad = h_pad - nv
    out = _Outputs(hb_at=n_pad, ncls_at=n_pad, hb_b=h_pad)

    def zero_ranks(lo, hi):
        if lo < hi:
            out.put("hb_at", lo, hi, 0)
            out.put("ncls_at", lo, hi, 0)
            if lo == 0:
                out.a["ncls_at"][0] = pad

    def element(r):
        start = r == 0 or br[r - 1] != br[r]
        return (int(m_c[r]), 1, int(start))

    def combine(x, y):
        return ((y[0] if y[2] else x[0] + y[0]) & 0xFFFFFFFF,
                y[1] if y[2] else x[1] + y[1], x[2] | y[2])

    last = int(br[nv - 1]) if nv else -1
    nb = min(max(int(bid[nv - 1]), 0), h_pad - 1) + 1 if nv else 0
    zero_ranks(max(last + 1, 0), n_pad)
    if nb < h_pad:
        out.put("hb_b", nb, h_pad, 0)
    ident = (0, 0, 0)
    bounds = [(lo, min(nv, lo + tile)) for lo in range(0, nv, tile)]
    agg = []
    for lo, hi in bounds:
        acc = ident
        for r in range(lo, hi):
            acc = combine(acc, element(r))
        agg.append(acc)
    # a tile where a segment starts hides every lane before it; a tile
    # whose 32-lane halo before it holds a segment start takes its
    # prefix from the halo (the sums since that start) and does not look
    # back
    known = {}
    for t, (lo, hi) in enumerate(bounds):
        starts = [r for r in range(max(lo - BS_HALO, 0), lo)
                  if element(r)[2]]
        if lo > 0 and starts:
            pre = ident
            for r in range(starts[-1], lo):
                pre = combine(pre, element(r))
            known[t] = pre
    carry = _lookback(agg, combine, ident, seed, absorbs=lambda a: a[2],
                      known=known)
    fault = 0
    for t, (lo, hi) in enumerate(bounds):
        A = min(max(0 if lo == 0 else int(br[lo - 1]) + 1, 0), n_pad)
        B = min(max(int(br[hi - 1]), A), n_pad)
        J0 = min(max(-1 if lo == 0 else int(bid[lo - 1]), -1), h_pad - 1)
        stage_hb = np.zeros(B - A, np.int64)
        stage_nc = np.zeros(B - A, np.int64)
        if A == 0 and B > 0:
            stage_nc[0] = pad
        S = sum(element(r)[2] for r in range(lo, hi))
        stage_b = np.full(max(S - 1, 0), GARBAGE, np.int64)
        st, n = carry[t], 0
        for r in range(lo, hi):
            b = int(br[r])
            el = element(r)
            st = combine(st, el)
            n += el[2]
            if r > 0 and b < br[r - 1]:
                fault |= 1
            # bid counts the segment starts
            if int(bid[r]) != (int(bid[r - 1]) if r else -1) + el[2]:
                fault |= 4
            if r + 1 < nv and br[r + 1] == b:
                continue
            cnt = st[1] + (pad if b == 0 else 0)
            if A <= b < B:
                stage_hb[b - A], stage_nc[b - A] = st[0], cnt
                if 1 <= n <= S - 1:
                    stage_b[n - 1] = st[0]
            elif not 0 <= b < n_pad:
                fault |= 2
            else:
                out.put("hb_at", b, b + 1, st[0])
                out.put("ncls_at", b, b + 1, cnt)
                k = min(max(J0 + n, 0), h_pad - 1)
                out.put("hb_b", k, k + 1, st[0])
        if A < B:
            out.put("hb_at", A, B, stage_hb)
            out.put("ncls_at", A, B, stage_nc)
        k = min(S - 1, h_pad - 1 - J0)
        if k > 0:
            out.put("hb_b", J0 + 1, J0 + 1 + k, stage_b[:k])
    wrap = lambda a: ((a + 2**31) % 2**32 - 2**31).astype(np.int32)
    return ([wrap(out.a[k]) for k in ("hb_at", "ncls_at", "hb_b")],
            [out.n[k] for k in ("hb_at", "ncls_at", "hb_b")], fault)


# ---------------------------------------------------------------------------
# running_fill
# ---------------------------------------------------------------------------

FILL_TILE_BYTES = 32768   # running_fill.cu: TILE_BYTES
FILL_THREADS = 256        # running_fill.cu: THREADS
FILL_TILE = {np.int32: FILL_TILE_BYTES // 4, np.int64: FILL_TILE_BYTES // 8}


def _fill_emulation(v: np.ndarray, op: str, reverse: bool, shift: int,
                    tile: int, seed: int) -> np.ndarray:
    """running_fill by tiles of ``tile`` virtual rows: row r is virtual
    row r + shift (the input's rows before its first 16-byte boundary),
    the virtual rows outside [0, m) read as the identity; in scan order
    (reverse: the last tile first, its rows from the last) each tile
    folds its rows, takes its exclusive prefix from the look-back (a
    window waits only up to its nearest inclusive state) and writes the
    running op of its rows from it."""
    m = len(v)
    info = np.iinfo(v.dtype)
    ident = int(info.min if op == "max" else info.max)
    comb = max if op == "max" else min
    acc = np.maximum.accumulate if op == "max" else np.minimum.accumulate
    tiles = -(-(m + shift) // tile)
    virt = np.full(tiles * tile, ident, v.dtype)
    virt[shift:shift + m] = v
    blocks = virt.reshape(tiles, tile)
    if reverse:
        blocks = blocks[::-1, ::-1]
    aggs = [int(b.max() if op == "max" else b.min()) for b in blocks]
    prefix = _lookback(aggs, comb, ident, seed)
    out = np.empty_like(blocks)
    for t, b in enumerate(blocks):
        out[t] = acc(np.concatenate([np.array([prefix[t]], v.dtype), b]))[1:]
    if reverse:
        out = out[::-1, ::-1]
    return out.reshape(-1)[shift:shift + m]


def _swz(q, nv: int):
    """tile_scan.cuh's swz<NV> (running_fill.cu: NV = 8 at 256 threads;
    run_merge.cu's bucket_sums: NV = 4)."""
    sh = 3 if nv <= 8 else (4 if nv == 16 else 5)
    msk = {1: 0, 2: 1, 4: 3}.get(nv, 7)
    return q ^ ((q >> sh) & msk)


@pytest.mark.parametrize("nv", [1, 2, 4, 8, 16])
def test_fill_swizzle_conflict_free(nv):
    """The shared tile's swizzle: a bijection on each warp's part (32 x nv
    16-byte vectors, so a __syncwarp orders it), and conflict-free — the
    8 lanes of each 128-byte phase hit 8 different 16-byte bank groups —
    both when lane l stores vector i * 32 + l (the warp's coalesced
    loads) and when thread l reads its u-th vector l * nv + u (its
    consecutive rows)."""
    q = np.arange(32 * nv)
    assert sorted(_swz(q, nv).tolist()) == q.tolist()
    for i in range(nv):
        slots = _swz(i * 32 + np.arange(32), nv).reshape(4, 8) % 8
        assert all(len(set(g)) == 8 for g in slots.tolist())
    for u in range(nv):
        slots = _swz(np.arange(32) * nv + u, nv).reshape(4, 8) % 8
        assert all(len(set(g)) == 8 for g in slots.tolist())


def _fill_sizes(tile: int) -> list:
    return [1, 3, 64, tile - 1, tile, tile + 1, 3 * tile + 5]


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("dtype, m", [
    (dt, m) for dt, t in FILL_TILE.items() for m in _fill_sizes(t)],
    ids=[f"{dt.__name__}-{m}" for dt, t in FILL_TILE.items()
         for m in _fill_sizes(t)])
def test_fill_tiles_equal_plain(dtype, m, op, reverse):
    """The fill's tiles, at the kernel's tile and at 64 rows (many
    look-back windows), in every 16-byte frame the input can start in
    (shift 0 .. 16 / itemsize - 1: an offset view's unaligned head and
    tail rows), with the dtype's extremes and FILL_BIG, equal to
    running_fill_reference in every step order."""
    v = _fill_values(m, dtype, m + 7 * reverse + (op == "min"))
    want = running_fill_reference(torch.from_numpy(v), op, reverse).numpy()
    for tile in (FILL_TILE[dtype], 64):
        for shift in range(16 // np.dtype(dtype).itemsize):
            for seed in ORDERS:
                got = _fill_emulation(v, op, reverse, shift, tile, seed)
                np.testing.assert_array_equal(want, got, err_msg=(
                    f"tile {tile} shift {shift} seed {seed}"))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(BUILT_JOINS))
def test_join_tiles_equal_plain(name, tile):
    rows, h_pad = BUILT_JOINS[name]
    cols = [rows[k] for k in ("k1", "k2f", "i", "pay")]
    want = tm._tail_good_join_reference(
        *(torch.from_numpy(np.ascontiguousarray(c)) for c in cols), h_pad)
    for seed in ORDERS:
        got = _join_emulation(*cols, h_pad, tile, seed)
        for k, a, b in zip(("counter", "exact_key", "f_cls"), want[:3],
                           got[:3]):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
        assert (want[3], want[4]) == (got[3], got[4])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(BUILT_LANES))
def test_run_merge_tiles_equal_plain(name, tile):
    lanes = BUILT_LANES[name]
    want = tm._run_merge_reference(*(torch.from_numpy(a) for a in lanes))
    for seed in ORDERS:
        got = _runs_emulation(*lanes, tile, seed)
        assert want[2] == got[2]
        np.testing.assert_array_equal(want[0].numpy(), got[0])
        np.testing.assert_array_equal(want[1].numpy(), got[1])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(BUCKETS))
def test_bucket_sums_tiles_equal_plain(name, tile):
    """On outputs that start as garbage, every slot written exactly once
    and equal to the plain version's."""
    br, bid, m_c, nec, n_pad = BUCKETS[name]
    want = tm._bucket_sums_reference(
        *(torch.from_numpy(a) for a in (br, bid, m_c)), nec, n_pad)
    for seed in ORDERS:
        got, writes, fault = _bucket_emulation(br, bid, m_c, nec, n_pad,
                                               tile, seed)
        for k, a, b, n in zip(("hb_at", "ncls_at", "hb_b"), want[:3], got,
                              writes):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
            assert (n == 1).all(), k
        assert fault == 0 == int(want[3][0])


@pytest.mark.parametrize("tile", [64, BS_TILE])
def test_bucket_sums_tiles_fault(tile):
    """A falling rank (bit 0) and a rank past n_pad or below 0 (bit 1):
    the emulated kernel writes nothing outside its outputs (_Outputs.put
    fails) and sets the fault bits; a falling rank splits its bucket, so
    the bids past it no longer count the segments: bits 0 and 2, as the
    plain version sets them. A bid that is not its bucket's index (bit 2) —
    everywhere, at one lane inside a tile, or at a tile's last lane —
    is flagged by both, and the check refuses it."""
    br, bid, m_c, nec, n_pad = _bucket_lanes([40, 70, 30, 90], 5, 400,
                                             seed=4)
    plain = lambda b, d: int(tm._bucket_sums_reference(
        *(torch.from_numpy(a) for a in (b, d, m_c)), nec, n_pad)[3][0])
    for at, rank, bit in ((60, int(br[0]) - 1, 1), (nec - 1, n_pad + 3, 2),
                          (0, -2, 2)):
        bad = br.copy()
        bad[at] = rank
        _, _, fault = _bucket_emulation(bad, bid, m_c, nec, n_pad, tile, 0)
        assert fault & 3 == bit
        if bit == 1:   # the plain version cannot scatter past n_pad
            assert fault == plain(bad, bid)
    for at in (None, 100, min(tile, nec) - 1):
        bad = bid + 1 if at is None else bid.copy()
        if at is not None:
            bad[at] += 1
        _, _, fault = _bucket_emulation(br, bad, m_c, nec, n_pad, tile, 0)
        assert fault == 4 == plain(br, bad), at
        with pytest.raises(RuntimeError, match="bid is not"):
            tm.bucket_sums_check(torch.tensor([fault], dtype=torch.int32))


def _last_reset(x, y):
    """A non-commutative operator with absorbing states: concatenation,
    restarted after a '|' (a state holding one hides what came before)."""
    z = x + y
    return z[z.rindex("|"):] if "|" in z else z


@pytest.mark.parametrize("window", [1, 4, 32, WINDOW])
@pytest.mark.parametrize("resident", [1, 2, 40, 300])
def test_lookback_waits_and_orders(resident, window):
    """The look-back emulation on non-commutative operators: every tile's
    prefix is the fold of the tiles before it, in every step order, with
    many windows to cross when many tiles are resident and the window is
    small; with absorbing aggregates published at once too."""
    aggs = [chr(65 + t % 26) for t in range(600)]
    for seed in range(3):
        got = _lookback(aggs, lambda x, y: x + y, "", seed, resident,
                        window)
        assert got == ["".join(aggs[:t]) for t in range(600)]
    cut = [("|" if t % 7 == 3 else "") + a for t, a in enumerate(aggs)]
    want = [functools.reduce(_last_reset, cut[:t], "") for t in range(600)]
    for seed in range(3):
        assert _lookback(cut, _last_reset, "", seed, resident, window,
                         absorbs=lambda a: a.startswith("|")) == want
