"""The tile decomposition of the device merge's single-pass kernels,
checked on the CPU without a card: a numpy emulation of what
cmsbwt_tpu_torch/kernels/csrc/tail_good_join.cu and run_merge.cu
(bucket_sums and run_merge) compute per tile, held to the plain
versions, _tail_good_join_reference, _bucket_sums_reference and
_run_merge_reference, at several tile sizes, 2048, 4096 and 8192 rows
(the kernels') among them. Each kernel is one launch of tile_scan.cuh's
decoupled look-back: a tile takes its place in scan order from a ticket,
publishes its aggregate, looks back over the tiles before it 32 flags at
a time (folding aggregates until it meets a published inclusive state,
waiting while a flag is still empty), publishes its inclusive state and
scans its rows from the exclusive prefix. A tile whose aggregate absorbs
every state before it (the join: a target and a run end; the bucket
sums: a segment start) publishes its inclusive state at once, and a join
tile whose 64-row halo after it holds a target and a run end (or the
last row) takes its prefix from the halo and does not look back. The
emulation lets the tiles run their steps in a seeded random order, and
the result must not depend on it. For the join, the forward segmented
credit inside a tile and the tile's trailing good rows credited to the
first target after it; for the bucket sums, each segment's last lane
storing its sums. Inside a tile the kernels scan with warp shuffles; the
scan's operator is associative, so a fold in row order gives the same
states. Change this emulation with the kernels' design. Tolerance:
exact."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from test_torch_merge_kernels import BUILT_BUCKETS, BUILT_JOINS, \
    BUILT_LANES
from cmsbwt_tpu_torch.engine import device_merge as tm

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
    flags at a time — waiting while any of them is EMPTY, folding aggregates up
    to the nearest published inclusive state — then publishes its
    inclusive state (flag INCL) and leaves. Tile 0, and a tile whose
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
            if any(flag[q] == EMPTY for q in seen):
                run = None                  # spin: another tile goes first
                break
            stop = next((i for i, q in enumerate(seen)
                         if flag[q] == INCL), None)
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


def _bucket_emulation(br, bid, m_c, nec: int, n_pad: int, tile: int,
                      seed: int):
    """bucket_sums by tiles over the nec valid lanes (one tile when there
    are none): the forward segmented (sum, count) state, reset where the
    rank changes; a segment's last lane stores its sums at its rank and
    at its bid; index 0 gets the pad lanes' count, from that segment when
    the first lane has rank 0, else from tile 0 alone."""
    h_pad = len(br)
    pad = h_pad - max(nec, 0)
    L = max(nec, 0)

    def element(r):
        start = r == 0 or br[r - 1] != br[r]
        return (int(m_c[r]), 1, int(start))

    def combine(x, y):
        return ((y[0] if y[2] else x[0] + y[0]) & 0xFFFFFFFF,
                y[1] if y[2] else x[1] + y[1], x[2] | y[2])

    ident = (0, 0, 0)
    bounds = [(lo, min(L, lo + tile)) for lo in range(0, max(L, 1), tile)]
    agg = []
    for lo, hi in bounds:
        acc = ident
        for r in range(lo, hi):
            acc = combine(acc, element(r))
        agg.append(acc)
    # a tile where a segment starts hides every lane before it
    carry = _lookback(agg, combine, ident, seed, absorbs=lambda a: a[2])
    hb_at = np.zeros(n_pad, np.int64)
    ncls_at = np.zeros(n_pad, np.int64)
    hb_b = np.zeros(h_pad, np.int64)
    for t, (lo, hi) in enumerate(bounds):
        st = carry[t]
        for r in range(lo, hi):
            st = combine(st, element(r))
            if r + 1 == L or br[r + 1] != br[r]:
                b = int(br[r])
                hb_at[b] = st[0]
                ncls_at[b] = st[1] + (pad if b == 0 else 0)
                hb_b[min(max(int(bid[r]), 0), h_pad - 1)] = st[0]
        if t == 0 and (L == 0 or br[0] != 0):
            ncls_at[0] = pad
    wrap = lambda a: ((a + 2**31) % 2**32 - 2**31).astype(np.int32)
    return wrap(hb_at), wrap(ncls_at), wrap(hb_b)


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
@pytest.mark.parametrize("name", list(BUILT_BUCKETS))
def test_bucket_sums_tiles_equal_plain(name, tile):
    br, bid, m_c, nec, n_pad = BUILT_BUCKETS[name]
    want = tm._bucket_sums_reference(
        *(torch.from_numpy(a) for a in (br, bid, m_c)), nec, n_pad)
    for seed in ORDERS:
        got = _bucket_emulation(br, bid, m_c, nec, n_pad, tile, seed)
        for k, a, b in zip(("hb_at", "ncls_at", "hb_b"), want[:3], got):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


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
