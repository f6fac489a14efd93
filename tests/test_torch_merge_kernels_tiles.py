"""The tile decomposition of the device merge's fused kernels, checked on
the CPU without a card: a numpy emulation of what
cmsbwt_tpu_torch/kernels/csrc/tail_good_join.cu and run_merge.cu compute
per tile (the reduce launch's tile aggregates, the carry launch's
exclusive carries, the emit launch's scan from its carry, and for the
join the forward segmented credit inside a tile with the tile's trailing
good rows credited to the first target after it) held to the plain
versions, _tail_good_join_reference and _run_merge_reference, at several
tile sizes, 2048 rows (the kernels') among them. Inside a tile the
kernels scan with warp shuffles; the scan's operator is associative, so a
fold in row order gives the same states. Change this emulation with the
kernels' design. Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_merge_kernels import BUILT_JOINS, BUILT_LANES
from cmsbwt_tpu_torch.engine import device_merge as tm

INT_MAX = 2**31 - 1
NONE = INT_MAX
TILES = [1, 3, 8, 64, 2048]


def _join_emulation(k1, k2f, i_s, pay, h_pad: int, tile: int):
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
    carry, run = [None] * len(bounds), ident         # carry (backward)
    for t in range(len(bounds) - 1, -1, -1):
        carry[t] = run
        run = combine(run, agg[t])
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


def _runs_emulation(k_s, len_s, chr_s, tile: int):
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
    carry, run = [], (0, 0, 0)
    for a in agg:
        carry.append(run)
        run = combine(run, a)
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


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(BUILT_JOINS))
def test_join_tiles_equal_plain(name, tile):
    rows, h_pad = BUILT_JOINS[name]
    cols = [rows[k] for k in ("k1", "k2f", "i", "pay")]
    want = tm._tail_good_join_reference(
        *(torch.from_numpy(np.ascontiguousarray(c)) for c in cols), h_pad)
    got = _join_emulation(*cols, h_pad, tile)
    for k, a, b in zip(("counter", "exact_key", "f_cls"), want[:3], got[:3]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    assert (want[3], want[4]) == (got[3], got[4])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(BUILT_LANES))
def test_run_merge_tiles_equal_plain(name, tile):
    lanes = BUILT_LANES[name]
    want = tm._run_merge_reference(*(torch.from_numpy(a) for a in lanes))
    got = _runs_emulation(*lanes, tile)
    assert want[2] == got[2]
    np.testing.assert_array_equal(want[0].numpy(), got[0])
    np.testing.assert_array_equal(want[1].numpy(), got[1])
