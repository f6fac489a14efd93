"""radix_sort.cu's tiles, emulated (tests/test_torch_sort.py's
_sort_emulation and _pass_emulation: early counts, one-digit tiles, the
ranks from each warp's starts, the look-back, the next pass's counts
taken as the rows are written), held to the plain version
ops/sort._stable_argsort_reference at every key width from 1 to 63 bits,
alone (the composite plan) and under a 60-bit second key (the per-key
plan once the two pass 72 bits), on every pattern of test_torch_sort's
KINDS and on the skewed layouts of the port's sorts: whole tiles of pads
in a run, one digit in every row of a pass, and the jump scan's
candidates ([lanes, cap] slots, each lane's records rising through its
own span of the text, the slots past its count pads). Tolerance: exact
(integer permutations)."""
from __future__ import annotations

import numpy as np
import pytest

import test_torch_sort as base
from test_torch_sort import (INT_MAX, KERNEL_TILE, KINDS, PAD, TILES, _keys,
                             _sort_emulation, _t)
from cmsbwt_tpu_torch.ops import sort

SWEEP_TILE = (2, 3)          # 192-row tiles: several tiles at a small n
SWEEP_N = 4 * 192 + 37
SKEWED = ["pad_runs", "one_digit", "lane_tails"]


def _skewed(kind: str, n: int, bits: int, dtype, seed: int,
            tile: int) -> np.ndarray:
    """Keys of ``bits`` width in one of the port's skewed layouts: random
    keys with tiles 1 and 2 (of ``tile`` rows) and the tail all pads;
    every row's low byte one value (one digit for the first pass) under
    random high bits; or the jump scan's [lanes, cap] candidate slots."""
    g = np.random.default_rng(seed)
    pad = PAD[dtype]
    top = min((1 << bits) - 1, pad)
    if kind == "pad_runs":
        k = g.integers(0, top, n, dtype=np.int64)
        k[tile:3 * tile] = pad
        k[n - n // 5:] = pad
    elif kind == "one_digit":
        low = int(g.integers(0, min(top, 256)))
        k = g.integers(0, max(top >> 8, 1), n, dtype=np.int64) << 8 | low
        k = np.where(k < top, k, low)
    else:
        lanes = 8
        cap = -(-n // lanes)
        span = max(top // lanes, 1)
        nrec = g.integers(0, max(cap // 4, 1) + 1, lanes)
        t = (np.arange(lanes)[:, None] * span
             + np.cumsum(g.integers(0, max(span // cap, 1) + 1,
                                    (lanes, cap)), 1) // 2)
        t = np.minimum(t, top - 1)
        k = np.where(np.arange(cap)[None, :] < nrec[:, None], t, pad)
        k = k.reshape(-1)[:n]
    return k.astype(dtype)


def _check(keys, bits, tile, seed, one_digit=True):
    want, wvals = sort._stable_argsort_reference([_t(k) for k in keys],
                                                 bits, True)
    got, vals = _sort_emulation(keys, bits, 8, tile, seed,
                                one_digit=one_digit)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(vals, wvals.numpy())


@pytest.mark.parametrize("keys", ["one", "under_60_bits"])
@pytest.mark.parametrize("bits", range(1, 64))
def test_radix_widths_equal_plain(bits, keys):
    """Every width, every pattern: the emulated passes give the plain
    version's permutation and values."""
    dtype = np.int32 if bits <= 31 else np.int64
    tile = SWEEP_TILE[0] * 32 * SWEEP_TILE[1]
    for i, kind in enumerate(KINDS + SKEWED):
        seed = bits * 31 + i
        k = (_keys(kind, SWEEP_N, bits, dtype, seed) if kind in KINDS
             else _skewed(kind, SWEEP_N, bits, dtype, seed, tile))
        if keys == "one":
            _check([k], [bits], SWEEP_TILE, seed)
        else:
            low = _keys("ties", SWEEP_N, 60, np.int64, seed + 1)
            _check([k, low], [bits, 60], SWEEP_TILE, seed)


@pytest.mark.parametrize("one_digit", [True, False])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", SKEWED)
def test_radix_skewed_tiles_equal_plain(kind, tile, one_digit):
    """The skewed layouts at each tile shape, the kernel's among them,
    with and without the one-digit path; and as the first key of the
    join's pair (23 + 47 bits)."""
    rows = base._tile_rows(tile)
    n = 5 * rows + 77 if tile == KERNEL_TILE else 6 * rows + 5
    k = _skewed(kind, n, 29, np.int32, 7, rows)
    _check([k], [29], tile, 3, one_digit)
    k2 = _keys("ties", n, 47, np.int64, 8)
    _check([_skewed(kind, n, 23, np.int32, 9, rows), k2], [23, 47], tile, 4,
           one_digit)


def test_one_digit_tiles_taken():
    """A run of pads makes tiles of one digit in every pass, and the tile
    after the run finds its prefix through them: the emulation takes the
    one-digit path there and, with or without it, gives the plain
    version's order."""
    rows = 32 * 2 * 3
    k = np.full(7 * rows + 3, INT_MAX, np.int32)
    k[:rows] = np.random.default_rng(4).integers(0, 1 << 20, rows)
    k[5 * rows + 7] = 12345
    before = base.ONE_DIGIT_TILES[0]
    _check([k], [31], SWEEP_TILE, 5, True)
    # tiles 1-4 in each of the 4 passes, and tile 6's first rows are pads
    assert base.ONE_DIGIT_TILES[0] - before >= 4 * 4
    before = base.ONE_DIGIT_TILES[0]
    _check([k], [31], SWEEP_TILE, 5, False)
    assert base.ONE_DIGIT_TILES[0] == before
