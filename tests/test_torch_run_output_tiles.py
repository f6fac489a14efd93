"""The tile decomposition of bwt_expand, checked on the CPU without a
card: a numpy emulation of what cmsbwt_tpu_torch/kernels/csrc/
run_output.cu's two kernels compute per tile, held exactly to the plain
version, io/output.bwt_expand_reference (and, on merged lists, to the
JAX package's runs_to_plain), at several output tiles T (the kernel's
16384 among them) and scan tiles (the kernel's 8192 among them).

tile_starts_kernel is one launch of a decoupled look-back over the
lengths (64-bit sums): a scan tile takes its place from a ticket, and
the emulation lets the tiles run their steps in a seeded random order
(test_torch_merge_kernels_tiles._lookback); each run that covers the
first byte b * T of an output tile writes (run, start) into the zeroed
tile starts, one entry for each tile start it covers. bwt_expand_kernel
takes one output tile a block: it reads its own entry and the next
tile's, clamps the runs to [0, R) and the span between to T + 1 runs,
and takes the lengths clamped to [0, T + 1] (the first as its end in
the tile); where that end reaches the tile's end it stores the run's
char; else an inclusive sum of the lengths clamped to T gives each run
its bytes [lo, hi) of the tile: it marks its first byte, and the first
byte of each 16-byte chunk it covers after it, with its char in a shared
array of marks; each thread then makes a 16-byte chunk, each byte taking
the char of the latest mark at or before it in the chunk. Bad input (a short sum, a length of 0) leaves tile starts
unwritten; the emulation asserts that every index stays in its array,
and the fault word equals the plain version's. Change this emulation
with the kernel's design. Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_merge_kernels_tiles import _lookback
from cmsbwt_tpu.engine.merge import runs_to_plain
from cmsbwt_tpu_torch.io import output

SCAN_TILE, EXP_TILE = 8192, 16384      # run_output.cu's tiles
TILES = [16, 64, 1024, EXP_TILE]       # output bytes a block
SCANS = [1, 3, 64, SCAN_TILE]          # runs a scan tile
ORDERS = (0, 1)                        # seeds of the scan tiles' order
LEN_FAULT, SUM_FAULT = 1, 4
CHARS = np.array([2, 65, 67, 71, 84], np.uint8)


def _starts(ln, sn: int, T: int, scan: int, seed: int, shift: int = 0):
    """tile_starts_kernel: the tile starts (int64[tiles, 2], zeroed where
    no run covers the tile's first byte), the fault word and the set of
    tiles written. The scan tiles lie in the lengths' 16-byte frame: the
    first holds scan - shift runs."""
    R = len(ln)
    tiles = -(-sn // T)
    bounds = [0] + list(range(scan - shift, R, scan))
    ends = bounds[1:] + [R]
    aggs = [int(ln[lo:hi].sum()) for lo, hi in zip(bounds, ends)]
    prefix = _lookback(aggs, lambda x, y: x + y, 0, seed)
    starts = np.zeros((tiles, 2), np.int64)
    written = set()
    fault = 0
    # the tiles write in a seeded order: where bad lengths make two runs
    # cover one tile start, either entry may stay
    for t in np.random.default_rng(seed).permutation(len(bounds)):
        lo = bounds[t]
        v = ln[lo:ends[t]].astype(np.int64)
        if (v <= 0).any():
            fault |= LEN_FAULT
        e = prefix[t] + np.cumsum(v)
        s = e - v
        ok = (v > 0) & (e > 0) & (s < sn)
        b_lo = np.where(s <= 0, 0, -(-s // T))
        b_hi = np.minimum((e - 1) // T, tiles - 1)
        for j in np.nonzero(ok & (b_lo <= b_hi))[0]:
            assert 0 <= b_lo[j] and b_hi[j] < tiles
            starts[b_lo[j]:b_hi[j] + 1] = (lo + j, max(int(s[j]), 0))
            written.update(range(int(b_lo[j]), int(b_hi[j]) + 1))
        if ends[t] >= R and prefix[t] + aggs[t] != sn:
            fault |= SUM_FAULT
    return starts, fault, written


def _expand(ln, ch, sn: int, starts, T: int, stats: dict):
    """bwt_expand_kernel over every output tile: the sn bytes, each index
    checked against its array."""
    R = len(ln)
    tiles = len(starts)
    out = np.full(sn, 0xA5, np.uint8)     # torch.empty: not zeroed
    for b in range(tiles):
        base = b * T
        nbytes = min(T, sn - base)
        r0 = min(max(int(starts[b, 0]), 0), R - 1)
        r1 = (min(max(int(starts[b + 1, 0]), r0), R - 1) if b + 1 < tiles
              else R - 1)
        n = min(r1 - r0 + 1, T + 1)
        idx = r0 + np.arange(n)
        assert 0 <= idx[0] and idx[-1] < R
        v = ln[idx].astype(np.int64)
        v[0] += int(starts[b, 1]) - base
        stats["span"] = max(stats.get("span", 0), n)
        if v[0] >= nbytes:               # the tile inside one run
            stats["uniform"] = stats.get("uniform", 0) + 1
            out[base:base + nbytes] = ch[idx[0]]
            continue
        staged = np.clip(v, 0, T + 1)
        assert int(staged.sum()) < 2**31   # the block's int32 sums
        hi = np.minimum(np.cumsum(staged), T)
        lo = np.concatenate([[0], hi[:-1]])
        assert (lo <= hi).all() and hi[-1] <= T
        chars = ch[idx].astype(np.int64)
        # the marks: a run [lo, hi) marks its first byte and the first
        # byte of each 16-byte chunk it covers after it with its char
        chunks = -(-T // 16)
        mark = np.full(16 * chunks, -1, np.int64)
        times = np.zeros(16 * chunks, np.int64)
        for j in np.nonzero(lo < hi)[0]:
            at = np.concatenate([[lo[j]],
                                 np.arange((lo[j] | 15) + 1, hi[j], 16)])
            mark[at] = chars[j]
            times[at] += 1
        assert (times <= 1).all()          # no two runs mark one byte
        # each chunk from its marks: a byte takes the char of the latest
        # mark at or before it in its chunk (none: 0)
        pos = np.where(mark >= 0, np.arange(16 * chunks), -1)
        last = np.maximum.accumulate(pos.reshape(chunks, 16), axis=1).ravel()
        got = np.where(last >= 0, mark[np.maximum(last, 0)], 0)
        if not stats["fault"]:
            assert hi[-1] >= nbytes
            # every chunk's first byte is marked
            assert (mark[0:nbytes:16] >= 0).all()
        stats["marks"] = stats.get("marks", 0) + int(times.sum())
        out[base:base + nbytes] = got[:nbytes]
    return out


def _check(ln, ch, sn: int, T: int, scan: int, seed: int,
           shift: int = 0) -> dict:
    """The emulation against bwt_expand_reference (bytes and fault word);
    returns the emulation's stats with its starts and fault word."""
    ln = np.asarray(ln, np.int64)
    ch = np.asarray(ch, np.uint8)
    starts, fault, written = _starts(ln, sn, T, scan, seed, shift)
    stats = {"starts": starts, "fault": fault, "written": written}
    got = _expand(ln, ch, sn, starts, T, stats)
    want, want_fault = output.bwt_expand_reference(
        torch.from_numpy(ln.astype(np.int32)), torch.from_numpy(ch), sn)
    assert fault == int(want_fault[0])
    if not fault:
        assert got.tobytes() == want.numpy().tobytes()
        assert got.tobytes() == runs_to_plain(ln, ch)
    return stats


def _runs(lengths, seed: int = 0):
    """Chars for the lengths: neighbours different (a merged list)."""
    rng = np.random.default_rng(seed)
    ch = CHARS[np.cumsum(rng.integers(1, len(CHARS), len(lengths)))
               % len(CHARS)]
    return np.asarray(lengths, np.int64), ch


def _random_runs(R: int, seed: int, hi: int = 13):
    rng = np.random.default_rng(seed)
    return _runs(rng.integers(1, hi, R), seed)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("T", TILES)
def test_random_runs(T, scan, order, shift):
    """Merged lists of 1-12 byte runs (~1.4 runs a 16-byte chunk), the
    last tile partial, the lengths at a 16-byte boundary or 3 runs past
    one: exact, and every tile start written with the run that covers
    it."""
    ln, ch = _random_runs(5000 + T // 16, 7 + order)
    sn = int(ln.sum())
    st = _check(ln, ch, sn, T, scan, order, min(shift, scan - 1))
    ends = np.cumsum(ln)
    tile0 = T * np.arange(-(-sn // T))
    r = np.searchsorted(ends, tile0, "right")
    assert np.array_equal(st["starts"][:, 0], r)
    assert np.array_equal(st["starts"][:, 1], ends[r] - ln[r])
    assert len(st["written"]) == len(tile0)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("T", TILES)
def test_mixed_runs(T, order):
    """Short runs among long ones (20-100 and 300-3000 bytes, as copies of
    one genome give): a long run marks each chunk start it covers;
    exact."""
    rng = np.random.default_rng(20 + order)
    R = 4000
    kind = rng.choice(3, R, p=[0.7, 0.2, 0.1])
    ln = np.where(kind == 0, rng.integers(1, 13, R),
                  np.where(kind == 1, rng.integers(20, 101, R),
                           rng.integers(300, 3001, R)))
    ln, ch = _runs(ln, order)
    st = _check(ln, ch, int(ln.sum()), T, SCAN_TILE, order)
    # more marks than runs: the chunk starts inside runs
    assert st["marks"] > R or T == 16


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("T", TILES)
def test_run_over_many_tiles(T, order):
    """A run covering several tile starts writes one entry for each, and
    the tiles inside it store its char with no scan."""
    lengths = [5, 3, 5 * T + 3, 2, 7, 4 * T, 1, 3]
    ln, ch = _runs(lengths, order)
    sn = int(ln.sum())
    st = _check(ln, ch, sn, T, 3, order)
    s2 = int(ln[:2].sum())
    covered = [b for b in range(-(-sn // T)) if s2 <= b * T < s2 + ln[2]]
    assert len(covered) >= 5
    for b in covered:
        assert tuple(st["starts"][b]) == (2, s2)
    assert st["uniform"] >= 7


@pytest.mark.parametrize("T", TILES)
def test_tile_of_one_byte_runs(T):
    """Tiles of T one-byte runs: the span reaches T + 1 runs (a block's
    worst case: T + 1 lengths read and summed in 32 bits)."""
    ln, ch = _runs([3] + [1] * (2 * T) + [5], 3)
    st = _check(ln, ch, int(ln.sum()), T, SCAN_TILE, 0)
    assert st["span"] == T + 1


@pytest.mark.parametrize("T", TILES)
def test_runs_cross_every_tile_start(T):
    """Runs that start before their tile: every tile's first run began in
    the tile before, and the last tile is partial."""
    ln, ch = _runs([T // 2] + [T] * 6 + [T // 2 + 5], 5)
    sn = int(ln.sum())
    st = _check(ln, ch, sn, T, 1, 1)
    starts = st["starts"]
    tile0 = T * np.arange(len(starts))
    assert (starts[1:, 1] < tile0[1:]).all()
    assert sn % T


@pytest.mark.parametrize("scan", [1, SCAN_TILE])
@pytest.mark.parametrize("T", TILES)
@pytest.mark.parametrize("sn_of", ["1", "T-1", "T", "T+1", "3T"])
def test_sizes_at_the_tile(sn_of, T, scan):
    """sn of 1, T - 1, T, T + 1 in runs of 1-12 bytes, and 3T in one-byte
    runs."""
    if sn_of == "3T":
        ln, ch = _runs([1] * (3 * T), 2)
    else:
        sn = {"1": 1, "T-1": T - 1, "T": T, "T+1": T + 1}[sn_of]
        ln, ch = _random_runs(sn, sn)
        ln = ln[np.cumsum(ln) < sn]
        ln = np.append(ln, sn - int(ln.sum()))
        ch = ch[:len(ln)]
    _check(ln, ch, int(ln.sum()), T, scan, 0)


@pytest.mark.parametrize("T", TILES)
def test_one_run(T):
    """R = 1: every tile inside the one run."""
    sn = 3 * T + 7
    st = _check([sn], [65], sn, T, SCAN_TILE, 0)
    assert st["uniform"] == -(-sn // T)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("T", TILES)
@pytest.mark.parametrize("fault", ["sum_short", "sum_long", "zero_length",
                                   "negative_length", "short_by_tiles"])
def test_bad_input_stays_in_bounds(fault, T, order):
    """Lengths that do not sum to sn, a length of 0 or below: the fault
    word equals the plain version's, tile starts stay unwritten, and no
    index leaves its array (asserted inside the emulation)."""
    ln, ch = _random_runs(3 * T // 4 + 500, 11 + order)
    sn = int(ln.sum())
    if fault == "sum_short":
        sn += 1
    elif fault == "sum_long":
        sn -= 1
    elif fault == "zero_length":
        ln[len(ln) // 3] = 0
    elif fault == "negative_length":
        ln[len(ln) // 2] = -5 * T
    else:
        sn += 3 * T + 5
    st = _check(ln, ch, sn, T, 64, order)
    assert st["fault"]
    if fault in ("short_by_tiles", "negative_length"):
        assert len(st["written"]) < len(st["starts"])
