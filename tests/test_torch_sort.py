"""The port's stable sorts (cmsbwt_tpu_torch/ops/sort.py) on the CPU, held
to the JAX package's ``jax.lax.sort``: ``stable_argsort`` by one to four
keys of stated widths (ties, all-equal keys, descending keys, pads only,
widths 1, 8, 23, 31, 48 and 63 bits, lengths around 3072- and 4096-row
edges) against ``lax.sort(..., num_keys=k)``, and ``compact`` against
``lax.sort`` of ``where(flag, idx, INT_MAX)``; the fault word on a key
over its width and on a wrong count of set flags.

Then a numpy emulation of what kernels/csrc/radix_sort.cu and compact.cu
compute per tile, held to the plain versions at several tile sizes, the
kernels' among them: radix_pass's tiles count their digits per warp
(early counts), keep their rows in place when one digit holds the whole
tile, else rank each round's lanes among the equal digits of the warp
(as the kernel's ballots group them) from the warp's start per digit,
take each digit's prefix from a look-back over the tiles before them (4
tiles a read, as the kernel's LB_BATCH), the tiles running their steps in a seeded random order,
and count the next pass's digits as they write (held equal to that
pass's digits); compact's tiles scan their set counts with a look-back of
32 tiles a step and stage set rows before unset ones. Change the
emulation with the kernels' design (tests/test_torch_sort_tiles.py runs
it at every width). Tolerance: exact (integer permutations)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_merge_kernels_tiles import _lookback
from cmsbwt_tpu_torch import kernels
from cmsbwt_tpu_torch.ops import sort

INT_MAX = 2**31 - 1
I64_BIG = 1 << 62
PAD = {np.int32: INT_MAX, np.int64: I64_BIG}
# radix_sort.cu's blocks, (warps, rows a lane): a pass staging u64 words,
# and one staging u32 words; both tiles of 6144 rows
KERNEL_TILE = ((16, 12), (8, 24))
TILES = [(1, 1), (2, 3), KERNEL_TILE]
COMPACT_TILES = [(64, 1), (256, 16)]   # compact.cu: 256 threads x 16 rows
KERNEL_LB_BATCH = 4    # radix_sort.cu: tiles' words a look-back reads at once


@pytest.fixture(autouse=True)
def _clean_faults():
    sort.fault_word("cpu").zero_()
    yield
    sort.fault_word("cpu").zero_()


def _keys(kind: str, n: int, bits: int, dtype, seed: int) -> np.ndarray:
    """Keys of ``bits`` width (values in [0, min(2^bits - 1, pad)) or
    the dtype's pad) of one pattern."""
    g = np.random.default_rng(seed)
    pad = PAD[dtype]
    top = min((1 << bits) - 1, pad)      # keys lie below it
    if kind == "random":
        k = g.integers(0, top, n, dtype=np.int64)
    elif kind == "ties":
        k = g.choice(g.integers(0, top, 5, dtype=np.int64), n)
    elif kind == "equal":
        k = np.full(n, g.integers(0, top), np.int64)
    elif kind == "descending":
        k = np.sort(g.integers(0, top, n, dtype=np.int64))[::-1].copy()
    elif kind == "pads":
        k = np.full(n, pad, np.int64)
    elif kind == "top":                  # the widest key and pads
        k = np.where(g.random(n) < 0.5, top - 1, pad)
    else:                                # random with a fifth pads
        k = np.where(g.random(n) < 0.2, pad,
                     g.integers(0, top, n, dtype=np.int64))
    return k.astype(dtype)


def _jax_perm(keys) -> np.ndarray:
    """The permutation of a stable jax.lax.sort by ``keys`` (most
    significant first)."""
    n = len(keys[0])
    with jax.enable_x64(True):
        ops = [jnp.asarray(k) for k in keys] + [jnp.arange(n,
                                                           dtype=jnp.int32)]
        out = jax.lax.sort(tuple(ops), num_keys=len(keys), is_stable=True)
        return np.asarray(out[-1])


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


WIDTHS = [(1, np.int32), (8, np.int32), (23, np.int32), (31, np.int32),
          (48, np.int64), (63, np.int64), (23, np.int64)]
KINDS = ["random", "ties", "equal", "descending", "pads", "top", "mixed"]
LENGTHS = [1, 3071, 3073, 4097, 3 * 4096 + 5]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits,dtype", WIDTHS)
def test_one_key_matches_jax(bits, dtype, kind, n):
    k = _keys(kind, n, bits, dtype, seed=bits * 7 + n)
    perm, vals = sort.stable_argsort((_t(k),), (bits,), values=True)
    assert perm.dtype == torch.int32
    want = _jax_perm([k])
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), k[want])
    sort.check_faults("cpu")


MULTI = {
    "join": [(23, np.int32, "mixed"), (48, np.int64, "ties")],
    "group": [(23, np.int32, "ties"), (53, np.int64, "ties")],
    "three": [(8, np.int32, "ties"), (1, np.int32, "mixed"),
              (31, np.int32, "ties")],
    "four": [(2, np.int32, "random"), (63, np.int64, "ties"),
             (9, np.int32, "descending"), (23, np.int64, "mixed")],
    "equal_then_desc": [(16, np.int32, "equal"), (20, np.int32,
                                                  "descending")],
    "pads_only": [(23, np.int32, "pads"), (48, np.int64, "pads")],
}


@pytest.mark.parametrize("n", [1000, 3 * 4096 + 5])
@pytest.mark.parametrize("case", sorted(MULTI))
def test_keys_match_jax(case, n):
    spec = MULTI[case]
    keys = [_keys(kind, n, b, dt, seed=i + n)
            for i, (b, dt, kind) in enumerate(spec)]
    bits = [b for b, _, _ in spec]
    perm, vals = sort.stable_argsort([_t(k) for k in keys], bits,
                                     values=True)
    want = _jax_perm(keys)
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), keys[0][want])
    assert torch.equal(sort.stable_argsort([_t(k) for k in keys], bits),
                       perm)
    sort.check_faults("cpu")


@pytest.mark.parametrize("n", [1, 5, 4096, 4097, 3 * 4096 + 5])
@pytest.mark.parametrize("share", [0.0, 0.03, 0.5, 1.0])
def test_compact_matches_jax(share, n):
    flag = np.random.default_rng(n).random(n) < share
    idx = np.arange(n, dtype=np.int32)
    want = _jax_perm([np.where(flag, idx, INT_MAX).astype(np.int32)])
    got = sort.compact(_t(flag), int(flag.sum()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    sort.check_faults("cpu")


def test_key_bits():
    assert [sort.key_bits(b) for b in (0, 1, 2, 3, 255, 256, INT_MAX)] \
        == [1, 1, 2, 2, 8, 9, 31]
    # every key below the bound lies below the pad's all-ones pattern
    for bound in (1, 2, 7, 8, 1000, 1 << 40):
        assert bound - 1 < (1 << sort.key_bits(bound)) - 1


@pytest.mark.parametrize("bits,dtype,bad", [
    (8, np.int32, 255),          # 2^bits - 1: the pad's pattern
    (8, np.int32, 1000),
    (8, np.int32, -1),
    (31, np.int32, -5),
    (48, np.int64, 1 << 48),
    (63, np.int64, I64_BIG + 1),  # above the pad
])
def test_fault_on_a_key_over_its_width(bits, dtype, bad):
    """A key outside [0, min(2^bits - 1, pad)) that is not its pad sets
    its key's bit in the plain version's fault word, and check_faults
    raises and clears it."""
    k = _keys("mixed", 5000, bits, dtype, seed=1)
    k[1234] = bad
    other = _keys("ties", 5000, 23, np.int32, seed=2)
    keys = (_t(other), _t(k))
    assert int(sort.width_faults(keys, (23, bits))[0]) == 2
    sort.stable_argsort(keys, (23, bits))
    assert int(sort.fault_word("cpu")[0]) == 2
    with pytest.raises(RuntimeError, match=r"key \[1\]"):
        sort.check_faults("cpu")
    assert int(sort.fault_word("cpu")[0]) == 0
    sort.check_faults("cpu")
    # alone it is key 0 (bit 0); within its width it sets no bit
    sort.stable_argsort((_t(k),), (bits,))
    assert int(sort.fault_word("cpu")[0]) == 1
    sort.fault_word("cpu").zero_()
    k[1234] = 0
    sort.stable_argsort((_t(k),), (bits,))
    sort.stable_argsort((_t(other), _t(k)), (23, bits))
    assert int(sort.fault_word("cpu")[0]) == 0


def test_compact_wrong_count_faults():
    flag = _t(np.random.default_rng(0).random(999) < 0.3)
    sort.compact(flag, int(flag.sum()) + 1)
    assert int(sort.fault_word("cpu")[0]) == sort.COUNT_FAULT
    with pytest.raises(RuntimeError, match="count of set flags"):
        sort.check_faults("cpu")
    with pytest.raises(ValueError):
        sort.compact(flag, 1000)


def test_plain_versions_on_the_cpu():
    """CPU tensors go to the plain versions and launch no kernel; bad
    arguments raise before either runs."""
    kernels.reset_launch_counts()
    calls = dict(sort.REFERENCE_CALLS)
    k = _t(np.arange(10, dtype=np.int32)[::-1].copy())
    assert sort.stable_argsort((k,), (4,)).tolist() == list(range(9, -1, -1))
    sort.compact(k > 4, 5)
    assert sort.REFERENCE_CALLS["_stable_argsort_reference"] \
        == calls["_stable_argsort_reference"] + 1
    assert sort.REFERENCE_CALLS["_compact_reference"] \
        == calls["_compact_reference"] + 1
    assert not any(kernels.LAUNCHES.values())
    for keys, bits in (((k,), (32,)), ((k,), (0,)), ((k, k), (4,)),
                       ((k.to(torch.int16),), (4,)),
                       ((k,) * 5, (4,) * 5), ((k, k[:3]), (4, 4))):
        with pytest.raises(ValueError):
            sort.stable_argsort(keys, bits)
    with pytest.raises(ValueError, match="unsupported device"):
        sort.stable_argsort((k.to("meta"),), (4,))
    with pytest.raises(ValueError):
        sort.compact(k, 3)


# ---------------------------------------------------------------------------
# the kernels' tiles, emulated
# ---------------------------------------------------------------------------

def _words(k: np.ndarray, bits: int) -> np.ndarray:
    """radix_sort.cu's words of a key: the pad to all ones."""
    pad = PAD[k.dtype.type]
    w = k.astype(np.int64).astype(np.uint64)
    w[k == pad] = (1 << bits) - 1
    return w


# tiles the emulation took through the one-digit path
ONE_DIGIT_TILES = [0]


def _count_round(ctr: np.ndarray, d: np.ndarray, valid: np.ndarray) -> None:
    """radix_sort.cu's count_add for one warp round: one add a valid
    lane."""
    np.add.at(ctr, d[valid], 1)


def _pass_emulation(digits: np.ndarray, warps: int, items: int,
                    bins: int, seed: int, next_digits=None,
                    one_digit: bool = True) -> tuple:
    """Where one radix_pass puts each row, and the next pass's counts it
    takes: tiles of warps * 32 * items rows; warp w's rows are w * 32 *
    items + i * 32 + l (round i, lane l). Early counts: each round adds to
    the warp's counters (_count_round), which give the tile's counts and
    each warp's start per digit (the digit's start in the tile plus the
    warps' counts before it). A tile where one digit holds every row keeps
    its rows in place; any other ranks each round's lanes among the equal
    digits of its warp's rounds so far from those starts and stages the
    source row of each rank. The look-back (KERNEL_LB_BATCH tiles a read,
    tiles in a seeded random order) gives each digit's rows in the tiles
    before; staged slot s of digit d goes to the pass's digit start + that
    prefix + s - the digit's start in the tile. The write-out's rounds (warp w,
    round i: slots i * 32 * warps + w * 32 + l) count the next pass's
    digit of each row they write (``next_digits``, by input row).
    Returns (the destination of every row, the next counts)."""
    n = len(digits)
    threads = warps * 32
    tile = threads * items
    lane = np.arange(32)
    counts, tiles = [], []
    for t0 in range(0, n, tile):
        d = digits[t0:t0 + tile]
        cnt = len(d)
        wh = np.zeros((warps, bins), np.int64)
        for w in range(warps):
            for i in range(items):
                r = w * 32 * items + i * 32 + lane
                _count_round(wh[w], d[np.minimum(r, cnt - 1)], r < cnt)
        tc = wh.sum(0)
        dstart = np.cumsum(tc) - tc
        wofs = dstart + np.cumsum(wh, 0) - wh
        if one_digit and (tc == cnt).any():
            ONE_DIGIT_TILES[0] += 1
            sidx = np.arange(cnt)
        else:
            sidx = np.full(cnt, -1, np.int64)
            for w in range(warps):
                for i in range(items):
                    r = w * 32 * items + i * 32 + lane
                    r = r[r < cnt]
                    dd = d[r]
                    same = dd[None, :] == dd[:, None]
                    pos = wofs[w, dd] + np.tril(same, -1).sum(1)
                    np.add.at(wofs[w], dd, 1)
                    sidx[pos] = r
            assert (sidx >= 0).all()
        counts.append(tc)
        tiles.append((t0, cnt, dstart, sidx))
    prefix = _lookback(counts, lambda x, y: x + y, np.zeros(bins, np.int64),
                       seed, window=KERNEL_LB_BATCH)
    hist = np.bincount(digits, minlength=bins)
    gex = np.cumsum(hist) - hist
    dest = np.empty(n, np.int64)
    nhist = np.zeros(bins, np.int64)
    for t, (t0, cnt, dstart, sidx) in enumerate(tiles):
        gofs = gex + prefix[t] - dstart
        dest[t0 + sidx] = gofs[digits[t0 + sidx]] + np.arange(cnt)
        if next_digits is None:
            continue
        for i in range(items):
            for w in range(warps):
                sl = i * threads + w * 32 + lane
                _count_round(nhist,
                             next_digits[t0 + sidx[np.minimum(sl, cnt - 1)]],
                             sl < cnt)
    assert np.array_equal(np.sort(dest), np.arange(n))
    return dest, nhist


def _shape(tile, ps) -> tuple:
    """The (warps, items) of pass ``ps``: ``tile`` itself, or of the
    kernel's pair the u64-staging shape or the u32-staging one."""
    if isinstance(tile[0], tuple):
        return tile[0] if ps.stage_wide else tile[1]
    return tile


def _tile_rows(tile) -> int:
    warps, items = tile[0] if isinstance(tile[0], tuple) else tile
    return warps * 32 * items


def _sort_emulation(keys, bits, rb: int, tile, seed: int,
                    values: bool = True, one_digit: bool = True) -> tuple:
    """The permutation and first key's values radix_sort.cu's passes give, as
    kernels.radix_plan lays them out: the first pass reading the keys in
    place (composed when the plan is composite), each pass taking its
    digit at dshift of its input and staging the input >> drop (cut to
    32 or 64 bits, as the kernel's word type cuts it), its rows placed
    by _pass_emulation (in ``tile``'s block shape: (warps, items), or
    KERNEL_TILE's by the staged word's width) with the digit counts
    radix_hist takes from the keys themselves (the first pass) or the
    pass before counted as it wrote (each later pass: held equal to the
    digits' counts), and writing the staged words, or the next key's
    words gathered through its rows, or the first key's values (all ones
    -> the pad)."""
    n = len(keys[0])
    plan = kernels.radix_plan(bits, rb, values)
    words = [_words(k, b).astype(object) for k, b in zip(keys, bits)]
    comp = sum(w << off for w, off in zip(words, kernels.radix_offsets(bits)))
    mask = (1 << rb) - 1
    rows = cur = vals = counted = None
    for at, ps in enumerate(plan):
        rows_in = np.arange(n) if rows is None else rows
        v = sum(words[q] << off for q, off in zip(ps.keys, ps.offs)) \
            if ps.keys else cur
        digits = ((v >> ps.dshift) & mask).astype(np.int64)
        want = np.bincount(digits, minlength=mask + 1)
        if at == 0:
            hsrc = comp if ps.hist_src < 0 else words[ps.hist_src]
            hist = ((hsrc >> ps.hist_shift) & mask).astype(np.int64)
            counted = np.bincount(hist, minlength=mask + 1)
        assert np.array_equal(counted, want)
        staged = (v >> ps.drop) & ((1 << (64 if ps.stage_wide else 32)) - 1)
        written = staged if ps.write else (
            words[ps.next][rows_in] if ps.next is not None else None)
        nxt = None
        if at + 1 < len(plan):
            nxt = ((written >> plan[at + 1].dshift) & mask).astype(np.int64)
        dest, counted = _pass_emulation(digits, *_shape(tile, ps), 1 << rb,
                                        seed + at, nxt, one_digit)
        rows = np.empty(n, np.int64)
        rows[dest] = rows_in
        if written is not None:
            cur = np.empty(n, object)
            cur[dest] = written
        if ps.vals:
            vals = np.empty(n, np.int64)
            pad = PAD[keys[0].dtype.type]
            vals[dest] = np.where(staged == (1 << bits[0]) - 1, pad,
                                  staged).astype(np.int64)
    return rows, vals


@pytest.mark.parametrize("rb", [8, 11])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", ["join", "group", "three", "four",
                                  "pads_only"])
def test_radix_tiles_equal_plain(case, tile, rb):
    n = 2 * _tile_rows(tile) + 77 if tile == KERNEL_TILE else 1500
    spec = MULTI[case]
    keys = [_keys(kind, n, b, dt, seed=i + 3 * n)
            for i, (b, dt, kind) in enumerate(spec)]
    bits = [b for b, _, _ in spec]
    want, wvals = sort._stable_argsort_reference([_t(k) for k in keys],
                                                 bits, True)
    for seed in (0, 1):
        got, vals = _sort_emulation(keys, bits, rb, tile, seed)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(vals, wvals.numpy())
    got, _ = _sort_emulation(keys, bits, rb, tile, 2, values=False)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", ["ties", "descending", "equal", "top"])
def test_radix_one_key_tiles_equal_plain(kind, tile):
    n = _tile_rows(tile) + 3071 if tile == KERNEL_TILE else 1333
    k = _keys(kind, n, 31, np.int32, seed=5)
    want = sort._stable_argsort_reference((_t(k),), (31,))
    got, vals = _sort_emulation([k], [31], 8, tile, 3)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(vals, k[want.numpy()])


def test_radix_plan():
    """The composite plan where the keys less the first digit fit 64 bits:
    ceil(B / radix bits) passes, the first reading every key in place,
    the words dropping consumed bits (the first key kept whole for its
    values) and turning u32 once they fit; else key by key, the last key
    first, a key's last pass writing the next key's words."""
    join = kernels.radix_plan((23, 47), 8, True)
    assert len(join) == 9 and join[0].keys == (0, 1) \
        and join[0].offs == (47, 0)
    assert all(not ps.keys and ps.next is None for ps in join[1:])
    assert [ps.stage_wide for ps in join] == [True] * 4 + [False] * 5
    assert join[5].drop == 7 and join[-1].dshift == 17 and join[-1].vals
    assert [ps.hist_shift for ps in join] == list(range(0, 72, 8))
    wide = kernels.radix_plan((23, 53), 8, True)    # 76 bits: per key
    assert [(ps.hist_src, ps.hist_shift) for ps in wide] == \
        [(1, p * 8) for p in range(7)] + [(0, p * 8) for p in range(3)]
    assert wide[6].next == 0 and not wide[6].write and wide[-1].vals
    assert kernels.radix_plan((1, 11, 12), 11) == kernels.radix_plan(
        (1, 11, 12), 11, False)
    assert len(kernels.radix_plan((1, 11, 12), 11)) == 3


def _compact_emulation(flag: np.ndarray, count: int, threads: int,
                       items: int, seed: int):
    """compact.cu's placement: tiles of threads * items rows, each
    thread's items consecutive; a block scan of the threads' set counts,
    the tile's prefix by look-back (32 tiles a step, tiles in a seeded
    random order); set rows staged first, then unset ones, and written
    to prefix + j and count + (unset rows before) — a write past n
    dropped and flagged, and the last tile's total checked against
    ``count``. Returns (rows with -1 where none was written, fault)."""
    n = len(flag)
    tile = threads * items
    aggs = [int(flag[t:t + tile].sum()) for t in range(0, n, tile)]
    prefix = _lookback(aggs, lambda x, y: x + y, 0, seed)
    out = np.full(n, -1, np.int64)
    fault = False
    for t, r0 in enumerate(range(0, n, tile)):
        f = flag[r0:r0 + tile]
        cnt = len(f)
        per = np.add.reduceat(f.astype(np.int64), np.arange(0, cnt, items))
        ex = np.cumsum(per) - per
        C = int(per.sum())
        staged = np.empty(cnt, np.int64)
        for th in range(len(per)):
            first = th * items
            s, u = ex[th], C + first - ex[th]
            for i in range(first, min(first + items, cnt)):
                if f[i]:
                    staged[s] = r0 + i
                    s += 1
                else:
                    staged[u] = r0 + i
                    u += 1
        j = np.arange(cnt)
        pos = np.where(j < C, prefix[t] + j, count + r0 - prefix[t] - C + j)
        ok = pos < n
        fault |= not ok.all()
        out[pos[ok]] = staged[ok]
        if r0 + cnt == n:
            fault |= prefix[t] + C != count
    return out, fault


@pytest.mark.parametrize("tile", COMPACT_TILES)
@pytest.mark.parametrize("share", [0.0, 0.1, 0.9, 1.0])
def test_compact_tiles_equal_plain(share, tile):
    n = 3 * 4096 + 5
    flag = np.random.default_rng(7).random(n) < share
    want = sort._compact_reference(_t(flag), int(flag.sum())).numpy()
    for seed in (0, 1):
        got, fault = _compact_emulation(flag, int(flag.sum()), *tile, seed)
        assert not fault
        np.testing.assert_array_equal(got, want)
    sort.check_faults("cpu")


@pytest.mark.parametrize("delta", [-1, 1])
def test_compact_tiles_fault_on_a_wrong_count(delta):
    """A count off by one: the last tile's total (and, over it, a write
    past n) gives the fault, never a write out of bounds."""
    n = 2 * 4096 + 9
    flag = np.random.default_rng(8).random(n) < 0.4
    _, fault = _compact_emulation(flag, int(flag.sum()) + delta, 256, 16, 0)
    assert fault
