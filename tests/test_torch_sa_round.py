"""The joint suffix sort's kernels' contracts on the CPU
(cmsbwt_tpu_torch/ops/joint_sa.py): joint_suffix_array against the JAX
package's on joint strings built here (m at the key-width edges, an
all-identical string, one resolved at the seed, pads inside the string so
that seed packs have their top bit set), the seed packs' split into two
32-bit keys against the signed ``p ^ SIGN`` sort, the rank step
``_round_ranks_reference`` against the inline torch sequence it replaced,
a rank outside its stated width raising through ops/sort.check_faults,
and the dispatch of ``round_ranks`` by device. Inputs are made with numpy
from seeds. Tolerance: exact (values, shapes and dtypes)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmsbwt_tpu.ops import joint_sa as JJ
from cmsbwt_tpu_torch import kernels
from cmsbwt_tpu_torch.ops import joint_sa as TJ
from cmsbwt_tpu_torch.ops import sort as S
from cmsbwt_tpu_torch.ops.fill import running_fill
from torch_cases import JOINT_NAMES, assert_same

torch.set_num_threads(1)

ACGT = np.frombuffer(b"ACGT", np.uint8)
BIG = 1 << 62


def synthetic_joint(m: int, kind: str, seed: int):
    """A joint string of m symbols (b uint8, sp int32) as the dense scan
    lays it out: a reference part, reference pads (byte 255, ascending
    instance ranks: a window starting there has its pack's top bit set),
    a collection part of documents ended by separators (byte 2), then
    collection pads. ``kind``: "repeats" (the documents copies of the
    reference with a few substitutions: full rounds, then compacted
    ones), "random" (random documents: the seed leaves few unresolved),
    "identical" (one run of A before the final pads: full rounds until
    the window nearly spans it, then a compacted round), "seed_resolved"
    (every symbol a special of its own: the seed resolves every suffix)."""
    rng = np.random.default_rng(seed)
    b = np.full(m, 65, np.uint8)
    sp = np.zeros(m, np.int32)
    tail = 5 + m % 3                       # the collection's pads
    b[m - tail:] = 255
    sp[m - tail:] = np.arange(1, tail + 1) + m
    if kind == "seed_resolved":
        b[:] = 2
        sp[:] = np.arange(1, m + 1)
    if kind in ("seed_resolved", "identical"):
        return b, sp
    n = m // 4
    b[:n] = rng.choice(ACGT, size=n)
    b[n:n + 7] = 255                       # the reference's pads
    sp[n:n + 7] = np.arange(1, 8)
    at, doc = n + 7, 0
    while at < m - tail:
        size = min(n, m - tail - at - 1)
        b[at:at + size] = b[:size] if kind == "repeats" else \
            rng.choice(ACGT, size=size)
        if kind == "repeats":
            snp = at + rng.integers(0, max(size, 1), size=3)
            b[snp[snp < at + size]] = rng.choice(ACGT, size=3)[
                :int((snp < at + size).sum())]
        b[at + size] = 2
        sp[at + size] = 100 + doc
        at, doc = at + size + 1, doc + 1
    return b, sp


# (m, kind): m + 1 and m at the key widths' edges (key_bits(2047) = 11,
# key_bits(2048) = 12), random documents, an all-identical string, one
# resolved at the seed
SYNTH = [(2046, "repeats"), (2047, "repeats"), (2048, "repeats"),
         (2047, "random"), (540, "identical"), (700, "seed_resolved")]


@functools.cache
def _jax_synth(m, kind, wide):
    b, sp = synthetic_joint(m, kind, m)
    out = JJ.joint_suffix_array(jnp.asarray(b), jnp.asarray(sp), m, wide)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("m,kind", SYNTH,
                         ids=[f"{k}{m}" for m, k in SYNTH])
def test_joint_suffix_array_synthetic_matches_jax(m, kind, wide):
    b, sp = synthetic_joint(m, kind, m)
    got = TJ.joint_suffix_array(torch.from_numpy(b), torch.from_numpy(sp),
                                m, wide)
    for k, a, t in zip(JOINT_NAMES, _jax_synth(m, kind, wide), got):
        assert_same(a, t, f"{kind}{m}/{k}")


@pytest.mark.parametrize("kind,m,full,comp,final_sort", [
    ("repeats", 2047, True, False, False),
    ("identical", 540, True, True, True),
    ("random", 2047, False, True, True),
    ("seed_resolved", 700, False, False, True),
])
def test_synthetic_branches_taken(monkeypatch, kind, m, full, comp,
                                  final_sort):
    """The synthetic strings reach the rounds they are meant to (the
    repeats full rounds, the identical run full rounds and then a
    compacted one, the random documents a compacted round alone, the
    seed-resolved string no round), and the final sort of the ranks runs
    after a compacted round and when the seed resolved everything."""
    seen = {"full": 0, "comp": 0, "sorts": []}

    def count(name, fn):
        def wrapped(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapped

    def sort_spy(keys, bits, values=False):
        seen["sorts"].append(len(keys))
        return S.stable_argsort(keys, bits, values)

    monkeypatch.setattr(TJ, "_full_round", count("full", TJ._full_round))
    monkeypatch.setattr(TJ, "_comp_round", count("comp", TJ._comp_round))
    monkeypatch.setattr(TJ, "stable_argsort", sort_spy)
    b, sp = synthetic_joint(m, kind, m)
    TJ.joint_suffix_array(torch.from_numpy(b), torch.from_numpy(sp), m)
    assert (seen["full"] > 0, seen["comp"] > 0) == (full, comp)
    # the narrow seed's three keys first; a final sort has one key
    assert seen["sorts"][0] == 3
    assert (seen["sorts"][-1] == 1 and not seen["full"] + seen["comp"]
            or comp) == final_sort


def _packs(rng, n):
    """int64 bit patterns of uint64 packs: words below 2^32 - 1, half of
    them with the top bit set, many ties."""
    hi = rng.integers(0, 2**32 - 1, size=n, dtype=np.uint64)
    lo = rng.integers(0, 2**32 - 1, size=n, dtype=np.uint64)
    hi[rng.random(n) < 0.3] = 0x80000000
    lo[rng.random(n) < 0.3] = 7
    return ((hi << np.uint64(32)) | lo).view(np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_pack_words_keep_the_signed_flip_order(seed):
    """Two 32-bit word keys order a pack as uint64, as the stable sort of
    the signed ``p ^ SIGN`` (the JAX seed's key) does; five keys chained
    as the wide seed chains them give the one stable order too."""
    rng = np.random.default_rng(seed)
    p1, p2 = (torch.from_numpy(_packs(rng, 3000)) for _ in range(2))
    v = torch.from_numpy(rng.integers(0, 4, size=3000))
    W = TJ.WORD_BITS
    want = torch.sort(p1 ^ TJ.SIGN, stable=True).indices.to(torch.int32)
    assert torch.equal(S.stable_argsort(TJ._words(p1), (W, W)), want)
    o = S.stable_argsort((*TJ._words(p2), v), (W, W, TJ.WIDE_V_BITS))
    chained = o[S.stable_argsort(TJ._words(p1[o]), (W, W))]
    order = torch.sort(v, stable=True).indices
    for k in (p2 ^ TJ.SIGN, p1 ^ TJ.SIGN):
        order = order[torch.sort(k[order], stable=True).indices]
    assert torch.equal(chained, order.to(torch.int32))


# -- the rank step against the inline torch sequence it replaced ------------

def _old_flag_last(flag):
    """The replaced _flag_fill's ``last`` (cumsum, a table scatter, a
    gather), int64."""
    m = flag.shape[0]
    c = torch.cumsum(flag, 0)
    table = torch.full((m + 3,), m, dtype=torch.int64)
    table[0] = -1
    table.scatter_(0, torch.where(flag, c, m + 2),
                   torch.arange(m, dtype=torch.int64))
    return table[c]


def _old_sort_rows(*keys):
    s, order = torch.sort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        s, o = torch.sort(k[order], stable=True)
        order = order[o]
    return order, [k[order] for k in keys[1:]], s


def _old_full_step(rank, lv, k, keys):
    """The replaced _full_round from its two packed int64 sort keys on."""
    i64 = torch.int64
    kk1 = (keys[0].to(i64) << 32) | keys[1].to(i64)
    kk2 = (keys[2].to(i64) << 32) | keys[3].to(i64)
    o_s, (kk2_s,), kk1_s = _old_sort_rows(kk1, kk2)
    ch_mid = TJ._changes(kk1_s)
    ch_full = ch_mid | TJ._changes(kk2_s)
    lv = torch.where(ch_mid & (lv == 0), k + 1, lv).to(torch.int32)
    lv = torch.where(ch_full & (lv == 0), k + 2, lv).to(torch.int32)
    mid_sorted = _old_flag_last(ch_mid).to(torch.int32)
    full_sorted = _old_flag_last(ch_full).to(torch.int32)
    sing = ch_full & TJ._next_is(ch_full)
    mid_rank, full_rank, res = TJ._invert(o_s, mid_sorted, full_sorted,
                                          sing)
    return o_s, mid_rank, full_rank, res, lv, int((~sing).sum())


def _old_comp_step(rank, lv, resolved, k, keys, ti):
    """The replaced _comp_round from its packed sort keys on."""
    i64 = torch.int64
    live = keys[0] != TJ.INT32_MAX
    kk1 = torch.where(live, (keys[0].to(i64) << 32) | keys[1].to(i64),
                      BIG)
    kk2 = (keys[2].to(i64) << 32) | keys[3].to(i64)
    U = ti.shape[0]
    rowsrc, (kk2_s,), kk1_s = _old_sort_rows(kk1, kk2)
    g_hi = (kk1_s >> 32).to(torch.int32)
    is_g = TJ._changes(g_hi)
    is_mid = is_g | TJ._changes(kk1_s)
    is_full = is_mid | TJ._changes(kk2_s)
    live_s = kk1_s < BIG
    g_row = _old_flag_last(is_g).to(torch.int32)
    mid_u = g_hi + (_old_flag_last(is_mid).to(torch.int32) - g_row)
    full_u = g_hi + (_old_flag_last(is_full).to(torch.int32) - g_row)
    lv = lv.clone()
    lv[mid_u[live_s & is_mid & ~is_g].long()] = k + 1
    lv[full_u[live_s & is_full & ~is_mid].long()] = k + 2
    sing = is_full & TJ._next_is(is_full)
    ti_s = ti[torch.clamp(rowsrc, 0, U - 1)]
    at = ti_s[live_s].long()
    mid_rank = rank.clone()
    mid_rank[at] = mid_u[live_s]
    full_rank = rank.clone()
    full_rank[at] = full_u[live_s]
    resolved = resolved.clone()
    resolved[at] = sing[live_s]
    keep = live_s & ~sing
    return (rowsrc, mid_rank, full_rank, resolved, lv, int(keep.sum()),
            (ti_s, full_u, keep))


@functools.cache
def _round_inputs(kind, m, seed):
    """Every round_ranks call of one joint_suffix_array run on a synthetic
    string (inputs cloned)."""
    calls = []
    orig = TJ.round_ranks

    def spy(perm, keys, lv, k, comp=None):
        calls.append((perm.clone(), tuple(x.clone() for x in keys),
                      lv.clone(), k,
                      None if comp is None else tuple(x.clone()
                                                      for x in comp)))
        return orig(perm, keys, lv, k, comp)
    b, sp = synthetic_joint(m, kind, seed)
    TJ.round_ranks = spy
    try:
        TJ.joint_suffix_array(torch.from_numpy(b), torch.from_numpy(sp), m)
    finally:
        TJ.round_ranks = orig
    return calls


@pytest.mark.parametrize("kind,m,seed", [("repeats", 2047, 1),
                                         ("repeats", 2048, 2),
                                         ("identical", 540, 3)])
def test_round_ranks_reference_matches_inline_sequence(kind, m, seed):
    calls = _round_inputs(kind, m, seed)
    assert calls
    for perm, keys, lv, k, comp in calls:
        got = TJ._round_ranks_reference(perm, keys, lv, k, comp)
        if comp is None:
            rank = keys[0]
            o_s, mid, full, res, lv_w, u = _old_full_step(rank, lv, k, keys)
            assert torch.equal(perm, o_s.to(torch.int32))
            want = (mid, full, res, lv_w)
        else:
            ti, rank, resolved = comp
            rowsrc, mid, full, res, lv_w, u, carry = _old_comp_step(
                rank, lv, resolved, k, keys, ti)
            assert torch.equal(perm, rowsrc.to(torch.int32))
            ti_s, full_u, keep = got[5]
            assert torch.equal(ti_s, carry[0])
            assert torch.equal(keep, carry[2])
            # the dead rows' carried ranks are never read
            assert torch.equal(full_u[keep], carry[1][keep])
            want = (mid, full, res, lv_w)
        for a, b in zip(got[:4], want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert got[4].dtype == torch.int32 and int(got[4]) == u


def test_rounds_cover_both_kinds():
    kinds = {c[4] is None for c in _round_inputs("identical", 540, 3)}
    assert kinds == {True, False}


@pytest.mark.parametrize("comp", [False, True], ids=["full", "comp"])
def test_rank_outside_its_width_raises(comp):
    """A rank key outside key_bits(m + 1) bits sets the sort's fault bit,
    and the round raises when it reads its unresolved count."""
    m = 100
    rng = np.random.default_rng(0)
    rank = torch.from_numpy(np.sort(rng.integers(0, m, m)).astype(np.int32))
    rank[5] = 1 << TJ.key_bits(m + 1)        # above the width
    lv = torch.zeros(m, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="outside its stated width"):
        if comp:
            TJ._comp_round(rank, lv, torch.zeros(m, dtype=torch.bool), 3, m,
                           64, None)
        else:
            TJ._full_round(rank, lv, 3, m)
    assert int(S.fault_word("cpu")[0]) == 0   # read and cleared


def test_round_ranks_dispatch():
    """On CPU tensors round_ranks runs the plain version; the CUDA wrapper
    refuses CPU tensors (it launches its kernel or raises)."""
    perm, keys, lv, k, comp = _round_inputs("repeats", 2047, 1)[0]
    calls = TJ.REFERENCE_CALLS["_round_ranks_reference"]
    TJ.round_ranks(perm, keys, lv, k, comp)
    assert TJ.REFERENCE_CALLS["_round_ranks_reference"] == calls + 1
    with pytest.raises(ValueError, match="cuda"):
        kernels.sa_round_cuda(perm, keys, lv, k, comp)


# -- the seed's rank step ----------------------------------------------------

def _old_seed_step(order, rows, sl):
    """The seed's rank step as the port ran it inline before sa_round's
    seed mode: the sorted rows' change flags, the running max of the
    group starts (ops/fill.running_fill), the two inversions."""
    ch_b = TJ._changes(*(r[order] for r in rows))
    split_lv = torch.where(ch_b, sl, 0).to(torch.int32)
    sing_s = ch_b & TJ._next_is(ch_b)
    idx = torch.arange(ch_b.shape[0], dtype=torch.int32)
    last = running_fill(torch.where(ch_b, idx, -1), "max")
    rank, resolved = TJ._invert(order, last, sing_s)
    return split_lv, rank, resolved, ch_b.shape[0] - int(sing_s.sum())


def _seed_model(order, rows, sl):
    """The seed's rank step in numpy: a group starts where any row's word
    differs from the sorted position before."""
    order = order.numpy()
    s = np.stack([r.numpy()[order] for r in rows])
    m = len(order)
    start = np.ones(m, bool)
    start[1:] = (s[:, 1:] != s[:, :-1]).any(0)
    last = np.maximum.accumulate(np.where(start, np.arange(m), -1))
    sing = start & np.append(start[1:], True)
    rank = np.empty(m, np.int32)
    rank[order] = last
    resolved = np.empty(m, bool)
    resolved[order] = sing
    return (np.where(start, sl, 0).astype(np.int32), rank, resolved,
            m - int(sing.sum()))


def _check_seed(got, want, name):
    for k, a, b in zip(("split_lv", "rank", "resolved"), want, got):
        assert_same(a, b, f"{name}/{k}")
    assert got[3].dtype == torch.int32 and got[3].shape == (1,)
    assert int(got[3]) == want[3], name


SEED_SYNTH = SYNTH + [(4099, "repeats")]   # groups across two tile edges


@functools.cache
def _seed_call(m, kind, wide):
    """The seed_ranks call of one joint_suffix_array run (inputs
    cloned)."""
    calls, orig = [], TJ.seed_ranks

    def spy(order, rows, sl):
        calls.append((order.clone(), tuple(r.clone() for r in rows), sl))
        return orig(order, rows, sl)
    b, sp = synthetic_joint(m, kind, m)
    TJ.seed_ranks = spy
    try:
        TJ.joint_suffix_array(torch.from_numpy(b), torch.from_numpy(sp), m,
                              wide)
    finally:
        TJ.seed_ranks = orig
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("m,kind", SEED_SYNTH,
                         ids=[f"{k}{m}" for m, k in SEED_SYNTH])
def test_seed_ranks_reference_matches_inline_and_jax(m, kind, wide):
    """_seed_ranks_reference on the seed's own inputs equals the inline
    torch sequence it replaced and the JAX package's seed: its rank is
    hist[0], its split levels the final ones equal to the seed level
    (rounds set only higher levels), a position resolved where its rank
    is its own, u0 the rest."""
    order, rows, sl = _seed_call(m, kind, wide)
    assert len(rows) == (3 if wide else 2)
    got = TJ._seed_ranks_reference(order, rows, sl)
    _check_seed(got, _old_seed_step(order, rows, sl), f"{kind}{m}/inline")
    _, _, hist, _, _, lv = _jax_synth(m, kind, wide)
    rank = hist[0]
    resolved = np.bincount(rank, minlength=m)[rank] == 1
    want = (np.where(lv == sl, sl, 0).astype(np.int32), rank, resolved,
            m - int(resolved.sum()))
    _check_seed(got, want, f"{kind}{m}/jax")


def _seed_rows(m: int, kind: str, wide: bool, seed: int):
    """The seed's rows (int64 packs, some with the top bit set, and the
    payload) and their stable order as uint64 words: every row equal,
    every row distinct, or groups of random lengths (a few values)."""
    rng = np.random.default_rng(seed)
    n = 3 if wide else 2
    if kind == "equal":
        vals = np.zeros((n, m), np.int64)
    elif kind == "distinct":
        vals = np.zeros((n, m), np.int64)
        vals[0] = rng.permutation(m) - (1 << 62)
    else:
        vals = rng.integers(0, 2, size=(n, m)) * (-(1 << 63) + 5)
    rows = [torch.from_numpy(v) for v in vals]
    if not wide:
        rows[1] = torch.from_numpy(vals[1].astype(np.int32))
    order = np.lexsort([v.view(np.uint64) for v in vals[::-1]])
    return torch.from_numpy(order.astype(np.int32)), rows


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("kind", ["equal", "distinct", "groups"])
@pytest.mark.parametrize("m", [1, 2, 2047, 2048, 2049, 4097])
def test_seed_ranks_reference_on_rows(m, kind, wide):
    """_seed_ranks_reference on rows made here equals a numpy model and
    the inline sequence it replaced: m = 1, all rows equal, all distinct,
    groups straddling the kernel's 2048-row tiles."""
    order, rows = _seed_rows(m, kind, wide, m)
    sl = TJ.WIDE_SEED_LEVEL if wide else TJ.SEED_LEVEL
    got = TJ._seed_ranks_reference(order, rows, sl)
    _check_seed(got, _seed_model(order, rows, sl), "model")
    _check_seed(got, _old_seed_step(order, rows, sl), "inline")


def test_seed_ranks_dispatch():
    """On CPU tensors seed_ranks runs the plain version; the CUDA wrapper
    refuses CPU tensors (it launches its kernel or raises)."""
    order, rows = _seed_rows(100, "groups", False, 0)
    calls = TJ.REFERENCE_CALLS["_seed_ranks_reference"]
    TJ.seed_ranks(order, rows, TJ.SEED_LEVEL)
    assert TJ.REFERENCE_CALLS["_seed_ranks_reference"] == calls + 1
    with pytest.raises(ValueError, match="cuda"):
        kernels.sa_round_seed_cuda(order, rows, TJ.SEED_LEVEL)


# -- the binned scatter's bins -----------------------------------------------

@pytest.mark.parametrize("m,shift,want", [
    (1, 20, (20, 1, 1)),                     # below one bin
    (5, 20, (20, 1, 5)),
    ((1 << 20) - 1, 20, (20, 1, (1 << 20) - 1)),
    (1 << 20, 20, (20, 1, 1 << 20)),         # one whole bin
    ((1 << 20) + 1, 20, (20, 2, 1)),         # a last bin of one
    (252_162_679, 20, (20, 241, 252_162_679 - (240 << 20))),
    ((1 << 30) - 1, 20, (20, 1024, (1 << 20) - 1)),
    (1 << 23, 12, (13, 1024, 1 << 13)),      # widened to 1024 bins
    ((1 << 24) + 3, 12, (15, 513, 3)),
])
def test_sa_round_bins(m, shift, want):
    plan = kernels.sa_round_bins(m, shift)
    assert tuple(plan) == want
    w = [1 << plan.shift] * (plan.bins - 1) + [plan.last]
    assert len(w) == plan.bins <= kernels.SA_MAX_BINS and sum(w) == m
    assert all(x == 1 << plan.shift for x in w[:-1])
    assert 1 <= w[-1] <= 1 << plan.shift
    # a bin holds whole fine bins, at most 1024 of them
    assert kernels.SA_FINE_SHIFT <= plan.shift <= kernels.SA_FINE_SHIFT + 10
    # the narrowest bins that fit: one step narrower needs more bins
    if plan.shift > shift:
        assert ((m - 1) >> (plan.shift - 1)) + 1 > kernels.SA_MAX_BINS


@pytest.mark.parametrize("m,shift,match", [
    (0, 20, "m ="), (1 << 30, 20, "m ="), (100, 11, "bins of"),
    (100, 23, "bins of")])
def test_sa_round_bins_refuse(m, shift, match):
    with pytest.raises(ValueError, match=match):
        kernels.sa_round_bins(m, shift)


def _runs_by_bin(rows, key, nbins, cursor, width, rng):
    """One tile's (or chunk's) rows sorted by bin as the kernels sort
    them: each bin's run in a random order (shared atomics), placed at its
    bin's cursor, the rows past the bin's width dropped. Yields (row,
    place in the bin)."""
    for b in np.unique(key):
        run = rng.permutation(rows[key == b])
        g = cursor[b] + np.arange(len(run))
        cursor[b] += len(run)
        ok = g < width(b)
        yield from zip(run[ok], g[ok])


def _binned_scatter(perm, vals, m, shift, fine_shift, tile, chunk, rng):
    """sa_round_kernel's binned scatter, sa_round_fine and
    sa_round_settle in numpy: the tiles in a random order, each bin's
    rows staged at the bin's cursor; each bin's staging in chunks taken in
    a random order, each fine bin's rows at its cursor; then each fine
    bin's rows written to their positions. A destination outside [0, m)
    and a (fine) bin's overflow are dropped; a position no row reaches
    keeps -1."""
    bins = ((m - 1) >> shift) + 1
    cursor = np.zeros(bins, np.int64)
    st1 = np.full((2, m), -1, np.int64)        # (position in the bin, value)
    bw = lambda b: min(1 << shift, m - (b << shift))
    R = len(perm)
    for t in rng.permutation(-(-R // tile)):
        rows = np.arange(t * tile, min(R, (t + 1) * tile))
        rows = rows[(perm[rows] >= 0) & (perm[rows] < m)]
        for r, g in _runs_by_bin(rows, perm[rows] >> shift, bins, cursor,
                                 bw, rng):
            base = (perm[r] >> shift) << shift
            st1[:, base + g] = perm[r] - base, vals[r]
    fbins = ((m - 1) >> fine_shift) + 1
    fcursor = np.zeros(fbins, np.int64)
    st2 = np.full((2, m), -1, np.int64)
    fw = lambda f: min(1 << fine_shift, m - (f << fine_shift))
    for c in rng.permutation(-(-m // chunk)):
        b = (c * chunk) >> shift
        base = b << shift
        n = min(cursor[b], bw(b))
        rows = np.arange(c * chunk, min(base + n, (c + 1) * chunk))
        f = (base + st1[0, rows]) >> fine_shift
        for r, g in _runs_by_bin(rows, f, fbins, fcursor, fw, rng):
            fb = ((base + st1[0, r]) >> fine_shift) << fine_shift
            st2[:, fb + g] = st1[:, r]
    out = np.full(m, -1, vals.dtype)
    for f in range(fbins):
        fb = f << fine_shift
        n = min(fcursor[f], fw(f))
        pos = st2[0, fb:fb + n] & ((1 << fine_shift) - 1)
        out[fb + pos] = st2[1, fb:fb + n]
    return out


@pytest.mark.parametrize("m,shift,fine", [(1, 4, 2), (17, 4, 2),
                                          (2048, 6, 3), (2049, 6, 4),
                                          (5000, 8, 4), (6001, 10, 6)])
def test_binned_scatter_is_the_scatter(m, shift, fine):
    """The two-level binned scatter writes every position of a permutation
    once, whatever order the tiles, chunks and runs take: the plain
    scatter's output; a destination outside [0, m) and a bin's overflow
    are dropped, leaving only their positions unwritten."""
    rng = np.random.default_rng(m)
    perm = rng.permutation(m)
    vals = rng.integers(0, 1 << 40, size=m)
    want = np.empty(m, np.int64)
    want[perm] = vals
    scatter = lambda p: _binned_scatter(p, vals, m, shift, fine, 64, 16,
                                        rng)
    np.testing.assert_array_equal(scatter(perm), want)
    if m > 1:
        bad = perm.copy()
        bad[0], bad[-1] = m + 3, bad[1]      # out of range; a duplicate
        got = scatter(bad)
        # each position its own value or unwritten; the duplicate's
        # either row's; the two positions no row targets now unwritten,
        # and at most one more a level: a row an overflow dropped
        ok = (got == want) | (got == -1)
        ok[bad[1]] = got[bad[1]] in (vals[1], vals[-1])
        assert ok.all()
        assert got[perm[0]] == got[perm[-1]] == -1
        assert (got == -1).sum() <= 4
