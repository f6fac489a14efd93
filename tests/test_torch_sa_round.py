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
