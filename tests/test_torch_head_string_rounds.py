"""The head string's suffix sort without its rank history
(cmsbwt_tpu_torch/index/device.suffix_array_device, history=False) on the
CPU: group-start ranks, a first round on the pairs, then every round over
the rows still unresolved only (a slice in sorted order, no sort: each
group sorted by key 1 among its rows), the rounds from a slice of
COMP_CAP rows or fewer in one call (the tail). Held to the JAX package's
suffix_array_device (sa, isa, k_star) on strings as they are, reversed
and doubled (deep repeats, rows unresolved to the last round), at the
slice's edges (the first round leaves no row, all rows but one, two
rows), at the cap (a slice of one group of COMP_CAP rows, of COMP_CAP + 1
and more: the large-group path's count), on a document repeated, on
tails of several rounds and on the head string's pads above 2^30;
``head_string_sa_dev`` to JAX's on the rank strings of real merges; the
compacted round's plain version (``_comp_rank_reference``) to a direct
numpy computation; and numpy models of the CUDA kernels' tiles
(kernels/csrc/sa_round.cu: dense_rank_kernel in both modes with its
tie-only key-1 reads, the group-start mode's slice, its key 1 and its
large rows' count, sa_round_settle's shifted key; the compacted round's
comp_round_kernel (tiles cut at group starts, each group sorted by
counting, or a tile with a larger group by its bitonic network, the
large groups' rows handed to the tiles they span),
comp_pick_kernel and comp_large_kernel (the large-group path),
slice_keys_kernel and comp_tail_kernel, with a small tile and cap) to the
plain versions. Inputs are made with numpy from seeds. Tolerance: exact
(values, shapes and dtypes)."""
from __future__ import annotations

import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmsbwt_tpu.engine import device_merge as JM
from cmsbwt_tpu.index import device as jdev
from cmsbwt_tpu.ops.ms_jump import ms_jump_heads
from cmsbwt_tpu_torch.engine import device_merge as TM
from cmsbwt_tpu_torch.index import device as tdev
from cmsbwt_tpu_torch.ops import sort as S
from torch_cases import CASE_IDS, CASES, assert_same, carry_heads, \
    case_collection, to_torch

torch.set_num_threads(1)

I32 = torch.int32

def _strings():
    rng = np.random.default_rng(23)
    out = {"acgt_3000": (rng.integers(0, 4, 3000), 256),
           "few_2500": (rng.integers(0, 2, 2500), 256),
           "equal_777": (np.zeros(777, np.int64), 256),
           "periodic_1200": (np.tile([0, 1, 2, 1, 1, 0], 200), 256),
           "period3_999": (np.tile([2, 0, 1], 333), 256),
           "n2": (rng.integers(0, 4, 2), 256),
           "n3": (np.array([1, 1, 1]), 256)}
    # the device merge's head string: ranks with repeats, a terminator 0
    # at h, then distinct ascending pads above 2^30
    h, L = 1500, 2049
    s = np.empty(L, np.int64)
    s[:h] = np.repeat(rng.integers(1, 60, h // 5), 5)
    s[h] = 0
    s[h + 1:] = (1 << 30) + np.arange(h + 1, L)
    out["head_string_2049"] = (s, (1 << 30) + L)
    return {k: (v.astype(np.int32), b) for k, (v, b) in out.items()}


STRINGS = _strings()


def _jax_sa(x):
    sa, isa, _, k_star = jdev.suffix_array_device(jnp.asarray(x), len(x))
    return np.asarray(sa), np.asarray(isa), int(k_star)


class _Rounds:
    """Records the port's full steps (rows), compacted rounds (rows, large
    rows) and tail calls (rows, rounds run) while in use."""

    def __init__(self, monkeypatch):
        self.comp, self.full, self.tails, self.large = [], [], [], []
        comp0, tail0, rank0 = tdev.comp_rank, tdev.comp_tail, \
            tdev.dense_rank

        def comp(slice_, u, large, *a, **kw):
            self.comp.append(u)
            self.large.append(large)
            return comp0(slice_, u, large, *a, **kw)

        def tail(slice_, u, *a, **kw):
            top = tail0(slice_, u, *a, **kw)
            self.tails.append((u, int(top[3])))
            return top

        def full(order, *a, **kw):
            self.full.append(int(order.shape[0]))
            return rank0(order, *a, **kw)
        monkeypatch.setattr(tdev, "comp_rank", comp)
        monkeypatch.setattr(tdev, "comp_tail", tail)
        monkeypatch.setattr(tdev, "dense_rank", full)

    def rounds(self) -> int:
        """The compacted rounds run, one a call or the tail's."""
        return len(self.comp) + sum(r for _, r in self.tails)


FORMS = {"as_is": lambda x: x, "reversed": lambda x: x[::-1].copy(),
         "doubled": lambda x: np.concatenate([x, x])}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(STRINGS))
def test_no_history_matches_jax(name, form, monkeypatch):
    """Each string as it is, reversed, and doubled (a repeat of half its
    length: rows unresolved to the last rounds)."""
    x, bound = STRINGS[name]
    x = FORMS[form](x)
    n = len(x)
    rounds = _Rounds(monkeypatch)
    sa, isa, hist, k_star = tdev.suffix_array_device(to_torch(x), n, bound,
                                                     history=False)
    jsa, jisa, jk = _jax_sa(x)
    assert_same(jsa, sa, "sa")
    assert_same(jisa, isa, "isa")
    assert hist is None and k_star == jk
    # the first round is the one full step; every round after it is a
    # compacted one, the tail's from a slice of at most COMP_CAP rows
    assert rounds.full == [n] and rounds.rounds() == k_star - 1
    assert all(u > tdev.COMP_CAP for u in rounds.comp)
    assert all(u <= tdev.COMP_CAP for u, _ in rounds.tails)
    assert len(rounds.tails) <= 1


def test_compacts_in_every_late_round(monkeypatch):
    """A random string of 12 000 chars: one full round, then compacted
    rounds, each over fewer rows, then the tail once the slice holds
    COMP_CAP rows or fewer."""
    x = np.random.default_rng(41).integers(0, 4, 12_000).astype(np.int32)
    rounds = _Rounds(monkeypatch)
    _, isa, _, k_star = tdev.suffix_array_device(to_torch(x), len(x), 256,
                                                 history=False)
    sizes = rounds.comp + [u for u, _ in rounds.tails]
    assert rounds.comp and rounds.tails
    assert all(a > b for a, b in zip(sizes, sizes[1:]))
    assert rounds.full == [len(x)] and sizes[0] < len(x)
    assert len(rounds.full) + rounds.rounds() == k_star
    assert_same(_jax_sa(x)[1], isa, "isa")


def _edge_strings():
    """Strings whose first round leaves a known count unresolved:
    (values, bound, the count)."""
    rng = np.random.default_rng(31)
    two = np.arange(100)
    two[50:52] = two[10:12]          # one pair twice, every other once
    return {"none_left": (rng.permutation(1000), 1000, 0),
            "two_left": (two, 100, 2),
            "all_but_one": (np.full(777, 5), 256, 776),
            "alternating": (np.tile([0, 1], 500), 256, 999),
            "n1": (np.array([3]), 256, 0)}


EDGES = _edge_strings()


@pytest.mark.parametrize("name", sorted(EDGES))
def test_slice_edges(name, monkeypatch):
    """The first round's slice empty (no compacted round), of two rows,
    and holding every row but the last (whose key 1 is the only 0)."""
    x, bound, u = EDGES[name]
    x = x.astype(np.int32)
    n = len(x)
    got = []
    read0 = tdev._read_round

    def read(top):
        got.append(read0(top))
        return got[-1]
    monkeypatch.setattr(tdev, "_read_round", read)
    rounds = _Rounds(monkeypatch)
    sa, isa, _, k_star = tdev.suffix_array_device(to_torch(x), n, bound,
                                                  history=False)
    assert got[0][0] == u
    first = (rounds.comp + [v for v, _ in rounds.tails])[:1]
    assert first == ([u] if u else [])
    jsa, jisa, jk = _jax_sa(x)
    assert_same(jsa, sa, "sa")
    assert_same(jisa, isa, "isa")
    assert k_star == jk


@pytest.mark.parametrize("history", [True, False], ids=["history", "none"])
def test_pads_above_2_30(history):
    """Every head-string pad distinct and above 2^30 with a string that
    never resolves early: the seed leaves the real part's rows unresolved,
    the pads resolve at once."""
    h, L = 700, 1025
    s = np.zeros(L, np.int64)
    s[:h] = 3
    s[h] = 0
    s[h + 1:] = (1 << 30) + np.arange(h + 1, L)
    s = s.astype(np.int32)
    sa, isa, hist, k_star = tdev.suffix_array_device(
        to_torch(s), L, (1 << 30) + L, history=history)
    jsa, jisa, jk = _jax_sa(s)
    assert_same(jsa, sa, "sa")
    assert_same(jisa, isa, "isa")
    assert k_star == jk


def _cap_strings():
    """Strings whose rounds meet the cap (index/device.COMP_CAP = C):
    (values, bound, what the rounds must show)."""
    C = tdev.COMP_CAP
    rng = np.random.default_rng(43)
    doc = rng.integers(1, 200, 2)
    return {
        # a run of one symbol: the first slice one group of C rows (the
        # tail), of C + 1 (the large path), of C + 2
        "equal_cap": (np.zeros(C + 1, np.int32), 256, "tail_at_cap"),
        "equal_cap_plus_1": (np.zeros(C + 2, np.int32), 256, "large"),
        "equal_cap_plus_2": (np.zeros(C + 3, np.int32), 256, "large"),
        # a collection of one document repeated: groups as large as the
        # copies, above the cap for several rounds
        "repeated_doc": (np.concatenate([np.tile(doc, C + 300), [0]])
                         .astype(np.int32), 256, "large"),
        # a first slice above the cap in groups at it and across tiles,
        # then rounds down to the tail
        "two_runs": (np.concatenate([np.zeros(C, np.int32),
                                     np.full(C + 7, 3, np.int32),
                                     rng.integers(0, 4, 3000)
                                     .astype(np.int32)]), 256, "large"),
        # a tail of several rounds in one call (shifts past m in its last)
        "periodic_tail": (np.tile([0, 1, 2, 1, 1, 0, 2], 400)
                          .astype(np.int32), 256, "tail_rounds"),
    }


CAP_STRINGS = _cap_strings()


@pytest.mark.parametrize("name", sorted(CAP_STRINGS))
def test_cap_strings_match_jax(name, monkeypatch):
    """The suffix sort at the cap's edges against JAX: a slice of exactly
    COMP_CAP rows runs as the tail, one of more rows as rounds whose
    large-group rows the round before counted, and a tail runs several
    rounds in one call."""
    x, bound, shows = CAP_STRINGS[name]
    n = len(x)
    rounds = _Rounds(monkeypatch)
    sa, isa, _, k_star = tdev.suffix_array_device(to_torch(x), n, bound,
                                                  history=False)
    jsa, jisa, jk = _jax_sa(x)
    assert_same(jsa, sa, "sa")
    assert_same(jisa, isa, "isa")
    assert k_star == jk and rounds.rounds() == k_star - 1
    C = tdev.COMP_CAP
    if shows == "tail_at_cap":
        assert not rounds.comp and rounds.tails[0][0] == C
    elif shows == "large":
        assert rounds.large[0] > C and rounds.large[0] <= rounds.comp[0]
    else:
        assert rounds.tails and rounds.tails[0][1] >= 3


@functools.lru_cache(maxsize=None)
def _rank_string(case_idx):
    """A real merge's head rank string (the port's class ranks of the JAX
    jump scan's heads) with h and h_pad."""
    x_aug, sx = case_collection(CASES[case_idx])
    r = ms_jump_heads(x_aug, sx, lanes=4, window=16)
    d = int((sx == 2).sum()) + 1
    p = carry_heads(r)
    h, n = r.h, r.n
    h_pad = int(r.head_t.shape[0])
    f = TM.fixup_dev(p.head_t, p.head_pos, p.head_len, h, p.ref_isa, h_pad)
    c = TM.group_dev(p.head_pos, p.head_len, p.head_smaller, f[0], f[1], h,
                     n, h_pad)
    rt = TM.class_ranks_dev(c, p.ref_isa, h, d, n, h_pad)
    return rt[0].numpy(), h, h_pad


@pytest.mark.parametrize("case_idx", range(len(CASES)), ids=CASE_IDS)
def test_head_string_sa_matches_jax_on_merges(case_idx):
    r2h, h, h_pad = _rank_string(case_idx)
    got = TM.head_string_sa_dev(to_torch(r2h), h, h_pad)
    want = JM.head_string_sa_dev(jnp.asarray(r2h), jnp.int32(h), h_pad)
    assert_same(want, got, "head_to_rank")


# --- the compacted step against a direct numpy computation

def _slice_state(x, bound, seed, shuffle=True):
    """A mid-sort state of ``x``: the port's rank and order after its
    first round (on the pairs), the unresolved rows as a slice, in a
    seeded random order or (``shuffle`` False) in the sorted order the
    round wrote it, and their keys at shift 2."""
    n = len(x)
    rank = torch.empty(n, dtype=I32)
    nxt = torch.zeros(n, dtype=I32)
    nxt[:n - 1] = to_torch(x[1:]) + 1
    ti, k0, k1 = (torch.empty(n, dtype=I32) for _ in range(3))
    _, sa, top = tdev._dense_rank((to_torch(x), nxt), (bound, bound + 1),
                                  rank, shift=2, slice_=(ti, k0, k1))
    u = int(top[0])
    rng = np.random.default_rng(seed)
    p = rng.permutation(u) if shuffle else np.arange(u)
    tis = ti[:u].numpy()[p]
    rk = rank.numpy()
    at = tis.astype(np.int64) + 2
    k1s = np.where(at < n, rk[np.minimum(at, n - 1)] + 1, 0)
    return rank, sa, tis.astype(np.int32), rk[tis], k1s.astype(np.int32), u


def _large_rows(k0, cap=None) -> int:
    """The rows of groups (rows of one key 0) larger than ``cap``
    (COMP_CAP by default)."""
    _, size = np.unique(k0, return_counts=True)
    return int(size[size > (tdev.COMP_CAP if cap is None else cap)].sum())


def _numpy_comp(rank, sa, ti, k0, k1, shift):
    """The compacted round by a direct numpy sort and loop."""
    rank, sa = rank.copy(), sa.copy()
    u, n = len(ti), len(rank)
    order = np.lexsort((np.arange(u), k1, k0))
    keep_t, keep_r = [], []
    r = 0
    while r < u:                      # each group of equal key 0
        g = r
        while r < u and k0[order[r]] == k0[order[g]]:
            r += 1
        f = g
        for q in range(g, r):          # each run of equal key 1
            if k1[order[q]] != k1[order[f]]:
                f = q
            rank[ti[order[q]]] = k0[order[q]] + (f - g)
        for q in range(g, r):
            same = sum(1 for z in range(g, r)
                       if k1[order[z]] == k1[order[q]])
            if same > 1:
                keep_t.append(ti[order[q]])
                keep_r.append(rank[ti[order[q]]])
            else:                      # resolved: placed now
                sa[k0[order[q]] + (q - g)] = ti[order[q]]
    keep_t = np.array(keep_t, np.int32)
    nk1 = np.array([rank[t + shift] + 1 if t + shift < n else 0
                    for t in keep_t], np.int32)
    # the next slice's groups are its rows of one rank
    big = _large_rows(np.array(keep_r, np.int64)) if keep_r else 0
    return rank, sa, keep_t, np.array(keep_r, np.int32), nk1, big


@pytest.mark.parametrize("name,seed", [("acgt_3000", 0), ("few_2500", 1),
                                       ("periodic_1200", 2),
                                       ("head_string_2049", 3)])
def test_comp_reference_matches_numpy(name, seed):
    """The plain round sorts the slice itself: any order of its rows
    gives the round a slice in sorted order does."""
    x, bound = STRINGS[name]
    rank, sa, ti, k0, k1, u = _slice_state(x, bound, seed)
    want = _numpy_comp(rank.numpy(), sa.numpy(), ti, k0, k1, 4)
    ti_n, k0_n = torch.full((u,), -1, dtype=I32), torch.full((u,), -1,
                                                             dtype=I32)
    k1t = to_torch(k1)
    top = tdev._comp_rank_reference((to_torch(ti), to_torch(k0), k1t), u,
                                    _large_rows(k0), rank, sa, (ti_n, k0_n),
                                    4)
    c = int(top[0])
    assert c == len(want[2])
    assert top.tolist()[1:] == [0, want[5], 1]
    for got, w, what in ((rank, want[0], "rank"), (sa, want[1], "sa"),
                         (ti_n[:c], want[2], "ti_n"),
                         (k0_n[:c], want[3], "k0_n"),
                         (k1t[:c], want[4], "k1")):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=what)


# --- numpy models of the kernels' tiles

TILE, FINE = 2048, 4096


def _prefix_by_tiles(agg, combine, identity, seed):
    """Each tile's exclusive prefix as the look-back leaves it: tiles
    finish in a seeded random order, and each folds the aggregates of the
    tiles before it whatever their state."""
    rng = np.random.default_rng(seed)
    pre = [None] * len(agg)
    for t in rng.permutation(len(agg)):
        x = identity
        for q in range(t):
            x = combine(x, agg[q])
        pre[t] = x
    return pre


def _rows_before_and_after(v, r0, rows):
    """The row before a tile's first and after its last (None past the
    ends), as the tile's first and last threads read them."""
    return (v[r0 - 1] if r0 > 0 else None,
            v[r0 + rows] if r0 + rows < len(v) else None)


def _rank_model(order, s0, key1, cap, seed, start_mode):
    """dense_rank_kernel tile by tile: key 1 read only where key 0 ties a
    neighbour, rank starts; in group-start mode the unresolved rows, the
    look-back of (last start row, unresolved count), each row's rank F and
    its place in the slice; in dense mode the look-back of the starts'
    count, each row's rank the count up to it less 1. Returns (rank by
    sorted row, slice rows, the unresolved count, key-1 reads)."""
    n = len(order)
    tie = np.zeros(n, bool)
    tie[1:] |= s0[1:] == s0[:-1]
    tie[:-1] |= s0[:-1] == s0[1:]
    k1 = np.where(tie, key1[order], 0) if key1 is not None else \
        np.zeros(n, np.int64)
    tiles = (n + TILE - 1) // TILE
    start = np.zeros(n, bool)
    for t in range(tiles):
        r = np.arange(t * TILE, min((t + 1) * TILE, n))
        b0, _ = _rows_before_and_after(s0, r[0], len(r))
        b1, _ = _rows_before_and_after(k1, r[0], len(r))
        p0 = np.concatenate([[b0 if b0 is not None else 0], s0[r[:-1]]])
        p1 = np.concatenate([[b1 if b1 is not None else 0], k1[r[:-1]]])
        start[r] = (r == 0) | (s0[r] != p0) | (k1[r] != p1)
    if not start_mode:
        agg = [int(start[t * TILE:(t + 1) * TILE].sum())
               for t in range(tiles)]
        pre = _prefix_by_tiles(agg, lambda x, y: x + y, 0, seed)
        rank = np.empty(n, np.int64)
        for t in range(tiles):
            c = pre[t]
            for r in range(t * TILE, min((t + 1) * TILE, n)):
                c += int(start[r])
                rank[r] = c - 1
        return rank, None, None, int(tie.sum())
    nxt = np.ones(n, bool)
    nxt[:-1] = start[1:]
    unres = ~(start & nxt)
    agg = []
    for t in range(tiles):
        r = np.arange(t * TILE, min((t + 1) * TILE, n))
        top = r[start[r]].max() if start[r].any() else -1
        agg.append((int(top), int(unres[r].sum())))
    pre = _prefix_by_tiles(agg, lambda x, y: (max(x[0], y[0]), x[1] + y[1]),
                           (-1, 0), seed)
    F = np.empty(n, np.int64)
    slice_rows = np.full(cap, -1, np.int64)
    for t in range(tiles):
        f, c = pre[t]
        for r in range(t * TILE, min((t + 1) * TILE, n)):
            if start[r]:
                f = r
            F[r] = f
            if unres[r]:
                if c < cap:
                    assert slice_rows[c] == -1
                    slice_rows[c] = r
                c += 1
    return F, slice_rows, int(unres.sum()), int(tie.sum())


def _runs_above(F, cap) -> int:
    """The rows in runs of more than ``cap`` rows, counted as
    dense_rank_kernel does from each row's distance to its run's first
    row (``F``: that row)."""
    d = np.arange(len(F)) - F
    return int((d > cap).sum() + (cap + 1) * (d == cap).sum())


def _settle_next(rank, h):
    """sa_round_settle's shifted key, fine bin by fine bin: each bin writes
    nxt[t - h] = rank[t] + 1 for its t >= h and nxt[t] = 0 for its t with
    t + h past the end; every position written once."""
    n = len(rank)
    nxt = np.full(n, -1, np.int64)
    written = np.zeros(n, np.int64)
    for base in range(0, n, FINE):
        for t in range(base, min(base + FINE, n)):
            if t >= h:
                nxt[t - h] = rank[t] + 1
                written[t - h] += 1
            if t + h >= n:
                nxt[t] = 0
                written[t] += 1
    assert (written == 1).all()
    return nxt


def _pair_keys(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        a, b = rng.integers(0, n, n), rng.integers(0, n + 1, n)
    elif kind == "few":
        a, b = rng.integers(0, min(3, n), n), rng.integers(0, 2, n)
    elif kind == "equal":
        a, b = np.zeros(n, np.int64), np.zeros(n, np.int64)
    else:
        a, b = rng.permutation(n), rng.integers(0, n + 1, n)
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("mode", ["start", "dense"])
@pytest.mark.parametrize("two_keys", [True, False], ids=["two", "one"])
@pytest.mark.parametrize("n,kind,cap,shift", [
    (1, "random", 1, 1), (2049, "few", 2049, 2), (7000, "random", 1000, 4),
    (6000, "equal", 6000, 1), (9000, "distinct", 50, 8),
    (12289, "few", 500, 3)])
def test_rank_model_matches_reference(n, kind, cap, shift, two_keys, mode):
    """Group-start mode: the rank, the slice (cut at cap) and its key 1 at
    ``shift`` (slice_keys_kernel); dense mode: the rank and the next key
    from the settle."""
    a, b = _pair_keys(n, kind, n + cap)
    keys = (to_torch(a), to_torch(b)) if two_keys else (to_torch(a),)
    bits = (S.key_bits(n), S.key_bits(n + 1))[:len(keys)]
    order, s0 = S.stable_argsort(keys, bits, values=True)
    rank = torch.empty(n, dtype=I32)
    nxt = torch.full((n,), -1, dtype=I32)
    sl = tuple(torch.full((cap,), -1, dtype=I32) for _ in range(3))
    start = mode == "start"
    step = dict(slice_=sl) if start else dict(nxt=nxt)
    _, top = tdev._dense_rank_reference(order, s0, keys[1] if two_keys
                                        else None, rank, shift=shift,
                                        **step)
    F, rows, u, reads = _rank_model(order.numpy(), s0.numpy(),
                                    b if two_keys else None, cap, n, start)
    o = order.numpy()
    model_rank = np.empty(n, np.int64)
    model_rank[o] = F
    np.testing.assert_array_equal(model_rank, rank.numpy())
    if start:
        assert u == int(top[0]) and top.shape == (3,)
        assert int(top[2]) == _runs_above(F, tdev.COMP_CAP)
        c = min(u, cap)
        np.testing.assert_array_equal(o[rows[:c]], sl[0][:c].numpy())
        np.testing.assert_array_equal(F[rows[:c]], sl[1][:c].numpy())
        np.testing.assert_array_equal(
            _slice_keys_model(o[rows[:c]], model_rank, u, cap, shift),
            sl[2][:c].numpy())
        assert (nxt == -1).all()
    else:
        assert int(top[0]) == F.max()
        np.testing.assert_array_equal(_settle_next(model_rank, shift),
                                      nxt.numpy())
    # the reads skipped are those of rows whose key 0 ties no neighbour
    assert reads <= n
    if kind == "distinct":
        assert reads == 0


def _first_above(v, lo, hi, x) -> int:
    """The first index in [lo, hi) at which the nondecreasing ``v``
    exceeds ``x`` (hi if none): the kernel's warp search."""
    return lo + int(np.searchsorted(v[lo:hi], x, side="right"))


def _tile_groups(k0, lo, hi, T, C):
    """tile_groups: the tile's first and last group starts, whether the
    group holding row lo began before it and is large (more than C rows;
    with its first row a0), and whether the group from the last start is
    (else its end b1), found by the kernel's reads beside the tile and
    its searches."""
    u = len(k0)
    st = [r for r in range(lo, hi) if r == 0 or k0[r] != k0[r - 1]]
    first_in, last_in = (st[0], st[-1]) if st else (hi, -1)
    v0, a0, large0 = k0[lo], lo, False
    if first_in != lo:
        if first_in < hi:
            at = first_in - C - 1
            large0 = at >= 0 and k0[at] == v0
            if large0:
                a0 = _first_above(k0, 0, lo, v0 - 1)
        else:
            a0 = _first_above(k0, 0, lo, v0 - 1)
            large0 = _first_above(k0, hi, u, v0) - a0 > C
    large1, b1, v1 = False, hi, 0
    if first_in < hi:
        v1 = k0[last_in]
        at = last_in + C
        large1 = at < u and k0[at] == v1
        if not large1:
            b1 = _first_above(k0, hi, min(u, at + 1), v1)
    return dict(first_in=first_in, last_in=last_in, large0=large0, a0=a0,
                v0=v0, large1=large1, v1=v1, b1=b1)


def _rank_rows(k0, k1, tis, rank, sa, C):
    """The rank logic over rows in sorted order, each group (one key 0)
    contiguous: with G and F the last group and rank start rows, rank[t] =
    key 0 + (F - G) where F != G, sa[key 0 + (r - G)] = t for the
    resolved rows; returns the unresolved rows' (t, rank, key 0) in order
    and the rows in runs of more than C rows that stay unresolved."""
    n = len(k0)
    keep, big, G, F = [], 0, 0, 0
    for r in range(n):
        if r == 0 or k0[r] != k0[r - 1]:
            G = F = r
        elif k1[r] != k1[r - 1]:
            F = r
        new = k0[r] + (F - G)
        if F != G:
            assert rank[tis[r]] == k0[r]
            rank[tis[r]] = new
        end = r + 1 == n or k0[r + 1] != k0[r] or k1[r + 1] != k1[r]
        if F == r and end:
            assert sa[k0[r] + (r - G)] == -7
            sa[k0[r] + (r - G)] = tis[r]
        else:
            keep.append((tis[r], new, k0[r]))
            d = r - F
            big += 1 if d > C else (C + 1 if d == C else 0)
    return keep, big


def _count_sort(k1):
    """Each row's place in its group sorted stably by key 1, as
    sort_groups counts it: the rows with a smaller key, or an equal key
    and an earlier row."""
    n = len(k1)
    return [sum(1 for j in range(n) if k1[j] < k1[i] or
                (k1[j] == k1[i] and j < i)) for i in range(n)]


def _bitonic(words):
    """sort_groups' bitonic network over n words (n any size: the rows
    past n are +inf and never move): for each merge size 2^lk, a flip
    pass (row i against i ^ (2^lk - 1)) then half-cleaners (i against i +
    2^lj), each pass's compare-exchanges at once, as the block runs them
    between two barriers."""
    a = np.asarray(words, np.uint64).copy()
    n = len(a)
    lg = (n - 1).bit_length() if n else 0
    for lk in range(1, lg + 1):
        for lj in range(lk - 1, -1, -1):
            p = np.arange(1 << (lg - 1), dtype=np.int64)
            i = (p >> lj << (lj + 1)) | (p & ((1 << lj) - 1))
            l = i ^ ((2 << lj) - 1) if lj == lk - 1 else i + (1 << lj)
            i, l = i[l < n], l[l < n]
            ai, al = a[i], a[l]
            swap = al < ai
            a[i[swap]], a[l[swap]] = al[swap], ai[swap]
    return a


SORTS_TAKEN = {"count": 0, "bitonic": 0}


def _sorted_groups(k0, k1, tis, S=None):
    """Rows [groups contiguous] with each group sorted stably by key 1 as
    sort_groups sorts them: by _count_sort where no group has more than
    S rows (or S is None), else by _bitonic on one word a row, (its
    group's first row << 44 | key 1 << 13 | row)."""
    n = len(k0)
    k1s, ts = np.empty(n, np.int64), np.empty(n, np.int64)
    first = np.flatnonzero(np.r_[True, k0[1:] != k0[:-1]]) if n else \
        np.zeros(0, np.int64)
    size = np.diff(np.r_[first, n])
    if n and S is not None and size.max() > S:
        SORTS_TAKEN["bitonic"] += 1
        assert n <= 1 << 13 and (np.asarray(k1) < 2**31).all()
        g = np.repeat(first, size).astype(np.uint64)
        w = _bitonic(g << np.uint64(44) | np.asarray(k1, np.uint64)
                     << np.uint64(13) | np.arange(n, dtype=np.uint64))
        assert ((w >> np.uint64(44)) == g).all()   # groups stay in place
        row = (w & np.uint64(0x1fff)).astype(np.int64)
        return (w >> np.uint64(13) & np.uint64(0x7fffffff)).astype(
            np.int64), np.asarray(tis, np.int64)[row]
    SORTS_TAKEN["count"] += 1
    for g, e in zip(first, first + size):
        for i, p in enumerate(_count_sort(k1[g:e])):
            k1s[g + p], ts[g + p] = k1[g + i], tis[g + i]
    return k1s, ts


def _round_model(ti, k0, k1, rank, sa, large, T, C, seed, S=None):
    """comp_round_kernel with its large path, tile by tile, over a slice
    in sorted order (key 0 nondecreasing): comp_pick_kernel's rows of the
    groups above C, their stable sort by (key 0, key 1) and
    comp_large_kernel's rank logic (the large part of the next slice, in
    sorted order, with each row's key 0 before the round); each tile of T
    rows holds the groups that start in it (tile_groups), sorts each
    (_sorted_groups: by counting, or by the bitonic network where one has
    more than S rows) and ranks it, and places its rows of the next slice after
    the look-back of the tiles' counts (tiles in a seeded random order),
    the large groups' j-th rows falling to the tile of their row a + j.
    Returns (rank, sa, ti_n, k0_n, the count, the next slice's rows in
    groups above C)."""
    u = len(ti)
    rank, sa = rank.copy(), sa.copy()
    tiles = (u + T - 1) // T
    info = [_tile_groups(k0, t * T, min(u, (t + 1) * T), T, C)
            for t in range(tiles)]
    picked = []
    for t, g in enumerate(info):
        lo, hi = t * T, min(u, (t + 1) * T)
        e0 = min(hi, g["first_in"]) if g["large0"] else lo
        b1 = g["last_in"] if g["large1"] else hi
        picked += list(range(lo, e0)) + list(range(b1, hi))
    assert len(picked) == large == _large_rows(k0, C)
    p = np.asarray(picked, np.int64)
    order = p[np.lexsort((k1[p], k0[p]))] if len(p) else p
    part, big = _rank_rows(k0[order], k1[order], ti[order], rank, sa, C)
    part_g = np.array([g for _, _, g in part], np.int64)
    counts, rows, handed = [], [], 0
    for t, g in enumerate(info):
        lo, hi = t * T, min(u, (t + 1) * T)
        before, after = [], []
        if g["large0"]:
            s0 = _first_above(part_g, 0, len(part), g["v0"] - 1)
            c0 = _first_above(part_g, s0, len(part), g["v0"]) - s0
            j0, j1 = lo - g["a0"], min(c0, hi - g["a0"])
            before = part[s0 + j0:s0 + max(j0, j1)]
        held = []
        if g["first_in"] < hi:
            s, e = g["first_in"], g["last_in"] if g["large1"] else g["b1"]
            assert e - s <= T + C - 1
            k1s, ts = _sorted_groups(k0[s:e], k1[s:e], ti[s:e], S)
            held, _ = _rank_rows(k0[s:e], k1s, ts, rank, sa, C)
        if g["large1"]:
            s1 = _first_above(part_g, 0, len(part), g["v1"] - 1)
            c1 = _first_above(part_g, s1, len(part), g["v1"]) - s1
            after = part[s1:s1 + min(c1, hi - g["last_in"])]
        rows.append(before + held + after)
        counts.append(len(rows[-1]))
        handed += len(before) + len(after)
    pre = _prefix_by_tiles(counts, lambda x, y: x + y, 0, seed)
    c = sum(counts)
    ti_n = np.full(c, -1, np.int64)
    k0_n = np.full(c, -1, np.int64)
    for t in range(tiles):
        for i, (tq, new, _) in enumerate(rows[t]):
            assert ti_n[pre[t] + i] == -1
            ti_n[pre[t] + i], k0_n[pre[t] + i] = tq, new
    # every large row of the next slice falls to one tile
    assert handed == len(part) and (ti_n >= 0).all()
    return rank, sa, ti_n, k0_n, c, big


def _tail_model(ti, k0, rank, sa, h, rounds, C, S=None):
    """comp_tail_kernel: the slice (u <= C rows) kept in one block's
    shared memory; each round gathers its key 1 (rank[t + h] + 1, 0 past
    m, from the ranks the round before wrote), sorts each group
    (_sorted_groups with S) and ranks it, and keeps its unresolved rows in
    sorted order. Returns (rank, sa, the slice left, the rounds run)."""
    assert len(ti) <= C
    m = len(rank)
    rank, sa = rank.copy(), sa.copy()
    ti, k0 = np.asarray(ti, np.int64), np.asarray(k0, np.int64)
    run = 0
    while len(ti) and run < rounds:
        k1 = np.array([rank[t + h] + 1 if t + h < m else 0 for t in ti],
                      np.int64)
        k1s, ts = _sorted_groups(k0, k1, ti, S)
        keep, _ = _rank_rows(k0, k1s, ts, rank, sa, C)
        ti = np.array([t for t, _, _ in keep], np.int64)
        k0 = np.array([r for _, r, _ in keep], np.int64)
        h, run = 2 * h, run + 1
    return rank, sa, ti, k0, run


def _slice_keys_model(ti_n, rank, count, cap, h):
    """slice_keys_kernel: the next round's key 1 of the slice's first
    min(count, cap) rows."""
    n = len(rank)
    return np.array([rank[t + h] + 1 if t + h < n else 0
                     for t in ti_n[:min(count, cap)]], np.int64)


def _kernel_constant(name: str) -> int:
    """A constexpr int of kernels/csrc/sa_round.cu, read from the source
    (the kernel's tile and counting limit for the models)."""
    import re
    src = (pathlib.Path(tdev.__file__).resolve().parents[1] / "kernels" /
           "csrc" / "sa_round.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("name,seed", [("acgt_3000", 5), ("few_2500", 6),
                                       ("periodic_1200", 7),
                                       ("head_string_2049", 8),
                                       ("equal_777", 9)])
def test_comp_model_matches_reference(name, seed):
    """The round model at the kernel's own tile and cap on a real first
    slice (sorted order), and its next key (slice_keys_kernel)."""
    x, bound = STRINGS[name]
    rank, sa, ti, k0, k1, u = _slice_state(x, bound, seed, shuffle=False)
    sa_m = np.full(len(x), -7, np.int64)
    want = _round_model(ti.astype(np.int64), k0.astype(np.int64),
                        k1.astype(np.int64), rank.numpy().astype(np.int64),
                        sa_m, _large_rows(k0), _kernel_constant("C_TILE"),
                        tdev.COMP_CAP, seed, _kernel_constant("C_SMALL"))
    sa = torch.full((len(x),), -7, dtype=I32)
    ti_n, k0_n = (torch.full((u,), -1, dtype=I32) for _ in range(2))
    k1t = to_torch(k1)
    top = tdev._comp_rank_reference((to_torch(ti), to_torch(k0), k1t), u,
                                    0, rank, sa, (ti_n, k0_n), 16)
    c = int(top[0])
    assert c == want[4] and top.tolist()[1:] == [0, want[5], 1]
    np.testing.assert_array_equal(want[0], rank.numpy())
    np.testing.assert_array_equal(want[1], sa.numpy())
    np.testing.assert_array_equal(want[2], ti_n[:c].numpy())
    np.testing.assert_array_equal(want[3], k0_n[:c].numpy())
    np.testing.assert_array_equal(
        _slice_keys_model(want[2], want[0], c, u, 16), k1t[:c].numpy())


# made slices for the model at a small tile T, cap C and counting limit
# S: (group sizes)
T_MODEL, C_MODEL, S_MODEL = 8, 16, 4
MODEL_SLICES = {
    "small_groups": [2, 3, 1, 4, 2, 5, 2, 2, 3, 1, 2, 4, 3, 2, 2],
    "straddle_tile_edges": [7, 2, 6, 3, 9, 1, 8, 2],
    "at_the_cap": [3, 16, 2, 15, 16, 1],
    "cap_plus_one": [2, 17, 3, 17],
    "large_from_a_tile_end": [7, 17, 2, 40, 1],
    "large_covering_tiles": [3, 50, 2],
    "one_large_group": [70],
    "large_then_large": [17, 18, 2, 19],
    "one_row": [1],
    "every_row_resolved": [2, 3, 4, 5],
}


def _made_slice(sizes, kind, seed):
    """A slice of groups of ``sizes`` rows in sorted order: key 0 each
    group's start rank (with gaps), key 1 of ``kind``, distinct text
    positions, a random rank that is key 0 at the slice's positions."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int64)
    u = int(sizes.sum())
    starts = np.cumsum(np.concatenate([[0], sizes[:-1]])) + np.cumsum(
        rng.integers(0, 3, len(sizes)))
    m = int(starts[-1] + sizes[-1] + 8)
    k0 = np.repeat(starts, sizes)
    k1 = {"few": rng.integers(0, 3, u), "distinct": rng.permutation(u) + 1,
          "equal": np.ones(u, np.int64)}[kind]
    ti = rng.permutation(m)[:u]
    rank = rng.integers(0, m, m)
    rank[ti] = k0
    return tuple(v.astype(np.int32) for v in (ti, k0, k1, rank))


@pytest.mark.parametrize("kind", ["few", "distinct", "equal"])
@pytest.mark.parametrize("name", sorted(MODEL_SLICES))
def test_round_model_small_tile_matches_reference(name, kind):
    """The round model (tiles cut at group starts, the large-group path)
    at T = 8 and C = 16 on made slices, held to the plain round; every
    row resolved where key 1 is distinct."""
    sizes = MODEL_SLICES[name]
    if name == "every_row_resolved":
        kind = "distinct"
    seed = len(name) + len(kind)
    ti, k0, k1, rank = _made_slice(sizes, kind, seed)
    m, u = len(rank), len(ti)
    want = _round_model(ti, k0, k1, rank, np.full(m, -7, np.int64),
                        _large_rows(k0, C_MODEL), T_MODEL, C_MODEL, seed,
                        S_MODEL)
    rk = torch.from_numpy(rank.astype(np.int32))
    sa = torch.full((m,), -7, dtype=I32)
    ti_n, k0_n = (torch.full((u,), -1, dtype=I32) for _ in range(2))
    top = tdev._comp_rank_reference(
        (to_torch(ti), to_torch(k0), to_torch(k1)), u, _large_rows(k0), rk,
        sa, (ti_n, k0_n), 0)
    c = int(top[0])
    assert c == want[4] and top.tolist()[1:] == [0, 0, 1]
    if kind == "distinct":
        assert c == 0
    np.testing.assert_array_equal(want[0], rk.numpy())
    np.testing.assert_array_equal(want[1], sa.numpy())
    np.testing.assert_array_equal(want[2], ti_n[:c].numpy())
    np.testing.assert_array_equal(want[3], k0_n[:c].numpy())
    # the large rows the model counts for the next round are the next
    # slice's rows in groups above C
    assert want[5] == _large_rows(want[3], C_MODEL)


@pytest.mark.parametrize("rounds,h", [(1, 2), (3, 4), (9, 1)])
@pytest.mark.parametrize("name", ["small_groups", "at_the_cap",
                                  "one_row"])
def test_tail_model_matches_reference(name, rounds, h):
    """The tail model (one block, several rounds, each gathering its key
    1 from the ranks the round before wrote; shifts past m) held to the
    plain tail."""
    sizes = MODEL_SLICES[name]
    ti, k0, _, rank = _made_slice(sizes, "few", rounds + h)
    m, u = len(rank), len(ti)
    want = _tail_model(ti, k0, rank, np.full(m, -7, np.int64), h, rounds,
                       C_MODEL + 40, S_MODEL)
    rk = torch.from_numpy(rank.astype(np.int32))
    sa = torch.full((m,), -7, dtype=I32)
    ti_n, k0_n = (torch.full((u,), -1, dtype=I32) for _ in range(2))
    top = tdev._comp_tail_reference(
        (to_torch(ti), to_torch(k0), torch.zeros(u, dtype=I32)), u, rk, sa,
        (ti_n, k0_n), h, rounds)
    c = int(top[0])
    assert top.tolist() == [len(want[2]), 0, 0, want[4]]
    np.testing.assert_array_equal(want[0], rk.numpy())
    np.testing.assert_array_equal(want[1], sa.numpy())
    np.testing.assert_array_equal(want[2], ti_n[:c].numpy())
    np.testing.assert_array_equal(want[3], k0_n[:c].numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 100, 1025, 6143, 8192])
def test_bitonic_matches_stable_sort(n):
    """sort_groups' bitonic network on n words (any n, none padded) of
    its packing, (group's first row << 44 | key 1 << 13 | row), with key
    1 at its extremes (0 and 2^31 - 1) and many ties, to numpy's sort;
    unpacked, the rows of each group in stable order by key 1."""
    rng = np.random.default_rng(n)
    sizes = rng.integers(1, max(2, n // 3), n)
    first = np.repeat(np.cumsum(np.r_[0, sizes[:-1]]), sizes)[:n]
    k1 = rng.choice([0, 1, 5, 2**31 - 1], n)
    w = first.astype(np.uint64) << np.uint64(44) | k1.astype(
        np.uint64) << np.uint64(13) | np.arange(n, dtype=np.uint64)
    got = _bitonic(w)
    np.testing.assert_array_equal(np.sort(w), got)
    row = (got & np.uint64(0x1fff)).astype(np.int64)
    np.testing.assert_array_equal(np.lexsort((np.arange(n), k1, first)),
                                  row)


def test_round_model_takes_both_sorts():
    """At S_MODEL the made slices' tiles sort both ways: by counting
    (every group of at most S rows) and by the bitonic network, with the
    same result as counting alone."""
    taken = dict(SORTS_TAKEN)
    for name, sizes in MODEL_SLICES.items():
        ti, k0, k1, rank = _made_slice(sizes, "few", len(name))
        m = len(rank)
        got, want = (_round_model(ti, k0, k1, rank, np.full(m, -7, np.int64),
                                  _large_rows(k0, C_MODEL), T_MODEL,
                                  C_MODEL, 1, S) for S in (S_MODEL, None))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert SORTS_TAKEN["bitonic"] > taken["bitonic"]
    assert SORTS_TAKEN["count"] > taken["count"]


def test_dispatch_by_device():
    """CPU tensors take the plain compacted round and tail; the CUDA
    wrapper refuses a CPU tensor (no fallback); another device type
    raises."""
    x, bound = STRINGS["acgt_3000"]
    rank, sa, ti, k0, k1, u = _slice_state(x, bound, 3, shuffle=False)
    sl = (to_torch(ti), to_torch(k0), to_torch(k1))
    nxt_slice = tuple(torch.empty(u, dtype=I32) for _ in range(2))
    before = tdev.REFERENCE_CALLS["_comp_rank_reference"]
    tdev.comp_rank(sl, u, 0, rank, sa, nxt_slice, 4)
    assert tdev.REFERENCE_CALLS["_comp_rank_reference"] == before + 1
    top = tdev.comp_tail(sl, min(u, 50), rank, sa, nxt_slice, 4, 2)
    assert tdev.REFERENCE_CALLS["_comp_rank_reference"] == \
        before + 1 + int(top[3])
    from cmsbwt_tpu_torch import kernels
    with pytest.raises(ValueError, match="cuda"):
        kernels.dense_rank_comp_cuda(sl, u, 0, rank, sa, nxt_slice, 4,
                                     S.fault_word("cpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.comp_rank(sl, u, 0, rank.to("meta"), sa, nxt_slice, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.comp_tail(sl, u, rank.to("meta"), sa, nxt_slice, 4, 1)
