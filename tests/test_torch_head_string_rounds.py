"""The head string's suffix sort without its rank history
(cmsbwt_tpu_torch/index/device.suffix_array_device, history=False) on the
CPU: group-start ranks, a first round on the pairs, then every round over
the rows still unresolved only. Held to the JAX package's
suffix_array_device (sa, isa, k_star) on strings as they are, reversed
and doubled (deep repeats, rows unresolved to the last round), at the
slice's edges (the first round leaves no row, all rows but one, two
rows), and on the head string's pads above 2^30; ``head_string_sa_dev``
to JAX's on the rank strings of real merges; the compacted step's plain
version (``_comp_rank_reference``) to a direct numpy computation; and
numpy models of the CUDA kernels' tiles (kernels/csrc/sa_round.cu:
dense_rank_kernel in both modes with its tie-only key-1 reads, the
group-start mode's slice and its key 1, sa_round_settle's shifted key,
dense_rank_comp_kernel and slice_keys_kernel) to the plain versions.
Inputs are made with numpy from seeds. Tolerance: exact (values, shapes
and dtypes)."""
from __future__ import annotations

import functools

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
    """Counts the port's compacted steps and full steps while in use."""

    def __init__(self, monkeypatch):
        self.comp, self.full = [], []
        comp0, rank0 = tdev.comp_rank, tdev.dense_rank

        def comp(perm, *a, **kw):
            self.comp.append(int(perm.shape[0]))
            return comp0(perm, *a, **kw)

        def full(order, *a, **kw):
            self.full.append(int(order.shape[0]))
            return rank0(order, *a, **kw)
        monkeypatch.setattr(tdev, "comp_rank", comp)
        monkeypatch.setattr(tdev, "dense_rank", full)


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
    # compacted one
    assert rounds.full == [n] and len(rounds.comp) == k_star - 1


def test_compacts_in_every_late_round(monkeypatch):
    """A random string: one full round, then only compacted ones, each
    over fewer rows."""
    x, bound = STRINGS["acgt_3000"]
    rounds = _Rounds(monkeypatch)
    _, isa, _, k_star = tdev.suffix_array_device(to_torch(x), len(x), bound,
                                                 history=False)
    assert rounds.comp and all(a > b for a, b in zip(rounds.comp,
                                                     rounds.comp[1:]))
    assert rounds.full == [len(x)] and rounds.comp[0] < len(x)
    assert len(rounds.full) + len(rounds.comp) == k_star
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
    read0 = tdev._read_top

    def read(top):
        got.append(read0(top))
        return got[-1]
    monkeypatch.setattr(tdev, "_read_top", read)
    rounds = _Rounds(monkeypatch)
    sa, isa, _, k_star = tdev.suffix_array_device(to_torch(x), n, bound,
                                                  history=False)
    assert got[0] == u
    assert rounds.comp[:1] == ([u] if u else [])
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

def _slice_state(x, bound, seed):
    """A mid-sort state of ``x``: the port's rank and order after its
    first round (on the pairs), the unresolved rows as a slice in a
    seeded random order, and their keys at shift 2."""
    n = len(x)
    rank = torch.empty(n, dtype=I32)
    nxt = torch.zeros(n, dtype=I32)
    nxt[:n - 1] = to_torch(x[1:]) + 1
    ti, k0, k1 = (torch.empty(n, dtype=I32) for _ in range(3))
    _, sa, top = tdev._dense_rank((to_torch(x), nxt), (bound, bound + 1),
                                  rank, shift=2, slice_=(ti, k0, k1))
    u = int(top[0])
    rng = np.random.default_rng(seed)
    p = rng.permutation(u)
    tis = ti[:u].numpy()[p]
    rk = rank.numpy()
    at = tis.astype(np.int64) + 2
    k1s = np.where(at < n, rk[np.minimum(at, n - 1)] + 1, 0)
    return rank, sa, tis.astype(np.int32), rk[tis], k1s.astype(np.int32), u


def _numpy_comp(rank, sa, ti, k0, k1, shift):
    """The compacted step by a direct numpy sort and loop."""
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
    return rank, sa, keep_t, np.array(keep_r, np.int32), nk1


@pytest.mark.parametrize("name,seed", [("acgt_3000", 0), ("few_2500", 1),
                                       ("periodic_1200", 2),
                                       ("head_string_2049", 3)])
def test_comp_reference_matches_numpy(name, seed):
    x, bound = STRINGS[name]
    rank, sa, ti, k0, k1, u = _slice_state(x, bound, seed)
    want = _numpy_comp(rank.numpy(), sa.numpy(), ti, k0, k1, 4)
    perm, s0 = S.stable_argsort((to_torch(k0), to_torch(k1)),
                                (S.key_bits(len(x)), S.key_bits(len(x) + 1)),
                                values=True)
    ti_n, k0_n = torch.full((u,), -1, dtype=I32), torch.full((u,), -1,
                                                             dtype=I32)
    k1t = to_torch(k1)
    top = tdev._comp_rank_reference(perm, s0, k1t, to_torch(ti), rank, sa,
                                    (ti_n, k0_n), 4)
    c = int(top[0])
    assert c == len(want[2])
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
        assert u == int(top[0])
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


def _comp_model(perm, s0, k1, ti, rank, sa, cap, seed):
    """dense_rank_comp_kernel tile by tile: group and rank starts, the
    look-back of (last group start, last rank start, unresolved count),
    each row's rank and place written at once, the next slice by count."""
    u = len(perm)
    k1s, tis = k1[perm], ti[perm]
    g = np.ones(u, bool)
    g[1:] = s0[1:] != s0[:-1]
    f = g.copy()
    f[1:] |= k1s[1:] != k1s[:-1]
    nxt = np.ones(u, bool)
    nxt[:-1] = f[1:]
    unres = ~(f & nxt)
    tiles = (u + TILE - 1) // TILE
    agg = []
    for t in range(tiles):
        r = np.arange(t * TILE, min((t + 1) * TILE, u))
        agg.append((int(r[g[r]].max()) if g[r].any() else -1,
                    int(r[f[r]].max()) if f[r].any() else -1,
                    int(unres[r].sum())))
    pre = _prefix_by_tiles(
        agg, lambda x, y: (max(x[0], y[0]), max(x[1], y[1]), x[2] + y[2]),
        (-1, -1, 0), seed)
    rank, sa = rank.copy(), sa.copy()
    placed = np.zeros(len(sa), np.int64)
    ti_n = np.full(cap, -1, np.int64)
    k0_n = np.full(cap, -1, np.int64)
    for t in range(tiles):
        G, F, c = pre[t]
        for r in range(t * TILE, min((t + 1) * TILE, u)):
            G = r if g[r] else G
            F = r if f[r] else F
            if F != G:
                assert rank[tis[r]] == s0[r]
                rank[tis[r]] = s0[r] + (F - G)
            if not unres[r]:
                sa[s0[r] + (r - G)] = tis[r]
                placed[s0[r] + (r - G)] += 1
            if unres[r]:
                if c < cap:
                    ti_n[c], k0_n[c] = tis[r], rank[tis[r]]
                c += 1
    assert placed.max() <= 1
    return rank, sa, ti_n, k0_n, int(unres.sum())


def _slice_keys_model(ti_n, rank, count, cap, h):
    """slice_keys_kernel: the next round's key 1 of the slice's first
    min(count, cap) rows."""
    n = len(rank)
    return np.array([rank[t + h] + 1 if t + h < n else 0
                     for t in ti_n[:min(count, cap)]], np.int64)


@pytest.mark.parametrize("name,seed", [("acgt_3000", 5), ("few_2500", 6),
                                       ("periodic_1200", 7),
                                       ("head_string_2049", 8),
                                       ("equal_777", 9)])
def test_comp_model_matches_reference(name, seed):
    x, bound = STRINGS[name]
    n = len(x)
    rank, sa, ti, k0, k1, u = _slice_state(x, bound, seed)
    perm, s0 = S.stable_argsort((to_torch(k0), to_torch(k1)),
                                (S.key_bits(n), S.key_bits(n + 1)),
                                values=True)
    want = _comp_model(perm.numpy(), s0.numpy(), k1, ti, rank.numpy(),
                       sa.numpy(), u, seed)
    ti_n, k0_n = (torch.full((u,), -1, dtype=I32) for _ in range(2))
    k1t = to_torch(k1)
    top = tdev._comp_rank_reference(perm, s0, k1t, to_torch(ti), rank, sa,
                                    (ti_n, k0_n), 16)
    c = int(top[0])
    assert c == want[4]
    np.testing.assert_array_equal(want[0], rank.numpy())
    np.testing.assert_array_equal(want[1], sa.numpy())
    np.testing.assert_array_equal(want[2][:c], ti_n[:c].numpy())
    np.testing.assert_array_equal(want[3][:c], k0_n[:c].numpy())
    np.testing.assert_array_equal(
        _slice_keys_model(want[2], want[0], c, u, 16), k1t[:c].numpy())


def test_dispatch_by_device():
    """CPU tensors take the plain compacted step; the CUDA wrapper refuses
    a CPU tensor (no fallback); another device type raises."""
    x, bound = STRINGS["acgt_3000"]
    rank, sa, ti, k0, k1, u = _slice_state(x, bound, 3)
    perm, s0 = S.stable_argsort((to_torch(k0), to_torch(k1)),
                                (S.key_bits(len(x)),
                                 S.key_bits(len(x) + 1)), values=True)
    nxt_slice = tuple(torch.empty(u, dtype=I32) for _ in range(2))
    before = tdev.REFERENCE_CALLS["_comp_rank_reference"]
    tdev.comp_rank(perm, s0, to_torch(k1), to_torch(ti), rank, sa,
                   nxt_slice, 4)
    assert tdev.REFERENCE_CALLS["_comp_rank_reference"] == before + 1
    from cmsbwt_tpu_torch import kernels
    with pytest.raises(ValueError, match="cuda"):
        kernels.dense_rank_comp_cuda(perm, s0, to_torch(k1), to_torch(ti),
                                     rank, sa, nxt_slice, 4,
                                     S.fault_word("cpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.comp_rank(perm.to("meta"), s0, to_torch(k1), to_torch(ti),
                       rank, sa, nxt_slice, 4)
