"""The doubling rounds' rank step of the port's device index
(cmsbwt_tpu_torch/index/device.py) on the CPU: ``_dense_rank_reference``
against the torch sequence it replaced and against the JAX package's
``_dense_rank`` (one key, and the JAX package's packed pair of two), the
round's largest rank and fault word read in one copy (a key outside its
width raises through it), ``suffix_array_device`` with and without its
history against the JAX package's (sa, isa, k_star, every history row),
at n = 1, 2, a power of two, a repetitive 3-letter alphabet and the head
string's distinct pads above 2^30, the dispatch of ``dense_rank`` by
device, and a numpy model of the CUDA kernel's tiles and two-level
binned store (kernels/csrc/sa_round.cu, dense_rank_kernel). Inputs are
made with numpy from seeds. Tolerance: exact (values, shapes and
dtypes)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmsbwt_tpu.engine import device_merge as JM
from cmsbwt_tpu.index import device as jdev
from cmsbwt_tpu_torch import kernels
from cmsbwt_tpu_torch.index import device as tdev
from cmsbwt_tpu_torch.ops import sort as S
from torch_cases import assert_same, to_torch

torch.set_num_threads(1)

I32 = torch.int32


def _old_dense_rank(keys, bounds):
    """The torch sequence the rank step replaced (index/device.py before
    the dense_rank kernel): the order's gather, two compares, an int64
    cumsum and the scatter, with int(rank.max()) read after it."""
    n = keys[0].shape[0]
    order, s0 = S.stable_argsort(keys, [S.key_bits(b) for b in bounds],
                                 values=True)
    diff = s0[1:] != s0[:-1]
    for k in keys[1:]:
        ks = k[order]
        diff |= ks[1:] != ks[:-1]
    changed = torch.ones(n, dtype=I32)
    changed[1:] = diff.to(I32)
    rank = torch.empty(n, dtype=I32)
    rank[order] = (torch.cumsum(changed, 0) - 1).to(I32)
    return rank, order


def _keys(n, kind, seed):
    """Two int32 key rows below (n, n + 1): random, few values, all equal,
    or all distinct."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        a, b = rng.integers(0, n, n), rng.integers(0, n + 1, n)
    elif kind == "few":
        a, b = rng.integers(0, 3, n), rng.integers(0, 2, n)
    elif kind == "equal":
        a, b = np.zeros(n, np.int64), np.zeros(n, np.int64)
    else:
        a, b = rng.permutation(n), rng.integers(0, n + 1, n)
    return a.astype(np.int32), b.astype(np.int32)


CASES = [(1, "random"), (2, "few"), (64, "random"), (1000, "few"),
         (1000, "equal"), (3000, "distinct"), (5000, "random")]


@pytest.mark.parametrize("n,kind", CASES,
                         ids=[f"{n}-{k}" for n, k in CASES])
def test_reference_matches_replaced_sequence_and_jax(n, kind):
    a, b = _keys(n, kind, n)
    for keys, bounds in (((to_torch(a),), (n,)),
                         ((to_torch(a), to_torch(b)), (n, n + 1))):
        want, want_order = _old_dense_rank(keys, bounds)
        rank, order, top = tdev._dense_rank(keys, bounds)
        assert_same(want.numpy(), rank, "rank")
        assert_same(want_order.numpy(), order, "order")
        assert top.dtype == I32 and top.shape == (2,)
        assert int(top[0]) == int(want.max()) and int(top[1]) == 0
        # the JAX package's rank of the same rows (its pair packed)
        if len(keys) == 1:
            jr = jdev._dense_rank(jnp.asarray(a))
        else:
            with jax.enable_x64(True):
                pair = (jnp.asarray(a, jnp.int64) << 32) | \
                    jnp.asarray(b, jnp.int64)
                jr = jdev._dense_rank(pair)
        assert_same(np.asarray(jr), rank, "rank vs JAX")


def test_reference_writes_into_out():
    a, b = _keys(500, "few", 3)
    out = torch.full((500,), -7, dtype=I32)
    rank, _, _ = tdev._dense_rank((to_torch(a), to_torch(b)), (500, 501),
                                  out)
    assert rank.data_ptr() == out.data_ptr()
    assert_same(_old_dense_rank((to_torch(a), to_torch(b)),
                                (500, 501))[0].numpy(), out, "out")


def test_fault_word_read_with_the_largest_rank():
    """A key outside its stated width sets the sorts' fault word; the
    round's one copy brings it with the largest rank and raises, clearing
    the word."""
    a, b = _keys(300, "random", 5)
    bad = to_torch(b)
    bad[7] = -5    # negative: outside every width
    rank, order, top = tdev._dense_rank((to_torch(a), bad), (300, 301))
    assert int(top[1]) == 2
    with pytest.raises(RuntimeError, match="key \\[1\\]"):
        tdev._read_top(top)
    assert int(S.fault_word("cpu")[0]) == 0
    _, _, top = tdev._dense_rank((to_torch(a), to_torch(b)), (300, 301))
    assert tdev._read_top(top) == int(top[0])


def _texts():
    rng = np.random.default_rng(11)
    out = {"n1": (rng.integers(0, 4, 1), 256),
           "n2": (rng.integers(0, 4, 2), 256),
           "pow2_128": (rng.integers(0, 4, 128), 256),
           "acgt_1000": (rng.integers(0, 4, 1000), 256),
           "three_700": (rng.integers(0, 3, 700), 256),
           "repeats_512": (np.tile([0, 1, 2, 1], 128), 256),
           "equal_300": (np.zeros(300, np.int64), 256)}
    # the head string of the device merge: ranks, a terminator 0 at h,
    # then distinct ascending pads above 2^30
    h, L = 900, 1025
    s = np.empty(L, np.int64)
    s[:h] = rng.integers(1, 40, h)
    s[h] = 0
    s[h + 1:] = (1 << 30) + np.arange(h + 1, L)
    out["head_string_1025"] = (s, (1 << 30) + L)
    return {k: (v.astype(np.int32), bd) for k, (v, bd) in out.items()}


TEXTS = _texts()


@pytest.mark.parametrize("history", [True, False], ids=["history", "none"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_suffix_array_matches_jax(name, history):
    x, bound = TEXTS[name]
    n = len(x)
    sa, isa, hist, k_star = jdev.suffix_array_device(jnp.asarray(x), n)
    tsa, tisa, thist, tk = tdev.suffix_array_device(to_torch(x), n, bound,
                                                    history=history)
    assert_same(sa, tsa, "sa")
    assert_same(isa, tisa, "isa")
    assert int(k_star) == tk
    if history:
        assert_same(hist, thist, "history")
    else:
        assert thist is None


def test_head_string_sa_matches_jax_and_keeps_no_history(monkeypatch):
    """head_string_sa_dev asks for no history, and equals the JAX
    package's on the same rank string."""
    x, _ = TEXTS["head_string_1025"]
    h, h_pad = 900, 1024
    r2h = x.copy()
    r2h[h + 1:] = 0
    asked = []
    sad = tdev.suffix_array_device

    def spy(*a, **kw):
        asked.append(kw.get("history", True))
        return sad(*a, **kw)
    monkeypatch.setattr(tdev, "suffix_array_device", spy)
    from cmsbwt_tpu_torch.engine import device_merge as TM
    got = TM.head_string_sa_dev(to_torch(r2h), h, h_pad)
    want = JM.head_string_sa_dev(jnp.asarray(r2h), jnp.int32(h), h_pad)
    assert_same(want, got, "head_to_rank")
    assert asked == [False]


def test_dense_rank_dispatch():
    """CPU tensors take the plain version; the CUDA wrapper refuses a CPU
    tensor (no fallback), and another device type raises."""
    a, b = _keys(50, "random", 2)
    order, s0 = S.stable_argsort((to_torch(a), to_torch(b)), (6, 6),
                                 values=True)
    before = tdev.REFERENCE_CALLS["_dense_rank_reference"]
    tdev.dense_rank(order, s0, to_torch(b))
    assert tdev.REFERENCE_CALLS["_dense_rank_reference"] == before + 1
    with pytest.raises(ValueError, match="cuda"):
        kernels.dense_rank_cuda(order, s0, to_torch(b), S.fault_word("cpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.dense_rank(order.to("meta"), s0.to("meta"))


# --- a numpy model of dense_rank_kernel and its two-level binned store

TILE, FINE_SHIFT = 2048, 12


def _kernel_model(order, s0, key1, shift, seed):
    """dense_rank_kernel's arithmetic, tile by tile in a seeded random
    order of completion (the look-back's prefix is the sum of the earlier
    tiles' counts whatever the order), each row's predecessor read across
    tile edges as the kernel does; then the tiles' runs staged by bin of
    2^shift positions (each bin's runs in the order the tiles took their
    cursor), sorted by fine bin, and settled: returns (rank, top0)."""
    n = len(order)
    rng = np.random.default_rng(seed)
    k1 = key1[order] if key1 is not None else np.zeros(n, np.int64)
    tiles = (n + TILE - 1) // TILE
    counts = np.zeros(tiles, np.int64)
    flags = np.zeros(n, bool)
    for t in range(tiles):
        r = np.arange(t * TILE, min((t + 1) * TILE, n))
        prev0 = np.where(r > 0, s0[np.maximum(r - 1, 0)], 0)
        prev1 = np.where(r > 0, k1[np.maximum(r - 1, 0)], 0)
        flags[r] = (r == 0) | (s0[r] != prev0) | (k1[r] != prev1)
        counts[t] = flags[r].sum()
    ranks = np.empty(n, np.int64)
    bins = ((n - 1) >> shift) + 1
    staged = [[] for _ in range(bins)]
    for t in rng.permutation(tiles):
        r = np.arange(t * TILE, min((t + 1) * TILE, n))
        ranks[r] = counts[:t].sum() + np.cumsum(flags[r]) - 1
        for b in np.unique(order[r] >> shift):   # one run a bin a tile
            sel = r[(order[r] >> shift) == b]
            staged[b] += [((order[s] - (b << shift)) << 1, ranks[s])
                          for s in sel]
    rank = np.full(n, -1, np.int64)
    for b, rows in enumerate(staged):
        assert len(rows) == min(1 << shift, n - (b << shift))
        fine = {}
        for pos, rk in rows:          # second level: by fine bin
            fine.setdefault(int(pos) >> (1 + FINE_SHIFT), []).append(
                (pos, rk))
        for f, frows in fine.items():  # settle: each position once
            for pos, rk in frows:
                at = (b << shift) + (int(pos) >> 1)
                assert rank[at] == -1
                rank[at] = rk
    return rank, ranks[n - 1]


@pytest.mark.parametrize("n,kind,shift", [(1, "random", 12),
                                          (4097, "few", 12),
                                          (10000, "random", 12),
                                          (9000, "distinct", 13),
                                          (6000, "equal", 12)])
def test_kernel_model_matches_reference(n, kind, shift):
    a, b = _keys(n, kind, n + shift)
    keys = (to_torch(a), to_torch(b))
    order, s0 = S.stable_argsort(keys, (S.key_bits(n), S.key_bits(n + 1)),
                                 values=True)
    want, top = tdev._dense_rank_reference(order, s0, keys[1])
    rank, top0 = _kernel_model(order.numpy(), s0.numpy(), b, shift, n)
    np.testing.assert_array_equal(rank, want.numpy())
    assert top0 == int(top[0])


def test_bins_of_the_head_string_shape():
    """The 500 Mchar head string (L = 36 051 597) takes 35 bins of 2^20
    positions, under the kernel's 1024, each of at most 256 fine bins."""
    plan = kernels.sa_round_bins(36_051_597)
    assert plan == kernels.BinPlan(20, 35, 36_051_597 - (34 << 20))
