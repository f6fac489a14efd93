"""The block trees of the CUDA jump scan (cmsbwt_tpu_torch/ops/ms_jump.py
``build_block_trees``) and the plain torch form of its tree queries
(``tree_next_ge``, ``tree_psv_nsv``) against the sparse-table descents of
the port (``next_ge_device``, ``_psv_nsv_fused``) and of the JAX package
(cmsbwt_tpu/ops/ms_jump.py ``next_ge_device``, ``_psv_nsv_fused``), on
the same queries. Tolerance: exact (integers)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cases import CASE_IDS, CASES, assert_same, case_collection
from cmsbwt_tpu.index import device as jdev
from cmsbwt_tpu.ops import ms_jump as jj
from cmsbwt_tpu_torch.index import device as tdev
from cmsbwt_tpu_torch.ops import ms_jump as tj

torch.set_num_threads(1)

INT_MAX = 2**31 - 1
Q = 512          # queries per call (one JAX compile per table shape)


def _numpy_tree(base: np.ndarray, fill: int, reduce) -> np.ndarray:
    """The tree as its definition reads, level by level in numpy."""
    levels = [np.concatenate([base, np.full(-len(base) % 128, fill)])]
    count, width = len(base), 128
    while count > width:      # the level below spans more than one group
        agg = reduce(levels[-1].reshape(-1, width), axis=1)
        count = len(agg)
        levels.append(np.concatenate([agg, np.full(-count % 32, fill)]))
        width = 32
    return np.concatenate(levels).astype(np.int32)


def _check_trees(lcp_n: np.ndarray, g: np.ndarray, trees):
    assert_same(_numpy_tree(lcp_n, INT_MAX, np.min), trees.lcp, "lcp tree")
    assert_same(_numpy_tree(g, -1, np.max), trees.g, "g tree")


def _queries(rng, n, lcp_n, g, far: bool):
    """start, t, pi, ni, ub (int32[Q]) with the edges appended: start = n,
    ni = n, pi = 0, pi = n - 1, a ub above every LCP and a t above every
    g. ``far`` draws thresholds that few entries answer."""
    start = rng.integers(0, n + 1, Q)
    pi = rng.integers(0, n, Q)
    ni = rng.integers(0, n + 1, Q)
    if far:
        t = rng.integers(int(g.max()) - 3, int(g.max()) + 2, Q)
        ub = rng.integers(int(lcp_n.min()), int(lcp_n.min()) + 3, Q)
    else:
        t = start + rng.integers(-2, 24, Q)
        ub = rng.integers(-1, 12, Q)
    edges = [(n, 0, 0, n, 1), (0, int(g.max()) + 1, n - 1, n - 1, INT_MAX),
             (n - 1, int(g.max()) + 1, 0, 0, int(lcp_n.max()) + 1),
             (max(n - 2, 0), -5, n - 1, n, 0)]
    for i, e in enumerate(edges):
        start[i], t[i], pi[i], ni[i], ub[i] = e
    return [np.asarray(a, np.int32) for a in (start, t, pi, ni, ub)]


def _compare(n, lcp_np, plcp_np, rng, far=False):
    """Tree queries against both packages' sparse-table descents."""
    lcp = torch.from_numpy(lcp_np)
    plcp = torch.from_numpy(plcp_np)
    trees = tj.build_block_trees(lcp, plcp, n)
    g = np.arange(n, dtype=np.int64) + plcp_np[:n]
    _check_trees(lcp_np[:n], g, trees)
    start, t, pi, ni, ub = _queries(rng, n, lcp_np[:n], g, far)
    T = [torch.from_numpy(a) for a in (start, t, pi, ni, ub)]

    got_ge = tj.tree_next_ge(trees, T[0], T[1])
    got_p, got_q = tj.tree_psv_nsv(trees, T[2], T[3], T[4])
    jump = tdev.build_lcp_sparse_table(lcp, n)
    gmax = tj.build_gmax_table(plcp, n)
    assert_same(tj.next_ge_device(gmax, T[0], T[1], n), got_ge, "next_ge")
    want_p, want_q = tj._psv_nsv_fused(jump, T[2], T[3], T[4], n)
    assert_same(want_p, got_p, "psv")
    assert_same(want_q, got_q, "nsv")

    jjump = jdev.build_lcp_sparse_table(jnp.asarray(lcp_np), n)
    jgmax = jj.build_gmax_table(jnp.asarray(plcp_np), n)
    assert_same(jj.next_ge_device(jgmax, jnp.asarray(start), jnp.asarray(t),
                                  n), got_ge, "jax next_ge")
    jp, jq = jj._psv_nsv_fused(jjump, jnp.asarray(pi), jnp.asarray(ni),
                               jnp.asarray(ub), n)
    assert_same(jp, got_p, "jax psv")
    assert_same(jq, got_q, "jax nsv")
    return trees


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_trees_on_case_index(case, far):
    """Trees over the JAX package's index of each collection's reference;
    queries as the scan asks them (t = pos + len + 1 >= start)."""
    x_aug, _ = case_collection(case)
    ji = jdev.build_device_index(x_aug)
    lcp, plcp = np.array(ji.lcp), np.array(ji.plcp)
    rng = np.random.default_rng(len(x_aug) + far)
    _compare(ji.n, lcp, plcp, rng, far)


@pytest.mark.parametrize("n", [
    1, 2, 100, 127,               # below one block: no level above the base
    128, 129, 257,                # one past a multiple of 128
    4096, 4097,                   # one past 128 x 32: a third level
    128 * 32 * 32 + 1,            # one past 128 x 32 x 32: a fourth level
    50_000])
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
def test_trees_on_random_rows(n, far):
    """Random int32 rows made with numpy: LCP values anywhere in int32,
    PLCP so that g = p + PLCP[p] stays in int32."""
    rng = np.random.default_rng(n * 2 + far)
    if far:
        lcp = rng.integers(-2**31, 2**31 - 1, n + 1, dtype=np.int64)
        plcp = rng.integers(-2**30, 2**30, n)
    else:
        lcp = rng.integers(0, 9, n + 1)
        plcp = rng.integers(0, 7, n)
    lcp[n] = -1
    trees = _compare(n, lcp.astype(np.int32), plcp.astype(np.int32), rng,
                     far)
    assert len(trees.offsets) == len(tj.tree_geometry(n)[0])
    assert (len(trees.offsets) == 1) == (n <= 128)


@pytest.mark.parametrize("n,levels", [(1, 1), (128, 1), (129, 2),
                                      (4096, 2), (4097, 3), (131072, 3),
                                      (131073, 4), (2**31 - 1, 6)])
def test_tree_geometry_levels(n, levels):
    offsets, counts, size = tj.tree_geometry(n)
    assert len(offsets) == levels == len(counts)
    assert counts[-1] <= (128 if levels == 1 else 32)
    assert all(o % 32 == 0 for o in offsets) and offsets[-1] < size
    assert levels <= tj.TREE_MAX_LEVELS
