"""The port's jump scan (cmsbwt_tpu_torch/ops/ms_jump.py) against the JAX
package's: the plain scan's raw state equals repeated JAX ms_jump_step
calls on one identical index, and ms_jump_heads gives the same
DeviceHeadsResult. Tolerance: exact (integers and bytes)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cases import (CASE_IDS, CASES, assert_same, case_collection,
                         to_torch)
from cmsbwt_tpu.index import device as jdev
from cmsbwt_tpu.ops import ms_jump as jj
from cmsbwt_tpu_torch.index import device as tdev
from cmsbwt_tpu_torch.ops import ms_jump as tj

torch.set_num_threads(1)

HEAD_FIELDS = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
               "ref_sa", "ref_isa", "ref_bwt")


def _raw_scans(x_aug, sx, lanes, window, cap):
    """Final JAX and port scan states for one input, one index."""
    ji = jdev.build_device_index(x_aug)
    n, sn = ji.n, len(sx)
    gm = jj.build_gmax_table(ji.plcp, n)
    chunk_len = -(-sn // lanes)
    starts = (np.arange(lanes) * chunk_len).astype(np.int32)
    ends = np.minimum(starts + chunk_len, sn).astype(np.int32)
    sxp = np.concatenate([sx, np.zeros(window, np.uint8)])
    st = jj.jump_init_state(starts, ends, lanes, n, cap)
    while not bool(np.all(np.asarray(st["done"]))):
        st = jj.ms_jump_step(ji.x_padded, ji.sa, ji.isa, ji.plcp, ji.jump,
                             gm, jnp.asarray(sxp), st, jnp.asarray(ends),
                             n=n, sn=sn, cap=cap, window=window,
                             max_iters=512)
    ti = tdev.index_from_numpy(
        {f: np.asarray(getattr(ji, f)) for f in tdev.FIELDS}, "cpu")
    tg = tj.build_gmax_table(ti.plcp, n)
    assert_same(gm, tg, "gmax")
    ts = tj.jump_init_state(starts, ends, lanes, n, cap, "cpu")
    ts = tj.ms_jump_scan(ti.x_padded, ti.sa, ti.isa, (ti.jump, tg),
                         to_torch(sxp), ts, to_torch(ends), n=n, sn=sn,
                         cap=cap, window=window)
    return st, ts


@pytest.mark.parametrize("lanes", [3, 16])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_scan_state_matches_ms_jump_step(case, lanes):
    x_aug, sx = case_collection(case)
    st, ts = _raw_scans(x_aug, sx, lanes, window=16, cap=64)
    for k in tj.STATE_FIELDS:
        assert_same(st[k], ts[k], k)


def test_plain_scan_state_matches_on_overflow():
    """Records past the capacity are dropped and counted exactly as the
    JAX scan drops them (viol set, nrec past cap)."""
    x_aug, sx = case_collection(CASES[2])
    st, ts = _raw_scans(x_aug, sx, lanes=4, window=16, cap=8)
    assert bool(ts["viol"].any())
    for k in tj.STATE_FIELDS:
        assert_same(st[k], ts[k], k)


@pytest.mark.parametrize("lanes", [3, 16])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_ms_jump_heads_matches_jax(case, lanes):
    x_aug, sx = case_collection(case)
    j = jj.ms_jump_heads(x_aug, sx, lanes=lanes, window=16)
    t = tj.ms_jump_heads(x_aug, sx, "cpu", lanes=lanes, window=16)
    assert (t.h, t.n, t.sn, t.irreducible) == (j.h, j.n, j.sn, j.irreducible)
    for f in HEAD_FIELDS:
        assert_same(getattr(j, f), getattr(t, f), f)


def test_ms_jump_heads_capacity_retry(monkeypatch):
    """A first capacity too small for some lane: the scan reruns with the
    capacity doubled and the heads still equal JAX's."""
    x_aug, sx = case_collection(CASES[0])
    monkeypatch.setattr(tj, "_initial_cap", lambda chunk_len: 8)
    calls0 = tj.REFERENCE_CALLS["ms_jump_scan_reference"]
    t = tj.ms_jump_heads(x_aug, sx, "cpu", lanes=3, window=16)
    assert tj.REFERENCE_CALLS["ms_jump_scan_reference"] - calls0 == 2
    j = jj.ms_jump_heads(x_aug, sx, lanes=3, window=16)
    assert t.h == j.h
    for f in HEAD_FIELDS:
        assert_same(getattr(j, f), getattr(t, f), f)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises; it never
    runs the plain version itself."""
    from cmsbwt_tpu_torch.kernels import ms_jump_scan_cuda
    x_aug, sx = case_collection(CASES[3])
    ti = tdev.build_device_index(x_aug, "cpu")
    st = tj.jump_init_state(np.zeros(1, np.int32),
                            np.full(1, len(sx), np.int32), 1, ti.n, 64,
                            "cpu")
    with pytest.raises(ValueError, match="cuda"):
        ms_jump_scan_cuda(ti.x_padded, ti.sa, ti.isa,
                          tj.build_block_trees(ti.lcp, ti.plcp, ti.n),
                          to_torch(np.concatenate([sx, np.zeros(16,
                                                                np.uint8)])),
                          st, to_torch(np.full(1, len(sx), np.int32)),
                          n=ti.n, sn=len(sx), cap=64, window=16)
