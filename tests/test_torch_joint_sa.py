"""The port's joint suffix sort (cmsbwt_tpu_torch/ops/joint_sa.py) against
the JAX package's on the joint strings of tests/test_joint_sa.py: every
output of joint_suffix_array on both seeds, the seed-pack compares, and the
lift from the JAX intermediates. Inputs are made with numpy from seeds.
Tolerance: exact (values, shapes and dtypes)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmsbwt_tpu.ops import joint_sa as JJ
from cmsbwt_tpu.ops import ms_dense as MD
from cmsbwt_tpu_torch.ops import joint_sa as TJ
from cmsbwt_tpu_torch.ops import ms_dense as TD
from torch_cases import (JOINT_NAMES, assert_same, carry_joint,
                         joint_inputs, to_torch)

torch.set_num_threads(1)

# tests/test_joint_sa.py:51-58, plus identical copies whose deep ties run
# two compacted rounds on the narrow seed (the carried slice)
JOINT = {
    "plain": (300, 4, 0, {}),
    "sep_base7": (300, 4, 1, {"sep_base": 7}),
    "sepdense": (64, 40, 2, {"doc_len": 5}),
    "identical": (200, 3, 3, {"snp": 0.0}),
    "truncated": (500, 2, 4, {"trunc": 700}),
    "one_char_doc": (128, 1, 5, {"doc_len": 1}),
    "identical_carried": (100, 2, 9, {"snp": 0.0}),
}


@functools.cache
def _inputs(name):
    ref_len, docs, seed, kw = JOINT[name]
    return joint_inputs(ref_len, docs, seed, **kw)


@functools.cache
def _jax_joint(name, wide):
    j = _inputs(name)
    out = MD._joint_sa(jnp.asarray(j["b"]), jnp.asarray(j["sp"]), j["m"],
                       wide)
    return tuple(np.asarray(a) for a in out)


def _port_joint(name, wide):
    j = _inputs(name)
    return TJ.joint_suffix_array(to_torch(j["b"]), to_torch(j["sp"]),
                                 j["m"], wide)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("name", list(JOINT))
def test_joint_suffix_array_matches_jax(name, wide):
    got = _port_joint(name, wide)
    for k, a, b in zip(JOINT_NAMES, _jax_joint(name, wide), got):
        assert_same(a, b, f"{name}/{k}")
    assert got[3].shape[0] == (2 if wide else 1)


@pytest.mark.parametrize("name", ["plain", "sep_base7", "sepdense",
                                  "truncated"])
def test_build_joint_core_matches_jax(name):
    j = _inputs(name)
    b, sp = TD._build_joint_core(to_torch(j["x_u8"]), to_torch(j["sx_u8"]),
                                 j["n"], j["sn"], j["sep_base"], j["n_pad"],
                                 j["sn_pad"])
    assert_same(j["b"], b, "b")
    assert_same(j["sp"], sp, "sp")


@pytest.mark.parametrize("wide,name,full,comp", [
    (False, "identical", 2, 1),
    (False, "identical_carried", 0, 2),
    (True, "identical", 1, 1),
    (False, "sepdense", 0, 0),
])
def test_round_branches_taken(monkeypatch, wide, name, full, comp):
    """The cases above reach the full, compacted and carried-compacted
    rounds (and the seed-resolved case none), so the equality test covers
    every branch of the round loop."""
    seen = {"full": 0, "comp": 0}

    def count(kind, fn):
        def wrapped(*a, **kw):
            seen[kind] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TJ, "_full_round", count("full", TJ._full_round))
    monkeypatch.setattr(TJ, "_comp_round", count("comp", TJ._comp_round))
    _port_joint(name, wide)
    assert seen == {"full": full, "comp": comp}


def _pack_pairs(rng, k, width, alphabet):
    """k pairs of int64 packs of ``width``-bit symbols from ``alphabet``,
    the second a copy of the first from a random symbol on."""
    per = 64 // width
    sa = rng.choice(alphabet, size=(k, per)).astype(np.uint64)
    sb = sa.copy()
    cut = rng.integers(0, per + 1, size=k)
    for i in range(k):
        sb[i, cut[i]:] = rng.choice(alphabet, size=per - cut[i])
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint64) * np.uint64(width)
    pa = np.bitwise_or.reduce(sa << shifts, axis=1).view(np.int64)
    pb = np.bitwise_or.reduce(sb << shifts, axis=1).view(np.int64)
    return pa, pb


@pytest.mark.parametrize("seed", range(3))
def test_byte8_and_nib16_lcp_match_jax(seed):
    rng = np.random.default_rng(seed)
    pa, pb = _pack_pairs(rng, 512, 8, np.array([65, 67, 71, 84, 2, 255, 0]))
    qa, qb = _pack_pairs(rng, 512, 4, np.arange(16))
    with jax.enable_x64(True):   # int64 packs, as the JAX sort makes them
        want8 = JJ.byte8_lcp(jnp.asarray(pa), jnp.asarray(pb))
        want16 = JJ.nib16_lcp(jnp.asarray(qa), jnp.asarray(qb))
    assert_same(want8, TJ.byte8_lcp(to_torch(pa), to_torch(pb)), "byte8")
    assert_same(want16, TJ.nib16_lcp(to_torch(qa), to_torch(qb)), "nib16")


def _pairs(name, wide, seed):
    """SA-adjacent pairs with their split levels, plus invalid rows (a
    position >= m) and rows without a level (lv 0, as the non-irreducible
    rows past rho carry them)."""
    sa, _, _, _, _, split_lv = _jax_joint(name, wide)
    m = _inputs(name)["m"]
    rng = np.random.default_rng(seed)
    rs = rng.integers(1, m, size=96)
    ai = sa[rs].astype(np.int32)
    bi = sa[rs - 1].astype(np.int32)
    lv = split_lv[rs].astype(np.int32)
    bi[:8] = m
    ai[8:12] = m
    lv[12:24] = 0
    return ai, bi, lv


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("name", ["plain", "identical", "sepdense"])
def test_lift_pairs_matches_jax(name, wide):
    """lift_pairs and pack_lcp_at fed the JAX rank history and packs."""
    jout = _jax_joint(name, wide)
    t = carry_joint(jout)
    m = _inputs(name)["m"]
    ai, bi, lv = _pairs(name, wide, 7)
    with jax.enable_x64(True):   # int64 packs, as the JAX sort makes them
        packs = jnp.asarray(jout[3])
        want = JJ.lift_pairs(jnp.asarray(jout[2]), packs, jnp.asarray(ai),
                             jnp.asarray(bi), jnp.asarray(lv), m)
        want_tail = JJ.pack_lcp_at(packs, jnp.asarray(ai), jnp.asarray(bi),
                                   m)
    calls = TJ.REFERENCE_CALLS["lift_pairs"]
    got = TJ.lcp_lift(t["hist"], t["packs"], to_torch(ai), to_torch(bi),
                      to_torch(lv), m)
    assert TJ.REFERENCE_CALLS["lift_pairs"] == calls + 1
    assert_same(want, got, "h")
    assert_same(want_tail,
                TJ.pack_lcp_at(t["packs"], to_torch(ai), to_torch(bi), m),
                "pack_lcp_at")


@pytest.mark.parametrize("seed", range(3))
def test_flag_fill_is_last_and_first_flag(seed):
    """_last_row (the plain rank steps' cumsum table) and _first_flag
    (ops/fill.running_fill of int32 flagged indices) equal the running
    max/min of flagged indices."""
    rng = np.random.default_rng(seed)
    flag = rng.random(3000) < (0.001, 0.05, 0.5)[seed]
    idx = np.arange(len(flag))
    last = np.maximum.accumulate(np.where(flag, idx, -1))
    first = np.minimum.accumulate(
        np.where(flag, idx, len(flag))[::-1])[::-1]
    got_last = TJ._last_row(torch.from_numpy(flag))
    got_first = TJ._first_flag(torch.from_numpy(flag))
    assert got_last.dtype == got_first.dtype == torch.int32
    np.testing.assert_array_equal(got_last.numpy(), last)
    np.testing.assert_array_equal(got_first.numpy(), first)


def test_wide_seed_bound_is_checked():
    with pytest.raises(ValueError, match="2\\^26"):
        TJ.joint_suffix_array(torch.zeros(8, dtype=torch.uint8),
                              torch.zeros(8, dtype=torch.int32), 1 << 26,
                              wide=True)
