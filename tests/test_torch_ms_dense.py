"""The port's dense scan (cmsbwt_tpu_torch/ops/ms_dense.py) against the JAX
package's: ms_dense_heads_on_device field for field on the collections of
tests/torch_cases.CASES and on a collection with a repeated non-ACGT byte
(the narrow seed), and every stage at its boundary fed the JAX
intermediates. Inputs are made with numpy from seeds. Tolerance: exact
(values, shapes and dtypes)."""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import mutate, random_dna
from cmsbwt_tpu.io.fasta import SEPARATOR, augment_reference
from cmsbwt_tpu.ops import joint_sa as JJ
from cmsbwt_tpu.ops import ms_dense as MD
from cmsbwt_tpu.utils.jaxcache import bucket_size
from cmsbwt_tpu_torch.ops import ms_dense as TD
from torch_cases import (CASE_IDS, CASES, assert_same, carry_joint,
                         case_collection, jax_joint_string, to_torch)

torch.set_num_threads(1)

HEAD_FIELDS = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
               "ref_sa", "ref_isa", "ref_bwt")


def _n_run_collection():
    """tests/test_torch_reference_parity.py's duplicates-and-N collection:
    the repeated N bytes make the JAX package take the narrow seed."""
    rng = np.random.default_rng(3)
    ref = random_dna(rng, 600)
    d = mutate(rng, ref, 0.01)
    docs = [d, d, b"ACGTNNNNACGT" + d[:100], d]
    sep = np.full(1, SEPARATOR, np.uint8)
    sx = np.concatenate([sep] + [np.concatenate(
        [np.frombuffer(x, np.uint8), sep]) for x in docs])
    return np.frombuffer(augment_reference(ref), np.uint8), sx


def _narrow_collection():
    """Mutated copies with N runs in two documents (the narrow seed)."""
    rng = np.random.default_rng(21)
    ref = random_dna(rng, 1500)
    docs = [mutate(rng, ref, 0.01) for _ in range(4)]
    docs[1] = docs[1][:300] + b"NNN" + docs[1][300:]
    docs[3] = docs[3][:900] + b"NNNNNN" + docs[3][900:]
    sep = np.full(1, SEPARATOR, np.uint8)
    sx = np.concatenate([sep] + [np.concatenate(
        [np.frombuffer(x, np.uint8), sep]) for x in docs])
    return np.frombuffer(augment_reference(ref), np.uint8), sx


def _near_pow2_collection():
    """An unrelated reference and document with rho = 521, just above
    512: the JAX package's pow2 bucket of 1024 rows then runs past the
    631 real text positions into the pad rows."""
    rng = np.random.default_rng(7)
    ref = random_dna(rng, 256)
    sep = np.full(1, SEPARATOR, np.uint8)
    sx = np.concatenate([sep, np.frombuffer(random_dna(rng, 250), np.uint8),
                         sep])
    return np.frombuffer(augment_reference(ref), np.uint8), sx


COLLECTIONS = dict(zip(CASE_IDS, CASES))
EXTRA = {"nrun": _n_run_collection, "narrow2": _narrow_collection,
         "nearpow2": _near_pow2_collection}


def _collection(cid):
    if cid in EXTRA:
        return EXTRA[cid]()
    return case_collection(COLLECTIONS[cid])


def _jax_wide(x_u8, sx_u8, n, sn, m) -> bool:
    """The JAX _dense_core's seed choice, from its own packing helper."""
    px, psx = MD._pack2_host(x_u8, n), MD._pack2_host(sx_u8, sn)
    if px is None or psx is None:
        return False
    chk = np.concatenate([px[2], psx[2][psx[2] != SEPARATOR]])
    return m < (1 << 26) and len(chk) == len(np.unique(chk))


@functools.cache
def _jax_stages(cid) -> dict:
    """Every intermediate of the JAX dense scan on one collection, as
    numpy, in the order _dense_core / ms_dense_heads_on_device run them."""
    x, sx = _collection(cid)
    j = jax_joint_string(x, sx)
    n, sn, n_pad, sn_pad, m = (j[k] for k in ("n", "sn", "n_pad", "sn_pad",
                                              "m"))
    wide = _jax_wide(j["x_u8"], j["sx_u8"], n, sn, m)
    b, sp = jnp.asarray(j["b"]), jnp.asarray(j["sp"])
    joint = MD._joint_sa(b, sp, m, wide)
    sa, isa, hist, packs, _, split_lv = joint
    stats, ai_all, bi_all, lv_all = MD._irreducible_slots(
        b, sp, sa, isa, split_lv, n, sn, m, n_pad)
    rho = int(stats[0])
    rho_pad = min(MD._pow2_pad(rho), m)
    ai, bi, lv = ai_all[:rho_pad], bi_all[:rho_pad], lv_all[:rho_pad]
    h = JJ.lift_pairs(hist, packs, ai, bi, lv, m)
    ell = MD._fill_ell(h, ai, isa, m, rho_pad)
    # the JAX package's two lifts over the rho irreducible rows alone
    ell_rho = (MD._lift_and_fill(hist, packs, ai_all, bi_all, lv_all, isa,
                                 m, rho),
               MD._lift_orchestrated(hist, packs, ai_all, bi_all, lv_all,
                                     isa, np.asarray(stats), m, rho))
    nbr = MD._neighbors(sa, ell, n, m)
    asm = MD._assemble(sa, *nbr, n, sn, m, n_pad, sn_pad)
    post = MD._postprocess(b, *asm[:3], n, sn, n_pad, sn_pad)
    hh = int(post[4])
    h_pad = bucket_size(hh + 1)
    comp = MD._compact_heads_raw(*post[:4], post[5], sn_pad,
                                 min(h_pad, sn_pad + 1))
    fin = MD._finish_for_merge(*comp, asm[3], asm[4], b, n, hh, h_pad,
                               n_pad)
    g = lambda t: tuple(np.asarray(a) for a in t)
    return dict(x=x, sx=sx, n=n, sn=sn, n_pad=n_pad, sn_pad=sn_pad, m=m,
                wide=wide, b=np.asarray(b), sp=np.asarray(sp),
                joint=g(joint), stats=np.asarray(stats),
                slots=g((ai_all, bi_all, lv_all)), rho_pad=rho_pad,
                h=np.asarray(h), ell=np.asarray(ell), ell_rho=g(ell_rho),
                nbr=g(nbr),
                asm=g(asm), post=g(post), hh=hh, h_pad=h_pad,
                comp=g(comp), fin=g(fin))


STAGE_CASES = ["snp2", "identical", "sepdense", "nrun"]


@pytest.mark.parametrize("cid", CASE_IDS + list(EXTRA))
def test_heads_on_device_matches_jax(cid):
    x, sx = _collection(cid)
    want = MD.ms_dense_heads_on_device(x, sx)
    got = TD.ms_dense_heads_on_device(x, sx, "cpu")
    for f in HEAD_FIELDS:
        assert_same(getattr(want, f), getattr(got, f), f)
    for f in ("h", "n", "sn", "irreducible"):
        assert getattr(want, f) == getattr(got, f), f


@pytest.mark.parametrize("cid", STAGE_CASES)
def test_wide_seed_choice_matches_jax(cid):
    s = _jax_stages(cid)
    assert s["wide"] == (cid != "nrun")
    got = TD.wide_seed_ok(to_torch(s["x"]), to_torch(s["sx"]), s["m"])
    assert got == s["wide"]
    assert TD.joint_geometry(s["n"], s["sx"]) == (s["n_pad"], s["sn_pad"],
                                                  s["m"])


@pytest.mark.parametrize("extra,want", [
    (b"", True),                  # ACGT only
    (b"\xc8\xc9", True),          # non-ACGT bytes that occur once
    (b"N", False),                # N also in the augmented reference
    (b"\xc8" * 1100, False),      # too many exceptions to pack
])
def test_wide_seed_predicate_cases(extra, want):
    rng = np.random.default_rng(11)
    x = np.frombuffer(augment_reference(random_dna(rng, 300)), np.uint8)
    sx = np.concatenate([[SEPARATOR], np.frombuffer(
        random_dna(rng, 2000) + extra, np.uint8), [SEPARATOR]]) \
        .astype(np.uint8)
    m = bucket_size(len(x)) + bucket_size(len(sx))
    assert _jax_wide(x, sx, len(x), len(sx), m) == want
    assert TD.wide_seed_ok(to_torch(x), to_torch(sx), m) == want
    assert not TD.wide_seed_ok(to_torch(x), to_torch(sx), 1 << 26)


@pytest.mark.parametrize("cid", STAGE_CASES)
def test_irreducible_slots_match_jax(cid):
    s = _jax_stages(cid)
    j = carry_joint(s["joint"])
    got = TD._irreducible_slots(to_torch(s["b"]), to_torch(s["sp"]),
                                j["sa"], j["isa"], j["split_lv"], s["n"],
                                s["sn"], s["m"], s["n_pad"])
    assert_same(s["stats"], got[0], "stats")
    for k, a, b in zip(("ai", "bi", "lv"), s["slots"], got[1:]):
        assert_same(a, b, k)


@pytest.mark.parametrize("cid", STAGE_CASES)
def test_lift_and_fill_match_jax(cid):
    """The lift over the rho_pad prefix (irreducible rows, then rows with
    no level) and the PLCP fill, from the JAX slots."""
    s = _jax_stages(cid)
    j = carry_joint(s["joint"])
    ai, bi, lv = (to_torch(a) for a in s["slots"])
    rp, m = s["rho_pad"], s["m"]
    h = TD.lcp_lift(j["hist"], j["packs"], ai[:rp], bi[:rp], lv[:rp], m)
    assert_same(s["h"], h, "h")
    assert_same(s["ell"], TD._fill_ell(h, ai[:rp], j["isa"], m), "ell")


@pytest.mark.parametrize("cid", STAGE_CASES + ["narrow2", "nearpow2"])
def test_lift_of_irreducible_rows_matches_jax(cid):
    """The dense scan lifts the rho irreducible rows only, with lmax from
    the stats. Its ell equals the JAX package's from both of its lifts
    (_lift_and_fill, _lift_orchestrated) over the same rows, and the JAX
    production ell (the pow2-bucketed prefix of rows) at every slot of a
    real text position; at every slot when the bucket holds no pad row.
    (Pad slots differ where the bucket reaches pad rows, as in the
    nearpow2 case; no head reads them, see test_heads_on_device_matches_jax.)"""
    s = _jax_stages(cid)
    j = carry_joint(s["joint"])
    m, n, sn, n_pad = s["m"], s["n"], s["sn"], s["n_pad"]
    rho, lmax = TD._lift_rows(to_torch(s["stats"]))
    assert s["wide"] == (cid not in ("nrun", "narrow2"))
    assert rho == int(s["stats"][0])
    assert lmax == max(int(v) for v in s["slots"][2][:rho])
    ai, bi, lv = (to_torch(a)[:rho] for a in s["slots"])
    h = TD.lcp_lift(j["hist"], j["packs"], ai, bi, lv, m, lmax)
    ell = TD._fill_ell(h, ai, j["isa"], m)
    assert_same(s["ell_rho"][0], ell, "ell vs _lift_and_fill")
    assert_same(s["ell_rho"][1], ell, "ell vs _lift_orchestrated")
    sa = s["joint"][0]
    pad = ((sa >= n) & (sa < n_pad)) | (sa >= n_pad + sn)
    np.testing.assert_array_equal(s["ell"][~pad], ell.numpy()[~pad])
    rows = s["slots"][0][rho:s["rho_pad"]]
    pad_rows = bool((((rows >= n) & (rows < n_pad))
                     | (rows >= n_pad + sn)).any())
    assert pad_rows == (cid == "nearpow2")
    if not pad_rows:
        assert_same(s["ell"], ell, "ell vs the bucketed JAX ell")


@pytest.mark.parametrize("cid", STAGE_CASES)
def test_neighbors_match_jax(cid):
    s = _jax_stages(cid)
    sa = to_torch(s["joint"][0])
    calls = TD.REFERENCE_CALLS["neighbors_reference"]
    got = TD._neighbors(sa, to_torch(s["ell"]), s["n"], s["m"])
    assert TD.REFERENCE_CALLS["neighbors_reference"] == calls + 1
    for k, a, b in zip(("pred_pos", "succ_pos", "a", "b"), s["nbr"], got):
        assert_same(a, b, k)


@pytest.mark.parametrize("cid", STAGE_CASES)
def test_assemble_and_postprocess_match_jax(cid):
    s = _jax_stages(cid)
    asm = TD._assemble(to_torch(s["joint"][0]),
                       *(to_torch(a) for a in s["nbr"]), s["n"], s["sn"],
                       s["m"], s["n_pad"], s["sn_pad"])
    for k, a, b in zip(("pos", "length", "smaller", "ref_sa", "ref_isa"),
                       s["asm"], asm):
        assert_same(a, b, k)
    # the unblocked postprocess: the block form emitting all sn positions,
    # with no previous pos and the collection's last byte before the first
    post = TD._postprocess_block(to_torch(s["b"]),
                                 *(to_torch(a) for a in s["asm"][:3]),
                                 s["n"], s["sn"], -2, int(s["sx"][-1]),
                                 s["n_pad"], s["sn_pad"])
    assert post[5] == s["hh"]
    for k, a, b in zip(("pos", "length", "smaller", "is_head", "_", "char"),
                       s["post"], post[:4] + (None, post[4])):
        if k != "_":
            assert_same(a, b, k)


@pytest.mark.parametrize("cid", STAGE_CASES)
def test_compact_and_finish_match_jax(cid):
    s = _jax_stages(cid)
    p = [to_torch(a) for a in s["post"]]
    comp = TD._compact_heads_raw(*p[:4], p[5], s["sn_pad"],
                                 min(s["h_pad"], s["sn_pad"] + 1))
    for k, a, b in zip(("t", "pos", "len", "smaller", "char"), s["comp"],
                       comp):
        assert_same(a, b, k)
    fin = TD._finish_for_merge(
        *(to_torch(a) for a in s["comp"]), to_torch(s["asm"][3]),
        to_torch(s["asm"][4]), to_torch(s["b"]), s["n"], s["hh"],
        s["h_pad"], s["n_pad"])
    for k, a, b in zip(HEAD_FIELDS, s["fin"], fin):
        assert_same(a, b, k)


@pytest.mark.parametrize("m,width", [(1, 4), (4096, 4096), (10_000, 128),
                                     (70_001, 4096)])
def test_running_max_equals_cummax(m, width):
    rng = np.random.default_rng(m)
    v = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, m).astype(np.int32))
    np.testing.assert_array_equal(TD._running_max(v, width).numpy(),
                                  torch.cummax(v, 0).values.numpy())


def test_dense_memory_check_names_the_blocked_scan():
    """The memory guard runs the unblocked scan while its need fits the
    budget, and above it names the blocked scan's block size (at least 8
    Mi chars; 60% of what the budget leaves beside the reference)."""
    n, sn = 1_000_000, 20_000_000
    need = TD.DENSE_BYTES_PER_CHAR * (bucket_size(n) + bucket_size(sn + 1))
    assert TD.dense_block_chars(n, sn, need) is None
    assert TD.dense_block_chars(n, sn, need - 1) == \
        int(((need - 1) / TD.DENSE_BYTES_PER_CHAR - bucket_size(n)) * 0.6)
    assert TD.dense_block_chars(n, sn, 2**30) == 8 << 20
    assert TD.dense_block_chars(n, sn, None) is None


@pytest.mark.parametrize("cid", CASE_IDS + list(EXTRA))
def test_ms_dense_matches_jax(cid):
    """ms_dense, the per-position test path: the JAX package's
    DenseMSResult field for field (values, shapes, dtypes)."""
    x, sx = _collection(cid)
    want = MD.ms_dense(x, sx)
    got = TD.ms_dense(x, sx, "cpu")
    for f in ("pos", "length", "smaller", "is_head", "ref_sa", "ref_isa",
              "ref_bwt"):
        assert_same(getattr(want, f), getattr(got, f), f)
    assert (got.irreducible, got.m) == (want.irreducible, want.m)
    assert int(got.is_head.sum()) == TD.ms_dense_heads_on_device(
        x, sx, "cpu").h


def test_ms_dense_unbucketed_is_refused():
    x, sx = _collection("snp2")
    with pytest.raises(ValueError, match="bucketed"):
        TD.ms_dense(x, sx, "cpu", bucketed=False)
