"""The port's device merge (cmsbwt_tpu_torch/engine/device_merge.py) on
JAX-produced heads, carried across as numpy: every stage's outputs and the
final (run_len, run_char, counter) equal the JAX package's. Tolerance:
exact (integers and bytes), dtypes included."""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cases import CASE_IDS, CASES, assert_same, carry_heads, \
    case_collection
from cmsbwt_tpu.engine import device_merge as jm
from cmsbwt_tpu.ops.ms_jump import ms_jump_heads
from cmsbwt_tpu_torch.engine import device_merge as tm
from cmsbwt_tpu_torch.utils.buckets import bucket_size

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_heads(case_idx):
    x_aug, sx = case_collection(CASES[case_idx])
    res = ms_jump_heads(x_aug, sx, lanes=4, window=16)
    return res, int((sx == 2).sum()) + 1


@pytest.mark.parametrize("rle_quirk", [False, True])
@pytest.mark.parametrize("case_idx", range(len(CASES)), ids=CASE_IDS)
def test_merge_matches_jax(case_idx, rle_quirk):
    jres, d = _jax_heads(case_idx)
    want = jm.merge_heads_device_resident(jres, d, rle_quirk,
                                          want_counter=True)
    got = tm.merge_heads_device_resident(carry_heads(jres), d, rle_quirk,
                                         want_counter=True)
    for name, a, b in zip(("run_len", "run_char", "counter"), want, got):
        assert_same(a, b, name)


@pytest.mark.parametrize("case_idx", [0, 2, 4], ids=["snp2", "dupdocs",
                                                      "sepdense"])
def test_merge_stages_match_jax(case_idx):
    """Stage by stage, values and dtypes, including the exact-key
    (counterBad) path: the duplicate-document case sends pairs there."""
    r, d = _jax_heads(case_idx)
    p = carry_heads(r)
    h, n = r.h, r.n
    h_pad, n_pad = int(r.head_t.shape[0]), int(r.ref_sa.shape[0])
    i32 = jnp.int32

    a = jm.fixup_dev(r.head_t, r.head_pos, r.head_len, i32(h), r.ref_isa,
                     h_pad)
    b = tm.fixup_dev(p.head_t, p.head_pos, p.head_len, h, p.ref_isa, h_pad)
    for k, x, y in zip(("to_next", "isa_next", "succ"), a, b):
        assert_same(x, y, k)
    assert_same(jm.tail_counts_dev(r.head_pos, a[0], i32(h), h_pad, n_pad),
                tm.tail_counts_dev(p.head_pos, b[0], h, h_pad, n_pad),
                "tails_cnt")
    cj = jm.group_dev(r.head_pos, r.head_len, r.head_smaller, a[0], a[1],
                      i32(h), i32(n), h_pad)
    ct = tm.group_dev(p.head_pos, p.head_len, p.head_smaller, b[0], b[1],
                      h, n, h_pad)
    n_classes = ct.pop("n_classes")
    assert int(cj.pop("n_classes")) == n_classes
    for k in cj:
        assert_same(cj[k], ct[k], "group." + k)
    cj["n_classes"] = ct["n_classes"] = n_classes
    rj = jm.class_ranks_dev(cj, r.ref_isa, i32(h), i32(d), i32(n), h_pad)
    rt = tm.class_ranks_dev(ct, p.ref_isa, h, d, n, h_pad)
    for k, x, y in zip(("rank_to_head", "sa_ord", "cls_of_slot"), rj, rt):
        assert_same(x, y, k)
    cj["cls_of_slot"], ct["cls_of_slot"] = rj[2], rt[2]
    hj = jm.head_string_sa_dev(rj[0], i32(h), h_pad)
    ht = tm.head_string_sa_dev(rt[0], h, h_pad)
    assert_same(hj, ht, "head_to_rank")
    kj = jm.rank_heads_dev(cj, hj, r.head_char, a[2], i32(h), h_pad)
    kt = tm.rank_heads_dev(ct, ht, p.head_char, b[2], h, h_pad)
    for k, x, y in zip(("final_rank", "bwt_heads", "succ_rank",
                        "member_rank_sorted"), kj, kt):
        assert_same(x, y, k)
    pj = jm.tail_pairs_count_dev(cj, h_pad)
    pt = tm.tail_pairs_count_dev(ct, h_pad)
    for k in ("n_buckets", "total"):
        assert int(pj.pop(k)) == pt[k], k
    for k in pj:
        assert_same(pj[k], pt[k], "pairs." + k)
    total = pt["total"]
    p_pad = bucket_size(total + 1)
    pj["total"] = i32(total)
    gj = jm.tail_good_dev(cj, pj, cj["member_off"], i32(h), i32(n), h_pad,
                          p_pad)
    gt = tm.tail_good_dev(ct, pt, ct["member_off"], h, n, h_pad, p_pad)
    assert (int(gj[1]), int(gj[2])) == (gt[1], gt[2])
    for k, x, y in zip(("counter", "e_pidx", "e_fnd", "src_cls"),
                       (gj[0],) + gj[3:], (gt[0],) + gt[3:]):
        assert_same(x, y, "tail_good." + k)
    n_exact, members = gt[1], gt[2]
    if case_idx == 2:
        assert n_exact > 0, "the duplicate-document case must reach " \
            "tail_exact_dev"
    if n_exact:
        e_pad, em_pad = bucket_size(n_exact), bucket_size(members)
        ej = jm.tail_exact_dev(gj[0], cj, pj, cj["member_off"], kj[3], rj[2],
                               gj[3], gj[4], gj[5], i32(n_exact), i32(h),
                               h_pad, e_pad, em_pad)
        et = tm.tail_exact_dev(gt[0], ct, pt, ct["member_off"], kt[3], rt[2],
                               gt[3], gt[4], gt[5], n_exact, h, h_pad,
                               e_pad, em_pad)
        assert_same(ej, et, "tail_exact.counter")


def test_sn_bound(monkeypatch):
    jres, d = _jax_heads(3)
    monkeypatch.setenv("CMSBWT_SN_BOUND", str(jres.sn))
    with pytest.raises(ValueError, match="int32 bound"):
        tm.merge_heads_device_resident(carry_heads(jres), d, False)
