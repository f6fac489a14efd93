"""tail_good's pair expansion in the port's device merge
(cmsbwt_tpu_torch/engine/device_merge.py) on the CPU:
``_pair_expand_reference`` against the torch sequence it replaced and
against the join rows the JAX package's ``tail_good_dev`` sorts (read off
its ``jax.lax.sort`` call, run eagerly) and its ``src_cls``, on the
merges of three collections and on built classes (classes with no pairs,
one class holding most pairs, no pairs at all, pad rows); a numpy model
of the CUDA kernel's blocks (kernels/csrc/pair_expand.cu: one search for
a block's first and last class, class starts marked in the block, a max
scan) against the plain version; ``tail_good_dev`` end to end against
JAX's; the dispatch of ``pair_expand`` by device. Inputs are made with
numpy from seeds. Tolerance: exact (values, shapes and dtypes), but for
one documented difference: with no pairs at all the JAX stage gives the
pad queries the payload -1 (its fill found no class), the port the first
class's size (the last class with pairs is taken as 0); no query of a
pad row is ever credited, so the stage's outputs agree."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmsbwt_tpu.engine import device_merge as JM
from cmsbwt_tpu_torch import kernels
from cmsbwt_tpu_torch.engine import device_merge as TM
from cmsbwt_tpu_torch.ops import ms_jump as mj
from cmsbwt_tpu_torch.utils.buckets import bucket_size
from torch_cases import CASES, assert_same, case_collection

torch.set_num_threads(1)

I32, I64 = torch.int32, torch.int64
INT_MAX = 2**31 - 1
I64_BIG = 1 << 62
FIELDS = ("key1", "key2f", "srcidx", "pay", "src_cls")


def _old_expansion(cls, pairs, slot_base, n, h_pad, p_pad):
    """The torch sequence tail_good_dev ran before its join sort, before
    the pair_expand kernel."""
    cidx = torch.arange(h_pad, dtype=I32)
    cvalid = cidx < cls["n_classes"]
    cnt = pairs["pair_cnt"]
    off = torch.cumsum(cnt, 0).to(I32) - cnt
    pidx = torch.arange(p_pad, dtype=I32)
    total = int(pairs["total"])
    pvalid = pidx < total
    c_p = torch.searchsorted(off + cnt, pidx, right=True)
    last = int(torch.nonzero(cnt > 0)[-1]) if total else 0
    c_p = torch.where(pvalid, c_p, last)
    b_idx = (pidx + (pairs["pair_lo"] - off).to(I64)[c_p]).to(I32)
    b = pairs["bucket_pos"][torch.clamp(b_idx, 0, h_pad - 1)]
    q_len = ((cls["length"].to(I64) + cls["pos"].to(I64))[c_p]
             - b.to(I64)).to(I32)
    q_k = torch.where(cls["smaller"][c_p], q_len, 2 * n - q_len).to(I32)
    q_k2 = torch.where(pvalid, q_k.to(I64) * (n + 1)
                       + cls["isa_next"][c_p].to(I64), I64_BIG)
    t_k2 = torch.where(cvalid, cls["key_k"].to(I64) * (n + 1)
                       + cls["isa_next"].to(I64), I64_BIG)
    key1 = torch.cat([torch.where(cvalid, cls["pos"], INT_MAX).to(I32),
                      torch.where(pvalid, b, INT_MAX).to(I32)])
    key2f = torch.cat([torch.where(cvalid, (t_k2 << 1) | 1, I64_BIG),
                       torch.where(pvalid, q_k2 << 1, I64_BIG)])
    return (key1, key2f, torch.cat([cidx, pidx]),
            torch.cat([slot_base[:h_pad], cls["size"][c_p].to(I32)]),
            c_p.to(I32))


def _jax_rows(cls, pairs, slot_base, h, n, h_pad, p_pad):
    """The join rows the JAX package's tail_good_dev hands its sort, and
    its src_cls, on the same inputs (carried as numpy)."""
    seen = []
    sort = jax.lax.sort

    def spy(operands, *a, **kw):
        if isinstance(operands, tuple) and len(operands) == 4 and \
                operands[0].shape[0] == h_pad + p_pad:
            seen.append(tuple(np.asarray(o) for o in operands))
        return sort(operands, *a, **kw)
    jc = {k: (jnp.int32(v) if k == "n_classes" else jnp.asarray(v.numpy()))
          for k, v in cls.items()
          if k in ("n_classes", "pos", "length", "key_k", "isa_next",
                   "size", "smaller")}
    jp = {k: jnp.asarray(pairs[k].numpy())
          for k in ("pair_cnt", "pair_lo", "bucket_pos")}
    jp["total"] = jnp.int32(pairs["total"])
    jax.lax.sort = spy
    try:
        with jax.disable_jit():
            out = JM.tail_good_dev(jc, jp, jnp.asarray(slot_base.numpy()),
                                   jnp.int32(h), jnp.int32(n), h_pad, p_pad)
    finally:
        jax.lax.sort = sort
    assert len(seen) == 1
    return seen[0] + (np.asarray(out[5]),), out


@functools.lru_cache(maxsize=None)
def _merge_inputs(case_idx):
    """The port's stage inputs of tail_good_dev on one collection (the
    port's stages equal the JAX package's: tests/test_torch_device_merge)."""
    x_aug, sx = case_collection(CASES[case_idx])
    r = mj.ms_jump_heads(x_aug, sx, "cpu", lanes=4, window=16)
    h, n, h_pad = r.h, r.n, int(r.head_t.shape[0])
    to_next, isa_next, _ = TM.fixup_dev(r.head_t, r.head_pos, r.head_len,
                                        h, r.ref_isa, h_pad)
    cls = TM.group_dev(r.head_pos, r.head_len, r.head_smaller, to_next,
                       isa_next, h, n, h_pad)
    pairs = TM.tail_pairs_count_dev(cls, h_pad)
    p_pad = bucket_size(pairs["total"] + 1)
    return cls, pairs, cls["member_off"], h, n, h_pad, p_pad


def _built(kind, seed):
    """Classes and pairs built with numpy: h_pad 4096 class slots, 3000
    valid, n = 50 000; pair counts by ``kind``: 'sparse' (most classes
    without pairs), 'one_big' (one class holding most pairs, across
    several of the kernel's blocks), 'none' (no pairs) or 'mixed'."""
    rng = np.random.default_rng(seed)
    h_pad, nc, n = 4096, 3000, 50_000
    pos = np.full(h_pad, INT_MAX, np.int64)
    pos[:nc] = np.sort(rng.integers(0, n - 100, nc))
    length = np.where(np.arange(h_pad) < nc, rng.integers(1, 60, h_pad), 0)
    smaller = (rng.random(h_pad) < 0.5) & (np.arange(h_pad) < nc)
    key_k = np.where(np.arange(h_pad) < nc,
                     np.where(smaller, length, 2 * n - length), INT_MAX)
    isa_next = np.where(np.arange(h_pad) < nc, rng.integers(0, n, h_pad), 0)
    size = np.where(np.arange(h_pad) < nc, rng.integers(1, 6, h_pad), 0)
    slot_base = np.cumsum(size) - size
    nb = 2500
    bucket_pos = np.full(h_pad, INT_MAX, np.int64)
    bucket_pos[:nb] = np.sort(rng.choice(n, nb, replace=False))
    cnt = np.zeros(h_pad, np.int64)
    if kind == "sparse":
        on = rng.choice(nc, 40, replace=False)
        cnt[on] = rng.integers(1, 30, 40)
    elif kind == "one_big":
        cnt[:nc] = rng.integers(0, 3, nc)
        cnt[1777] = 2400
    elif kind == "mixed":
        cnt[:nc] = rng.integers(0, 12, nc)
    lo = np.where(cnt > 0, rng.integers(0, nb - np.minimum(cnt, nb - 1)), 0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    cls = {"n_classes": nc, "pos": t(pos), "length": t(length),
           "key_k": t(key_k), "isa_next": t(isa_next), "size": t(size),
           "smaller": torch.from_numpy(smaller)}
    total = int(cnt.sum())
    pairs = {"pair_cnt": t(cnt), "pair_lo": t(lo),
             "bucket_pos": t(bucket_pos), "total": total}
    return cls, pairs, t(slot_base), 0, n, h_pad, bucket_size(total + 1)


BUILT = ("sparse", "one_big", "none", "mixed")


def _inputs(which):
    return _merge_inputs(which) if isinstance(which, int) else \
        _built(which, len(which))


CASE_IDS = {0: "snp2", 2: "dupdocs", 4: "sepdense"}
ALL = [0, 2, 4, *BUILT]
IDS = [CASE_IDS.get(w, w) for w in ALL]


@pytest.mark.parametrize("which", ALL, ids=IDS)
def test_reference_matches_replaced_sequence(which):
    cls, pairs, slot_base, h, n, h_pad, p_pad = _inputs(which)
    got = TM._pair_expand_reference(cls, pairs, slot_base, n, h_pad, p_pad)
    want = _old_expansion(cls, pairs, slot_base, n, h_pad, p_pad)
    for k, a, b in zip(FIELDS, want, got):
        assert_same(a.numpy(), b, k)


@pytest.mark.parametrize("which", ALL, ids=IDS)
def test_reference_matches_jax_join_rows(which):
    cls, pairs, slot_base, h, n, h_pad, p_pad = _inputs(which)
    got = TM._pair_expand_reference(cls, pairs, slot_base, n, h_pad, p_pad)
    want, _ = _jax_rows(cls, pairs, slot_base, h, n, h_pad, p_pad)
    total = int(pairs["total"])
    for k, a, b in zip(FIELDS, want, got):
        if k == "pay" and total == 0:
            # the documented difference: JAX's pad queries carry -1
            assert (a[h_pad:] == -1).all()
            assert (b[h_pad:].numpy() == int(cls["size"][0])).all()
            a, b = a[:h_pad], b[:h_pad]
        assert_same(a, b, k)


def _kernel_model(cls, pairs, slot_base, n, h_pad, p_pad, tile=2048):
    """pair_expand_kernel's arithmetic, block by block: the first and last
    class of a block's valid pairs from the inclusive pair-count sums
    (``ends``), each later class with pairs marked at its first pair, a
    running max over the marks; pads take the class of the last pair."""
    cnt = pairs["pair_cnt"].numpy().astype(np.int64)
    ends = np.cumsum(cnt)
    total = int(pairs["total"])
    g = {k: v.numpy().astype(np.int64) for k, v in cls.items()
         if k != "n_classes"}
    lo_b = pairs["pair_lo"].numpy().astype(np.int64)
    bpos = pairs["bucket_pos"].numpy().astype(np.int64)
    nc = cls["n_classes"]
    J = h_pad + p_pad
    key1 = np.empty(J, np.int64)
    key2f = np.empty(J, np.int64)
    srcidx = np.empty(J, np.int64)
    pay = np.empty(J, np.int64)
    src_cls = np.empty(p_pad, np.int64)
    i = np.arange(h_pad)
    valid = i < nc
    key1[:h_pad] = np.where(valid, g["pos"], INT_MAX)
    key2f[:h_pad] = np.where(valid, ((g["key_k"] * (n + 1) + g["isa_next"])
                                     << 1) | 1, I64_BIG)
    srcidx[:h_pad] = i
    pay[:h_pad] = slot_base.numpy()[:h_pad]
    class_of = lambda v: int(np.searchsorted(ends, v, side="right"))
    last = class_of(total - 1) if total else 0
    wrap = lambda v: ((v + 2**31) % 2**32) - 2**31
    for p0 in range(0, p_pad, tile):
        pe, vend = min(p0 + tile, p_pad), min(p0 + tile, p_pad, total)
        cls_of = np.full(pe - p0, last)
        if p0 < vend:
            lo, hi = class_of(p0), class_of(vend - 1)
            mark = np.full(tile, -1)
            mark[0] = lo
            for c in range(lo + 1, hi + 1):
                off = ends[c - 1]
                if ends[c] > off:
                    assert 0 < off - p0 < tile and mark[off - p0] == -1
                    mark[off - p0] = c
            run = np.maximum.accumulate(mark)[:pe - p0]
            cls_of[:vend - p0] = run[:vend - p0]
        p = np.arange(p0, pe)
        c = cls_of
        v = p < total
        off = np.where(c > 0, ends[np.maximum(c - 1, 0)], 0)
        bi = np.clip(wrap(p + wrap(lo_b[c] - off)), 0, h_pad - 1)
        b = bpos[bi]
        q_len = wrap(g["length"][c] + g["pos"][c] - b)
        q_k = np.where(g["smaller"][c] != 0, q_len, wrap(2 * n - q_len))
        key1[h_pad + p] = np.where(v, b, INT_MAX)
        key2f[h_pad + p] = np.where(
            v, (q_k * (n + 1) + g["isa_next"][c]) << 1, I64_BIG)
        srcidx[h_pad + p] = p
        pay[h_pad + p] = g["size"][c]
        src_cls[p] = c
    return key1, key2f, srcidx, pay, src_cls


@pytest.mark.parametrize("which", ALL, ids=IDS)
def test_kernel_model_matches_reference(which):
    cls, pairs, slot_base, h, n, h_pad, p_pad = _inputs(which)
    got = TM._pair_expand_reference(cls, pairs, slot_base, n, h_pad, p_pad)
    for tile in (2048, 64):    # the kernel's blocks, and many small ones
        model = _kernel_model(cls, pairs, slot_base, n, h_pad, p_pad, tile)
        for k, a, b in zip(FIELDS, model, got):
            np.testing.assert_array_equal(a, b.numpy().astype(np.int64),
                                          err_msg=f"{k} (tile {tile})")


@pytest.mark.parametrize("which", [0, 2, 4, "none"],
                         ids=["snp2", "dupdocs", "sepdense", "none"])
def test_tail_good_matches_jax(which):
    """tail_good_dev through pair_expand: counter, n_exact,
    exact_members, the exact pairs and src_cls equal the JAX stage's (on
    the merges' own classes, and with no pairs at all: the other built
    classes meet buckets outside their matches, whose keys the join sort
    refuses)."""
    cls, pairs, slot_base, h, n, h_pad, p_pad = _inputs(which)
    got = TM.tail_good_dev(cls, pairs, slot_base, h, n, h_pad, p_pad)
    _, want = _jax_rows(cls, pairs, slot_base, h, n, h_pad, p_pad)
    assert (int(want[1]), int(want[2])) == (got[1], got[2])
    for k, a, b in zip(("counter", "e_pidx", "e_fnd", "src_cls"),
                       (want[0],) + tuple(want[3:]), (got[0],) + got[3:]):
        assert_same(a, b, k)


def test_pair_expand_dispatch():
    """CPU tensors take the plain version; the CUDA wrapper refuses a CPU
    tensor (no fallback); tail_good_dev keeps its pair-pack refusal."""
    cls, pairs, slot_base, h, n, h_pad, p_pad = _inputs("mixed")
    before = TM.REFERENCE_CALLS["_pair_expand_reference"]
    TM.pair_expand(cls, pairs, slot_base, n, h_pad, p_pad)
    assert TM.REFERENCE_CALLS["_pair_expand_reference"] == before + 1
    with pytest.raises(ValueError, match="cuda"):
        kernels.pair_expand_cuda(
            cls["pos"], cls["length"], cls["key_k"], cls["isa_next"],
            cls["size"], cls["smaller"], pairs["pair_lo"],
            torch.cumsum(pairs["pair_cnt"], 0).to(I32), slot_base,
            pairs["bucket_pos"], cls["n_classes"], pairs["total"], n, p_pad)
    with pytest.raises(ValueError, match="63-bit"):
        TM.tail_good_dev(cls, pairs, slot_base, h, n, h_pad, 1 << 30)
