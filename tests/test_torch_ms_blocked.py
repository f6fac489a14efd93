"""The port's blocked dense scan (cmsbwt_tpu_torch/ops/ms_dense.py) against
the JAX package's: ms_dense_heads_blocked_on_device field for field
(irreducible, the sum of the blocks' rho, included) at one, two and many
blocks and with a context so small that blocks retry; its heads and
reference index against the unblocked scan's; _postprocess_block fed the
JAX intermediates of one block; _SepCounter against np.cumsum. With
per-block checkpoints (BlockCheckpoints) against the JAX
ms_dense_heads_blocked (saved, reloaded with no stage run, one deleted
block recomputed, the JAX package's files read), as one block against the
JAX ms_dense_heads, and the merge of blocks loaded from the JAX package's
files against its merge_heads_numpy. Inputs are made with numpy from
seeds. Tolerance: exact (values, shapes and dtypes)."""
from __future__ import annotations

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import mutate, random_dna
from cmsbwt_tpu.engine import device_merge as JM
from cmsbwt_tpu.io.fasta import SEPARATOR, augment_reference
from cmsbwt_tpu.ops import ms_dense as MD
from cmsbwt_tpu.utils.jaxcache import bucket_size
from cmsbwt_tpu_torch.engine import device_merge as TM
from cmsbwt_tpu_torch.ops import ms_dense as TD
from torch_cases import CASE_IDS, CASES, assert_same, case_collection, \
    to_torch

torch.set_num_threads(1)

HEAD_FIELDS = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
               "ref_sa", "ref_isa", "ref_bwt")
RETRY = "context overflow"


def _n_run_collection():
    """Duplicates and an N run (the narrow seed; as test_torch_ms_dense)."""
    rng = np.random.default_rng(3)
    ref = random_dna(rng, 600)
    d = mutate(rng, ref, 0.01)
    docs = [d, d, b"ACGTNNNNACGT" + d[:100], d]
    return _join(ref, docs)


def _narrow_collection():
    """Mutated copies with N runs in two documents (the narrow seed)."""
    rng = np.random.default_rng(21)
    ref = random_dna(rng, 1500)
    docs = [mutate(rng, ref, 0.01) for _ in range(4)]
    docs[1] = docs[1][:300] + b"NNN" + docs[1][300:]
    docs[3] = docs[3][:900] + b"NNNNNN" + docs[3][900:]
    return _join(ref, docs)


def _join(ref: bytes, docs) -> tuple:
    sep = np.full(1, SEPARATOR, np.uint8)
    sx = np.concatenate([sep] + [np.concatenate(
        [np.frombuffer(x, np.uint8), sep]) for x in docs])
    return np.frombuffer(augment_reference(ref), np.uint8), sx


COLLECTIONS = dict(zip(CASE_IDS, CASES))
EXTRA = {"nrun": _n_run_collection, "narrow": _narrow_collection}
CIDS = CASE_IDS + list(EXTRA)


def _collection(cid):
    if cid in EXTRA:
        return EXTRA[cid]()
    return case_collection(COLLECTIONS[cid])


def _layout(layout: str, sn: int):
    """(block_chars, ctx_chars) of a layout: one block, two, many (seven
    or more), and many with a context of 4 chars and blocks that do not
    end at document ends, so that blocks retry."""
    return {"one": (sn, 64), "two": (-(-sn // 2), 64),
            "many": (max(sn // 7, 16), 64),
            "retry": (max(sn // 7, 16) + 3, 4)}[layout]


def _assert_heads(want, got, fields=HEAD_FIELDS):
    for f in fields:
        assert_same(getattr(want, f), getattr(got, f), f)


@pytest.mark.parametrize("layout", ["one", "two", "many", "retry"])
@pytest.mark.parametrize("cid", CIDS)
def test_blocked_on_device_matches_jax(cid, layout, capfd):
    x, sx = _collection(cid)
    block, ctx = _layout(layout, len(sx))
    want = MD.ms_dense_heads_blocked_on_device(x, sx, block_chars=block,
                                               ctx_chars=ctx)
    capfd.readouterr()
    got = TD.ms_dense_heads_blocked_on_device(x, sx, "cpu", block, ctx)
    retries = capfd.readouterr().err.count(RETRY)
    _assert_heads(want, got)
    for f in ("h", "n", "sn", "irreducible"):
        assert getattr(want, f) == getattr(got, f), f
    if layout == "retry":
        assert retries > 0
    # the blocks' heads and reference index are the unblocked scan's
    _assert_heads(TD.ms_dense_heads_on_device(x, sx, "cpu"), got)


@functools.cache
def _jax_block(cid, b0_share, ctx, emit_share):
    """The JAX blocked scan's intermediates of one block (the block at
    ``b0_share`` of the collection, emitting ``emit_share`` of what is
    left, with ``ctx`` chars of context) up to _postprocess_block, and its
    outputs, as numpy."""
    x, sx = _collection(cid)
    n, sn = len(x), len(sx)
    b0 = int(sn * b0_share)
    emit = max(1, int((sn - b0) * emit_share))
    end = min(b0 + emit + ctx, sn)
    blk = sx[b0:end]
    n_pad = bucket_size(n)
    bs_pad = bucket_size(emit + ctx)
    if bs_pad == len(blk) and blk[-1] != SEPARATOR:
        bs_pad = bucket_size(bs_pad + 1)
    m = n_pad + bs_pad
    x_u8 = np.zeros(n_pad, np.uint8)
    x_u8[:n] = x
    sx_u8 = np.zeros(bs_pad, np.uint8)
    sx_u8[:len(blk)] = blk
    sep_base = int(np.count_nonzero(sx[:b0] == SEPARATOR))
    i32 = jnp.int32
    b, sp = MD._build_joint_device(jnp.asarray(x_u8), jnp.asarray(sx_u8),
                                   i32(n), i32(len(blk)), i32(sep_base),
                                   n_pad, bs_pad)
    sa, isa, hist, packs, _, split_lv = MD._joint_sa(b, sp, m)
    stats, ai, bi, lv = MD._irreducible_slots(b, sp, sa, isa, split_lv,
                                              i32(n), i32(len(blk)), m,
                                              n_pad)
    rho_pad = min(MD._pow2_pad(int(stats[0])), m)
    ell = MD._lift_orchestrated(hist, packs, ai, bi, lv, isa,
                                np.asarray(stats), m, rho_pad)
    nbr = MD._neighbors(sa, ell, i32(n), m)
    pos, length, smaller, _, _ = MD._assemble(sa, *nbr, i32(n),
                                              i32(len(blk)), m, n_pad,
                                              bs_pad)
    prev_pos0 = 17 if b0 else -2
    prev_b0 = int(sx[b0 - 1]) if b0 else SEPARATOR
    out = MD._postprocess_block(b, pos, length, smaller, i32(n), i32(emit),
                                i32(prev_pos0), i32(prev_b0), n_pad, bs_pad)
    g = lambda t: tuple(np.asarray(a) for a in t)
    return dict(n=n, emit=emit, n_pad=n_pad, bs_pad=bs_pad,
                prev_pos0=prev_pos0, prev_b0=prev_b0, b=np.asarray(b),
                inputs=g((pos, length, smaller)), out=g(out[:5]),
                scalars=np.asarray(out[5]))


@pytest.mark.parametrize("cid,b0_share,ctx,emit_share", [
    ("snp2", 0.0, 64, 0.3), ("snp2", 0.4, 64, 0.3), ("snp2", 0.4, 8, 0.2),
    ("identical", 0.5, 4, 0.5), ("sepdense", 0.3, 16, 0.3),
    ("sepdense", 0.3, 16, 1.0), ("nrun", 0.2, 32, 0.4)])
def test_postprocess_block_matches_jax(cid, b0_share, ctx, emit_share):
    s = _jax_block(cid, b0_share, ctx, emit_share)
    got = TD._postprocess_block(
        to_torch(s["b"]), *(to_torch(a) for a in s["inputs"]), s["n"],
        s["emit"], s["prev_pos0"], s["prev_b0"], s["n_pad"], s["bs_pad"])
    for k, a, b in zip(("pos", "length", "smaller", "is_head", "char"),
                       s["out"], got[:5]):
        assert_same(a, b, k)
    h, viol, last_pos = (int(v) for v in s["scalars"])
    assert got[5:] == (h, bool(viol), last_pos)


def test_postprocess_block_flags_cut_matches():
    """The cases above hold both outcomes of the context check: a window
    that cuts a match, and one whose context holds every match."""
    assert int(_jax_block("identical", 0.5, 4, 0.5)["scalars"][1]) == 1
    assert int(_jax_block("sepdense", 0.3, 16, 0.3)["scalars"][1]) == 0


@pytest.mark.parametrize("starts", [
    [0, 0, 5, 5, 900, 4000, 7505],        # retries re-enter the same start
    [0, 3000, 100, 100, 6000],            # a smaller start restarts
    [7506, 1, 2, 3]])
def test_sep_counter_matches_cumsum(starts):
    _, sx = case_collection(CASES[0])
    before = np.concatenate([[0], np.cumsum(sx == SEPARATOR)])
    counter = TD._SepCounter(sx)
    assert [counter.before(b0) for b0 in starts] == \
        [int(before[b0]) for b0 in starts]


def _count_joint_sorts(monkeypatch) -> dict:
    calls = {"n": 0}
    orig = TD.joint_suffix_array

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(TD, "joint_suffix_array", spy)
    return calls


def _assert_host_heads(want, got):
    """A DeviceHeadsResult against the JAX DenseHeadsResult (host arrays
    of h heads, int64 positions, n-long reference index)."""
    assert (got.h, got.sn, got.irreducible) == \
        (want.h, want.sn, want.irreducible)
    for f in HEAD_FIELDS:
        a = getattr(want, f)
        k = got.h if f.startswith("head_") else got.n
        assert_same(a, getattr(got, f)[:k].numpy().astype(a.dtype), f)


@pytest.mark.parametrize("cid", ["snp2", "identical", "nrun"])
def test_checkpointed_blocked_matches_jax(cid, tmp_path, monkeypatch,
                                          capfd):
    """Saved blocks, a rerun that loads them all, a rerun after one
    block's file was deleted, and a rerun over the JAX package's files."""
    x, sx = _collection(cid)
    block, ctx, fp = -(-len(sx) // 3), len(sx), "fingerprint"
    want = MD.ms_dense_heads_blocked(
        x, sx, block_chars=block, ctx_chars=ctx,
        checkpoint_dir=str(tmp_path / "jax"), fingerprint=fp)
    run = lambda d: TD.ms_dense_heads_blocked_on_device(
        x, sx, "cpu", block, ctx,
        TD.BlockCheckpoints(str(tmp_path / d), fp, block))
    calls = _count_joint_sorts(monkeypatch)
    capfd.readouterr()
    first = run("port")
    assert RETRY not in capfd.readouterr().err   # one sort per block
    assert calls["n"] == 3
    _assert_host_heads(want, first)
    _assert_heads(TD.ms_dense_heads_blocked_on_device(x, sx, "cpu", block,
                                                      ctx), first)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert len(files) == 3

    all_fields = HEAD_FIELDS + ("h", "n", "sn", "irreducible")
    calls["n"] = 0
    _assert_heads(first, run("port"), all_fields)
    assert calls["n"] == 0

    (tmp_path / "port" / files[1]).unlink()
    _assert_heads(first, run("port"), all_fields)
    assert calls["n"] == 1
    assert sorted(os.listdir(tmp_path / "port")) == files

    calls["n"] = 0
    _assert_heads(first, run("jax"), all_fields)
    assert calls["n"] == 0


@pytest.mark.parametrize("cid", CIDS)
def test_one_block_checkpointed_matches_jax_ms_dense_heads(cid, tmp_path):
    """--checkpoint-dir without blocks: the whole collection as one block
    with no context, saved, is the JAX unblocked ms_dense_heads and the
    port's unblocked scan field for field."""
    x, sx = _collection(cid)
    sn = len(sx)
    got = TD.ms_dense_heads_blocked_on_device(
        x, sx, "cpu", sn, 0, TD.BlockCheckpoints(str(tmp_path), "fp", sn))
    _assert_host_heads(MD.ms_dense_heads(x, sx), got)
    want = TD.ms_dense_heads_on_device(x, sx, "cpu")
    _assert_heads(want, got, HEAD_FIELDS + ("h", "n", "sn", "irreducible"))
    assert len(os.listdir(tmp_path)) == 1


@pytest.mark.parametrize("rle_quirk", [False, True])
@pytest.mark.parametrize("cid", ["snp2", "dupdocs", "sepdense", "nrun"])
def test_merge_of_loaded_blocks_matches_jax(cid, rle_quirk, tmp_path,
                                            monkeypatch):
    """Blocks saved by the JAX package, loaded by the port (no joint sort)
    and merged on the device: JAX's merge_heads_numpy of its own blocked
    heads, counter included."""
    x, sx = _collection(cid)
    block = -(-len(sx) // 2)
    r = MD.ms_dense_heads_blocked(x, sx, block_chars=block, ctx_chars=64,
                                  checkpoint_dir=str(tmp_path),
                                  fingerprint="f")
    d = int((sx == SEPARATOR).sum()) + 1
    want = JM.merge_heads_numpy(
        r.head_t, r.head_pos, r.head_len, r.head_smaller, r.head_char,
        r.ref_sa, r.ref_isa, r.ref_bwt, r.h, len(x), r.sn, d, rle_quirk,
        want_counter=True)
    calls = _count_joint_sorts(monkeypatch)
    heads = TD.ms_dense_heads_blocked_on_device(
        x, sx, "cpu", block, 64, TD.BlockCheckpoints(str(tmp_path), "f",
                                                      block))
    assert calls["n"] == 0
    run_len, run_char, counter = TM.merge_heads_device_resident(
        heads, d, rle_quirk, want_counter=True)
    got = (*TM.download_runs(run_len, run_char), counter)
    for name, a, b in zip(("run_len", "run_char", "counter"), want, got):
        assert_same(a, b, name)
