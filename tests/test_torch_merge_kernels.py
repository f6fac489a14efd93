"""The device merge's kernel functions in their plain versions, on the
CPU, against the JAX programs they port (on the card each is a CUDA kernel:
cmsbwt_tpu_torch/kernels/csrc/{running_fill,tail_good_join,
tail_exact_credit,run_merge}.cu (bucket_sums and run_merge in the last),
held to these plain versions by chip_smoke.py):

* ops/fill.running_fill against jax.lax.cummax / cummin and the JAX
  merge's _rev_fill_min;
* engine/device_merge's _tail_good_join_reference,
  _exact_credit_reference, _bucket_sums_reference and
  _run_merge_reference against JAX's tail_good_dev, tail_exact_dev and
  runs_emit_dev end to end on tests/torch_cases.CASES, and on built join
  rows and lanes against the JAX passes they port (tail_good_dev after
  its join sort, tail_exact_dev after its join's fill, runs_emit_dev's
  three accumulating scatters and its pass after its lane sort), run here
  as written in cmsbwt_tpu/engine/device_merge.py; the bucket sums also
  against a numpy np.add.at oracle, and the order the bucket_sums kernel
  relies on (bucket_rank never falls over the valid lanes) on every
  CASES input.

Tolerance: exact (integers and bytes), dtypes included."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_cases import CASE_IDS, CASES, assert_same, carry_heads, \
    case_collection
from cmsbwt_tpu.engine import device_merge as jm
from cmsbwt_tpu.ops.ms_jump import ms_jump_heads
from cmsbwt_tpu_torch import kernels
from cmsbwt_tpu_torch.engine import device_merge as tm
from cmsbwt_tpu_torch.ops import fill
from cmsbwt_tpu_torch.utils.buckets import bucket_size

torch.set_num_threads(1)

INT_MAX = 2**31 - 1
FILL_BIG = (1 << 62) - 1
FILL_SIZES = [1, 4095, 4096, 4097, 3 * 4096 + 5]


# ---------------------------------------------------------------------------
# running_fill
# ---------------------------------------------------------------------------

def _fill_values(m: int, dtype, seed: int) -> np.ndarray:
    """A random walk (the fill changes in both directions) with the
    dtype's extremes and the merge's sentinels (INT_MAX, FILL_BIG in int64,
    -1) at a few rows."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    v = np.cumsum(rng.integers(-3, 4, m)).astype(dtype)
    special = [info.min, info.max, -1, INT_MAX] + (
        [FILL_BIG] if dtype == np.int64 else [])
    at = rng.integers(0, m, len(special))
    v[at] = np.array(special, dtype)
    return v


def _jax_fill(v: np.ndarray, op: str, reverse: bool):
    with jax.enable_x64(True):
        x = jnp.asarray(v)
        if op == "min":
            out = jm._rev_fill_min(x) if reverse else jax.lax.cummin(x)
        else:
            out = jax.lax.cummax(x, reverse=reverse)
        return np.asarray(out)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("m", FILL_SIZES)
def test_running_fill_matches_jax(m, dtype, op, reverse):
    v = _fill_values(m, dtype, m)
    got = fill.running_fill(torch.from_numpy(v), op, reverse)
    assert_same(_jax_fill(v, op, reverse), got, f"fill {op} {reverse}")


@settings(max_examples=40, deadline=None)
@given(data=st.data(), op=st.sampled_from(["max", "min"]),
       reverse=st.booleans(), dtype=st.sampled_from([np.int32, np.int64]))
def test_running_fill_matches_jax_hypothesis(data, op, reverse, dtype):
    info = np.iinfo(dtype)
    vals = data.draw(st.lists(st.integers(int(info.min), int(info.max)),
                              min_size=1, max_size=64))
    v = np.array(vals, dtype)
    got = fill.running_fill(torch.from_numpy(v), op, reverse)
    assert_same(_jax_fill(v, op, reverse), got, f"fill {op} {reverse}")


# ---------------------------------------------------------------------------
# the JAX passes the two fused kernels port, as written in
# cmsbwt_tpu/engine/device_merge.py
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("h_pad",))
def _jax_join_pass(k1s, k2fs, i_s, pay_s, h_pad: int):
    """tail_good_dev after its join sort (device_merge.py:441-488) on the
    sorted rows; returns (counter, n_exact, exact_members, exact key,
    f_cls). Call under jax.enable_x64(True)."""
    f_s = (k2fs & 1).astype(jnp.int32)
    k2s = k2fs >> 1
    slot_s = size_s = pay_s
    jn_pad = k1s.shape[0]
    rowsi = jnp.arange(jn_pad, dtype=jnp.int32)
    rows = rowsi.astype(jnp.int64)
    fill_big = jnp.int64(FILL_BIG)
    low31 = (jnp.int64(1) << 31) - 1

    def rev_fill(payload31):
        packed = jnp.where(f_s == 1, (rows << 31)
                           | payload31.astype(jnp.int64), fill_big)
        return jax.lax.cummin(packed[::-1])[::-1]

    fp = rev_fill(k1s)
    f_pos = (fp & low31).astype(jnp.int32)
    t_row = (fp >> 31).astype(jnp.int32)
    f_cls = (rev_fill(i_s) & low31).astype(jnp.int32)
    change_next = jnp.concatenate(
        [(k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1]),
         jnp.ones(1, dtype=bool)])
    run_end = jm._rev_fill_min(jnp.where(change_next, rowsi,
                                         jnp.int32(jn_pad)))
    is_q = f_s == 0
    in_range_s = is_q & (f_pos == k1s) & (k1s < jm.INT_MAX)
    exact_s = in_range_s & (t_row <= run_end)
    good_s = in_range_s & ~exact_s
    gcum = jnp.cumsum(jnp.where(good_s, size_s, 0).astype(jnp.int64))
    prev_t = jnp.concatenate(
        [jnp.full(1, -1, jnp.int64),
         jax.lax.cummax(jnp.where(f_s == 1, rows, jnp.int64(-1)))[:-1]])
    pt = jnp.clip(prev_t, 0, jn_pad - 1).astype(jnp.int32)
    base_cum = jnp.where(prev_t >= 0, gcum[pt], 0)
    credit = (gcum - base_cum).astype(jnp.int32)
    is_t = f_s == 1
    counter = jnp.zeros(h_pad + 2, jnp.int32).at[
        jnp.where(is_t, slot_s, h_pad + 1)].add(
        jnp.where(is_t, credit, 0), mode="drop")
    n_exact = jnp.sum(exact_s.astype(jnp.int32)).astype(jnp.int32)
    exact_members = jnp.sum(jnp.where(exact_s, size_s, 0)
                            .astype(jnp.int64))
    return (counter, n_exact, exact_members,
            jnp.where(exact_s, i_s, jm.INT_MAX), f_cls)


@functools.partial(jax.jit, static_argnames=("h_pad",))
def _jax_exact_pass(counter_in, f_s, i_s, dst, tot, cls_of_slot, slot_base,
                    cls_hi, bucket_of_class, h_pad: int):
    """tail_exact_dev from its join's fill on (device_merge.py:543-559),
    on the sorted join's flags and ids; returns counter_in plus the
    credits."""
    em_pad = dst.shape[0]
    mvalid = jnp.arange(em_pad, dtype=jnp.int32) < tot
    tgt = jm._rev_fill_min(jnp.where(f_s == 1, i_s, jnp.int32(h_pad)))
    qk2 = jnp.where(f_s == 0, i_s, jm.INT_MAX)
    _, p_slot = jax.lax.sort((qk2, jnp.clip(tgt, 0, h_pad - 1)), num_keys=1)
    p_slot = p_slot[:em_pad]
    inb = mvalid & (cls_of_slot[p_slot] == dst) & \
        (tgt[0] * 0 + 1 > 0)  # keep shape
    counter = jnp.zeros(h_pad + 2, jnp.int32).at[
        jnp.where(inb, p_slot, h_pad + 1)].add(1, mode="drop")
    has_next = (dst + 1) < cls_hi[
        jnp.clip(bucket_of_class[dst], 0, h_pad - 1)]
    spill_ok = mvalid & ~inb & has_next
    counter = counter.at[
        jnp.where(spill_ok, slot_base[jnp.clip(dst + 1, 0, h_pad - 1)],
                  h_pad + 1)].add(1, mode="drop")
    return counter_in + counter


@jax.jit
def _jax_run_merge(k_s, len_s, chr_s):
    """runs_emit_dev after its lane sort (device_merge.py:696-716); returns
    (run_len, run_char uint8, n_runs) with the runs at the front. Call
    under jax.enable_x64(True)."""
    L = k_s.shape[0]
    rowi = jnp.arange(L, dtype=jnp.int32)
    valid_s = (k_s < jm.INT_MAX) & (len_s > 0)
    prv_chr = jnp.concatenate([jnp.full(1, -1, jnp.int32), chr_s[:-1]])
    prv_valid = jnp.concatenate([jnp.zeros(1, bool), valid_s[:-1]])
    nxt_chr = jnp.concatenate([chr_s[1:], jnp.full(1, -1, jnp.int32)])
    nxt_valid = jnp.concatenate([valid_s[1:], jnp.zeros(1, bool)])
    new_g = valid_s & (~prv_valid | (prv_chr != chr_s))
    is_last = valid_s & (~nxt_valid | (nxt_chr != chr_s))
    cum = jnp.cumsum(len_s.astype(jnp.int64))
    exc = cum - len_s
    packedg = jnp.where(
        new_g, (rowi.astype(jnp.int64) << 32) | exc, jnp.int64(-1))
    fe = jax.lax.cummax(packedg) & ((jnp.int64(1) << 32) - 1)
    lenm = jnp.where(is_last, cum - fe, 0).astype(jnp.int32)
    n_groups = jnp.sum(is_last.astype(jnp.int32)).astype(jnp.int32)
    key2 = jnp.where(is_last, rowi, jm.INT_MAX)
    _, rl, rc = jax.lax.sort((key2, lenm, chr_s), num_keys=1)
    return rl, rc.astype(jnp.uint8), n_groups


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _jax_bucket_sums(bucket_rank, bid, m_c, nec, n_pad: int):
    """runs_emit_dev's three accumulating scatters (device_merge.py:596-599,
    668-670) on its class lanes; returns (hb_at, ncls_at, hb_b)."""
    h_pad = bucket_rank.shape[0]
    evalid = jnp.arange(h_pad, dtype=jnp.int32) < nec
    hb_at = jnp.zeros(n_pad, jnp.int32).at[
        jnp.where(evalid, bucket_rank, 0)].add(m_c, mode="drop")
    ncls_at = jnp.zeros(n_pad, jnp.int32).at[
        jnp.where(evalid, bucket_rank, 0)].add(1, mode="drop")
    hb_b = jnp.zeros(h_pad, jnp.int32).at[
        jnp.where(evalid, jnp.clip(bid, 0, h_pad - 1), h_pad - 1)].add(
        m_c, mode="drop")
    return hb_at, ncls_at, hb_b


def _numpy_bucket_sums(bucket_rank, bid, m_c, nec: int, n_pad: int):
    """The same sums by np.add.at: the oracle."""
    h_pad = len(bucket_rank)
    evalid = np.arange(h_pad) < nec
    br0 = np.where(evalid, bucket_rank, 0)
    hb_at = np.zeros(n_pad, np.int32)
    np.add.at(hb_at, br0, m_c)
    ncls_at = np.zeros(n_pad, np.int32)
    np.add.at(ncls_at, br0, 1)
    hb_b = np.zeros(h_pad, np.int32)
    np.add.at(hb_b, np.clip(bid, 0, h_pad - 1)[evalid], m_c[evalid])
    return hb_at, ncls_at, hb_b


def _check_bucket_sums(bucket_rank, bid, m_c, nec: int, n_pad: int):
    """The port's bucket sums (plain, CPU) against np.add.at and JAX's
    scatters on the same lanes; no fault on lanes in order."""
    with jax.enable_x64(False):
        want = [np.asarray(w) for w in _jax_bucket_sums(
            jnp.asarray(bucket_rank), jnp.asarray(bid), jnp.asarray(m_c),
            jnp.int32(nec), n_pad)]
    oracle = _numpy_bucket_sums(bucket_rank, bid, m_c, nec, n_pad)
    calls = tm.REFERENCE_CALLS["_bucket_sums_reference"]
    got = tm.bucket_sums(*(torch.from_numpy(np.ascontiguousarray(a))
                           for a in (bucket_rank, bid, m_c)), nec, n_pad)
    assert tm.REFERENCE_CALLS["_bucket_sums_reference"] == calls + 1
    for k, w, o, g in zip(("hb_at", "ncls_at", "hb_b"), want, oracle, got):
        assert_same(w, g, k)
        np.testing.assert_array_equal(o, g.numpy(), err_msg=k)
    assert got[3].tolist() == [0]
    tm.bucket_sums_check(got[3])
    return got


def _check_join(rows: dict, h_pad: int):
    """The port's join pass (plain, CPU) against JAX's on the same rows."""
    k1s, k2fs, i_s, pay_s = (rows[k] for k in ("k1", "k2f", "i", "pay"))
    with jax.enable_x64(True):
        want = _jax_join_pass(jnp.asarray(k1s), jnp.asarray(k2fs),
                              jnp.asarray(i_s), jnp.asarray(pay_s), h_pad)
        want = [np.asarray(w) for w in want]
    calls = tm.REFERENCE_CALLS["_tail_good_join_reference"]
    got = tm.tail_good_join(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (k1s, k2fs, i_s, pay_s)), h_pad)
    assert tm.REFERENCE_CALLS["_tail_good_join_reference"] == calls + 1
    counter, ekey, f_cls, n_exact, members = got
    assert_same(want[0], counter, "counter")
    assert (int(want[1]), int(want[2])) == (n_exact, members)
    assert_same(want[3], ekey, "exact key")
    assert_same(want[4], f_cls, "f_cls")
    return got


def _check_exact(counter_in, f_s, i_s, tgt, dst, tot, cls_of_slot,
                 slot_base, cls_hi, bucket_of_class, h_pad):
    """The port's exact credit pass (plain, CPU) against JAX's on the same
    join (numpy columns; ``tgt`` as the port's fill gave it)."""
    cols = (counter_in, f_s, i_s, dst, np.int32(tot), cls_of_slot,
            slot_base, cls_hi, bucket_of_class)
    with jax.enable_x64(True):
        want = np.asarray(_jax_exact_pass(*map(jnp.asarray, cols), h_pad))
    calls = tm.REFERENCE_CALLS["_exact_credit_reference"]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        counter_in, f_s, i_s, tgt, dst, cls_of_slot, slot_base, cls_hi,
        bucket_of_class)]
    got = tm.exact_credit(*t[:5], tot, *t[5:], h_pad)
    assert tm.REFERENCE_CALLS["_exact_credit_reference"] == calls + 1
    assert_same(want, got, "exact credit counter")
    return got


def _check_runs(k_s, len_s, chr_s):
    """The port's run merge (plain, CPU) against JAX's on the same lanes."""
    with jax.enable_x64(True):
        rl, rc, n = _jax_run_merge(jnp.asarray(k_s), jnp.asarray(len_s),
                                   jnp.asarray(chr_s))
        n = int(n)
        rl, rc = np.asarray(rl)[:n], np.asarray(rc)[:n]
    calls = tm.REFERENCE_CALLS["_run_merge_reference"]
    got = tm.run_merge(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in (k_s, len_s, chr_s)))
    assert tm.REFERENCE_CALLS["_run_merge_reference"] == calls + 1
    assert got[2] == n
    assert_same(rl, got[0], "run_len")
    assert_same(rc, got[1], "run_char")
    return got


# ---------------------------------------------------------------------------
# end to end on the collections of tests/torch_cases.py
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_heads(case_idx):
    x_aug, sx = case_collection(CASES[case_idx])
    res = ms_jump_heads(x_aug, sx, lanes=4, window=16)
    return res, int((sx == 2).sum()) + 1


@functools.lru_cache(maxsize=None)
def _stages(case_idx):
    """Both packages' merge stages up to the tail pairs, on JAX's heads."""
    r, d = _jax_heads(case_idx)
    p = carry_heads(r)
    h, n = r.h, r.n
    h_pad, n_pad = int(r.head_t.shape[0]), int(r.ref_sa.shape[0])
    i32 = jnp.int32
    a = jm.fixup_dev(r.head_t, r.head_pos, r.head_len, i32(h), r.ref_isa,
                     h_pad)
    b = tm.fixup_dev(p.head_t, p.head_pos, p.head_len, h, p.ref_isa, h_pad)
    tj = jm.tail_counts_dev(r.head_pos, a[0], i32(h), h_pad, n_pad)
    tt = tm.tail_counts_dev(p.head_pos, b[0], h, h_pad, n_pad)
    cj = jm.group_dev(r.head_pos, r.head_len, r.head_smaller, a[0], a[1],
                      i32(h), i32(n), h_pad)
    ct = tm.group_dev(p.head_pos, p.head_len, p.head_smaller, b[0], b[1],
                      h, n, h_pad)
    rj = jm.class_ranks_dev(cj, r.ref_isa, i32(h), i32(d), i32(n), h_pad)
    rt = tm.class_ranks_dev(ct, p.ref_isa, h, d, n, h_pad)
    cj["cls_of_slot"], ct["cls_of_slot"] = rj[2], rt[2]
    hj = jm.head_string_sa_dev(rj[0], i32(h), h_pad)
    ht = tm.head_string_sa_dev(rt[0], h, h_pad)
    kj = jm.rank_heads_dev(cj, hj, r.head_char, a[2], i32(h), h_pad)
    kt = tm.rank_heads_dev(ct, ht, p.head_char, b[2], h, h_pad)
    pj = jm.tail_pairs_count_dev(cj, h_pad)
    pt = tm.tail_pairs_count_dev(ct, h_pad)
    total = pt["total"]
    pj["total"] = i32(total)
    return dict(r=r, p=p, d=d, h=h, n=n, h_pad=h_pad, n_pad=n_pad,
                tails=(tj, tt), cls=(cj, ct), ranks=(rj, rt),
                heads=(kj, kt), pairs=(pj, pt),
                p_pad=bucket_size(total + 1))


class _Spy:
    """Records the inputs of the port's tail_good_join, exact_credit,
    bucket_sums and run_merge."""

    def __init__(self, monkeypatch):
        self.join, self.exact, self.runs, self.sums = [], [], [], []
        join, exact, runs = tm.tail_good_join, tm.exact_credit, tm.run_merge
        sums = tm.bucket_sums

        def spy_sums(*a):
            self.sums.append(a)
            return sums(*a)

        def spy_join(*a):
            self.join.append(a)
            return join(*a)

        def spy_exact(*a):
            self.exact.append(a)
            return exact(*a)

        def spy_runs(*a):
            self.runs.append(a)
            return runs(*a)
        monkeypatch.setattr(tm, "tail_good_join", spy_join)
        monkeypatch.setattr(tm, "exact_credit", spy_exact)
        monkeypatch.setattr(tm, "run_merge", spy_runs)
        monkeypatch.setattr(tm, "bucket_sums", spy_sums)


@pytest.mark.parametrize("rle_quirk", [False, True])
@pytest.mark.parametrize("case_idx", range(len(CASES)), ids=CASE_IDS)
def test_tail_good_and_runs_emit_match_jax(case_idx, rle_quirk,
                                           monkeypatch):
    """tail_good_dev, tail_exact_dev and runs_emit_dev, through the plain
    join pass, exact credit and run merge, against JAX's: every output,
    dtypes included; the captured joins and lanes also equal JAX's passes
    run on them."""
    s = _stages(case_idx)
    spy = _Spy(monkeypatch)
    cj, ct = s["cls"]
    pj, pt = s["pairs"]
    (rj, rt), (kj, kt) = s["ranks"], s["heads"]
    h, n, h_pad, n_pad, d = s["h"], s["n"], s["h_pad"], s["n_pad"], s["d"]
    i32 = jnp.int32
    calls = dict(tm.REFERENCE_CALLS)
    gj = jm.tail_good_dev(cj, pj, cj["member_off"], i32(h), i32(n), h_pad,
                          s["p_pad"])
    gt = tm.tail_good_dev(ct, pt, ct["member_off"], h, n, h_pad,
                          s["p_pad"])
    assert (int(gj[1]), int(gj[2])) == (gt[1], gt[2])
    for k, x, y in zip(("counter", "e_pidx", "e_fnd", "src_cls"),
                       (gj[0],) + gj[3:], (gt[0],) + gt[3:]):
        assert_same(x, y, "tail_good." + k)
    counter_j, counter_t = gj[0], gt[0]
    if gt[1]:
        e_pad, em_pad = bucket_size(gt[1]), bucket_size(gt[2])
        counter_j = jm.tail_exact_dev(
            gj[0], cj, pj, cj["member_off"], kj[3], rj[2], gj[3], gj[4],
            gj[5], i32(gt[1]), i32(h), h_pad, e_pad, em_pad)
        counter_t = tm.tail_exact_dev(
            gt[0], ct, pt, ct["member_off"], kt[3], rt[2], gt[3], gt[4],
            gt[5], gt[1], h, h_pad, e_pad, em_pad)
        assert_same(counter_j, counter_t, "tail_exact.counter")
    r, p = s["r"], s["p"]
    ej = jm.runs_emit_dev(cj, rj[1], cj["member_off"], counter_j,
                          s["tails"][0], kj[1], r.ref_sa, r.ref_isa,
                          r.ref_bwt, i32(d), i32(n), h_pad, n_pad,
                          rle_quirk)
    et = tm.runs_emit_dev(ct, rt[1], ct["member_off"], counter_t,
                          s["tails"][1], kt[1], p.ref_sa, p.ref_isa,
                          p.ref_bwt, d, n, h_pad, n_pad, rle_quirk)
    runs = int(ej[4][0])
    assert et[2] == runs
    assert_same(np.asarray(ej[2])[:runs], et[0], "run_len")
    assert_same(np.asarray(ej[3])[:runs], et[1], "run_char")
    assert tm.REFERENCE_CALLS["_tail_good_join_reference"] \
        == calls["_tail_good_join_reference"] + 1
    assert tm.REFERENCE_CALLS["_run_merge_reference"] \
        == calls["_run_merge_reference"] + 1
    assert tm.REFERENCE_CALLS["_exact_credit_reference"] \
        == calls["_exact_credit_reference"] + bool(gt[1])
    assert tm.REFERENCE_CALLS["_bucket_sums_reference"] \
        == calls["_bucket_sums_reference"] + 1
    # the same rows and lanes through JAX's passes as written there
    k1s, k2fs, i_s, pay_s, hp = spy.join[0]
    _check_join(dict(k1=k1s.numpy(), k2f=k2fs.numpy(), i=i_s.numpy(),
                     pay=pay_s.numpy()), hp)
    _check_runs(*(a.numpy() for a in spy.runs[0]))
    br, bid, m_c, nec, n_pad_s = spy.sums[0]
    _check_bucket_sums(br.numpy(), bid.numpy(), m_c.numpy(), nec, n_pad_s)
    for a in list(spy.exact):   # the check's own call is recorded too
        _check_exact(*(x.numpy() if torch.is_tensor(x) else x for x in a))


# ---------------------------------------------------------------------------
# built join rows and lanes
# ---------------------------------------------------------------------------

def _join_rows(rows, pad: int = 0) -> dict:
    """Join rows from (k1, k2, is_target, i, pay) tuples, sorted by (k1,
    k2f) as the join's sort leaves them, with ``pad`` pad rows (k1 =
    INT_MAX, k2f = 2^62, a query) at the end."""
    rows = list(rows) + [(INT_MAX, 1 << 61, False, 10_000 + j, 0)
                         for j in range(pad)]
    k1 = np.array([r[0] for r in rows], np.int32)
    k2f = np.array([(r[1] << 1) | int(r[2]) for r in rows], np.int64)
    order = np.lexsort((k2f, k1))
    return dict(k1=k1[order], k2f=k2f[order],
                i=np.array([r[3] for r in rows], np.int32)[order],
                pay=np.array([r[4] for r in rows], np.int32)[order])


def _random_rows(seed: int, n_rows: int, h_pad: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n_rows):
        target = bool(rng.random() < 0.3)
        out.append((int(rng.integers(0, 6)), int(rng.integers(0, 8)), target,
                    j, int(rng.integers(0, h_pad + 4)) if target
                    else int(rng.integers(0, 50))))
    return out


BUILT_JOINS = {
    # bucket 3's last queries and bucket 9 (queries only) have no target at
    # or after them in their bucket; the pads have none at all
    "no_target_after": (_join_rows(
        [(1, 4, True, 0, 2), (1, 2, False, 1, 5), (3, 1, False, 2, 7),
         (3, 2, True, 3, 4), (3, 6, False, 4, 9), (3, 7, False, 5, 1),
         (9, 0, False, 6, 3), (9, 5, False, 7, 2)], pad=3), 8),
    # bucket 5: good queries (k2 2, 3) before a run of three queries tied
    # with two equal targets (k2 5: exact), then a good query for the
    # target at k2 9
    "exact_and_good_ties": (_join_rows(
        [(5, 2, False, 0, 3), (5, 3, False, 1, 4), (5, 5, False, 2, 1),
         (5, 5, False, 3, 6), (5, 5, False, 4, 2), (5, 5, True, 5, 1),
         (5, 5, True, 6, 3), (5, 7, False, 7, 8), (5, 9, True, 8, 5),
         (6, 1, True, 9, 0)], pad=2), 8),
    # no pads: the last (k1, k2) run, queries and their target, ends at
    # the last row
    "run_ends_at_last_row": (_join_rows(
        [(2, 1, False, 0, 4), (2, 3, True, 1, 2), (4, 6, False, 2, 5),
         (4, 6, False, 3, 7), (4, 6, True, 4, 6)]), 8),
    # a credit slot past counter's h_pad + 2 is dropped
    "slot_out_of_range": (_join_rows(
        [(1, 1, False, 0, 4), (1, 2, True, 1, 11), (1, 3, False, 2, 9),
         (1, 5, True, 3, 3)], pad=1), 8),
    "random_a": (_join_rows(_random_rows(1, 300, 40), pad=20), 40),
    "random_b": (_join_rows(_random_rows(2, 5000, 600), pad=123), 600),
}


@pytest.mark.parametrize("name", list(BUILT_JOINS))
def test_join_pass_built_cases(name):
    rows, h_pad = BUILT_JOINS[name]
    counter, ekey, f_cls, n_exact, members = _check_join(rows, h_pad)
    if name == "exact_and_good_ties":
        assert n_exact == 3 and members == 9
        assert int(counter[1]) == 7 and int(counter[5]) == 8


def _exact_join(seed: int, h_pad: int, em_pad: int, tot: int):
    """A built exact-path join: h_pad target slots and em_pad queries in a
    random sorted order, the fill of the targets' slots, random classes
    (cls_of_slot non-decreasing), buckets and base slots (some past the
    counter, which drops them)."""
    rng = np.random.default_rng(seed)
    flag = np.concatenate([np.ones(h_pad, np.int32),
                           np.zeros(em_pad, np.int32)])
    ids = np.concatenate([np.arange(h_pad), np.arange(em_pad)]).astype(
        np.int32)
    order = rng.permutation(h_pad + em_pad)
    f_s, i_s = flag[order], ids[order]
    tgt = np.minimum.accumulate(np.where(f_s == 1, i_s, h_pad)[::-1])[::-1]
    n_cls = max(1, h_pad // 3)
    cls_of_slot = np.sort(rng.integers(0, n_cls, h_pad)).astype(np.int32)
    return dict(
        counter_in=rng.integers(-5, 5, h_pad + 2).astype(np.int32),
        f_s=f_s, i_s=i_s, tgt=tgt.astype(np.int32),
        dst=rng.integers(0, n_cls, em_pad).astype(np.int32), tot=tot,
        cls_of_slot=cls_of_slot,
        slot_base=rng.integers(0, h_pad + 4, h_pad).astype(np.int32),
        cls_hi=rng.integers(0, n_cls + 2, h_pad).astype(np.int32),
        bucket_of_class=rng.integers(-1, h_pad + 1, h_pad).astype(np.int32),
        h_pad=h_pad)


BUILT_EXACT = {
    "every_query_valid": _exact_join(1, 16, 40, 40),
    "pad_queries": _exact_join(2, 16, 64, 37),
    "one_slot": _exact_join(3, 1, 9, 9),
    "large": _exact_join(4, 3000, 9000, 8123),
}


@pytest.mark.parametrize("name", list(BUILT_EXACT))
def test_exact_credit_built_cases(name):
    _check_exact(**BUILT_EXACT[name])


def _lanes(chars, lens, tail: int = 0):
    """Lanes sorted by offset (k = 0, 1, ...), then ``tail`` invalid lanes
    (k = INT_MAX, len 0) as the merge's sort leaves them."""
    m = len(chars)
    k = np.concatenate([np.arange(m), np.full(tail, INT_MAX)]).astype(
        np.int32)
    ln = np.concatenate([np.asarray(lens), np.zeros(tail)]).astype(np.int32)
    ch = np.concatenate([np.asarray(chars), np.full(tail, 7)]).astype(
        np.int32)
    return k, ln, ch


_rng = np.random.default_rng(5)
BUILT_LANES = {
    "one_char": _lanes([65] * 40, np.arange(1, 41), tail=5),
    "alternating": _lanes([65, 67] * 20, np.full(40, 3), tail=3),
    # zero-length lanes between lanes of one char split their run
    "zero_length_between_equal": _lanes(
        [71, 71, 71, 71, 71, 84, 84, 84], [2, 0, 5, 0, 0, 1, 0, 4], tail=2),
    "single_lane": _lanes([0], [9]),
    "no_valid_lane": _lanes([], [], tail=4),
    "random": _lanes(_rng.choice([0, 1, 65, 67, 71, 84, 300], 3000),
                     _rng.integers(0, 4, 3000), tail=200),
}


@pytest.mark.parametrize("name", list(BUILT_LANES))
def test_run_merge_built_cases(name):
    run_len, run_char, n = _check_runs(*BUILT_LANES[name])
    if name == "one_char":
        assert n == 1 and int(run_len[0]) == 820
    if name == "zero_length_between_equal":
        assert run_len.tolist() == [2, 5, 1, 4]


@pytest.mark.parametrize("case_idx", range(len(CASES)), ids=CASE_IDS)
def test_bucket_rank_never_falls(case_idx):
    """The order the bucket_sums kernel relies on, on every CASES input:
    over runs_emit_dev's valid class lanes (SA-walk order) bucket_rank
    never decreases, so each bucket is one segment of lanes; m_c is 0 on
    the pad lanes; the plain version flags no fault."""
    s = _stages(case_idx)
    ct, (_, rt), p = s["cls"][1], s["ranks"], s["p"]
    nec, evalid, _, m_c, br, new_b, bid = tm.bucket_lanes(
        ct, rt[1], p.ref_isa, s["h_pad"], s["n_pad"])
    assert nec >= 1
    v = br[:nec]
    assert bool((v[1:] >= v[:-1]).all())
    assert bool((v >= 0).all()) and bool((v < s["n_pad"]).all())
    assert int(m_c[nec:].abs().sum()) == 0
    # one segment per bucket: bid counts the rank changes
    assert int(bid[nec - 1]) + 1 == int(torch.unique(v).numel())
    fault = tm._bucket_sums_reference(br, bid, m_c, nec, s["n_pad"])[3]
    assert fault.tolist() == [0]


def _bucket_lanes(sizes, pads: int, n_pad: int, rank0: bool = False,
                  seed: int = 0):
    """Class lanes as runs_emit_dev builds them: buckets of the given
    sizes in rising rank order (the first of rank 0 when ``rank0``), then
    ``pads`` pad lanes (bucket_rank INT_MAX, m_c 0); bid = the bucket's
    index (cumsum of the starts - 1, so -1 everywhere when no lane is
    valid). Returns (bucket_rank, bid, m_c, nec, n_pad)."""
    rng = np.random.default_rng(seed)
    nec = int(sum(sizes))
    ranks = np.sort(rng.choice(np.arange(1, n_pad), len(sizes),
                               replace=False))
    if rank0 and len(sizes):
        ranks[0] = 0
    h_pad = nec + pads
    br = np.full(h_pad, INT_MAX, np.int32)
    br[:nec] = np.repeat(ranks, sizes)
    starts = np.zeros(h_pad, np.int32)
    starts[np.cumsum([0] + list(sizes[:-1])).astype(int)[:len(sizes)]] = 1
    bid = (np.cumsum(starts) - 1).astype(np.int32)
    m_c = np.zeros(h_pad, np.int32)
    m_c[:nec] = rng.integers(0, 9, nec)
    return br, bid, m_c, nec, n_pad


BUILT_BUCKETS = {
    "one_bucket": _bucket_lanes([700], 9, 50),
    "own_buckets": _bucket_lanes([1] * 300, 5, 400),
    "straddle_2047": _bucket_lanes([5, 2047, 2047, 9], 3, 60),
    "straddle_2048": _bucket_lanes([5, 2048, 2048, 1], 2048, 60),
    "straddle_2049": _bucket_lanes([2049, 2049, 3], 1, 60, rank0=True),
    "straddle_3x2048_5": _bucket_lanes([7, 3 * 2048 + 5, 2], 11, 60),
    "nec_0": _bucket_lanes([], 8, 20),
    "nec_1": _bucket_lanes([1], 4, 20),
    "rank0": _bucket_lanes([3, 5, 2], 6, 20, rank0=True),
    "rank0_one_lane": _bucket_lanes([1], 2, 20, rank0=True),
    "pad_only": _bucket_lanes([], 2049, 20)[:3] + (-1, 20),
    "no_pad_lanes": _bucket_lanes([4, 4], 0, 20),
    "random": _bucket_lanes(list(np.random.default_rng(7).integers(
        1, 30, 400)), 333, 1000, rank0=True, seed=7),
}


@pytest.mark.parametrize("name", list(BUILT_BUCKETS))
def test_bucket_sums_built_cases(name):
    br, bid, m_c, nec, n_pad = BUILT_BUCKETS[name]
    hb_at, ncls_at, hb_b, _ = _check_bucket_sums(br, bid, m_c, nec, n_pad)
    pads = len(br) - max(nec, 0)
    rank0 = int((br[:max(nec, 0)] == 0).sum())
    assert int(ncls_at[0]) == pads + rank0
    if name == "one_bucket":
        assert int(hb_b[0]) == int(m_c.sum()) == int(hb_at[br[0]])
        assert int(ncls_at[br[0]]) == 700


def test_bucket_sums_fault():
    """A valid lane whose bucket_rank falls below its predecessor's sets
    bit 0 of the plain version's fault word (and bit 2: the stray lane
    splits its bucket, so the bids no longer count the segments), and the
    check raises; the sums themselves are still the scatters'."""
    br, bid, m_c, nec, n_pad = _bucket_lanes([4, 6, 3], 5, 40, seed=2)
    br = br.copy()
    br[5] = br[0] - 1
    got = tm.bucket_sums(*(torch.from_numpy(a) for a in (br, bid, m_c)),
                         nec, n_pad)
    assert got[3].tolist() == [1 | 4]
    for k, o, g in zip(("hb_at", "ncls_at", "hb_b"),
                       _numpy_bucket_sums(br, bid, m_c, nec, n_pad), got):
        np.testing.assert_array_equal(o, g.numpy(), err_msg=k)
    with pytest.raises(RuntimeError, match="below its predecessor"):
        tm.bucket_sums_check(got[3])


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_dispatch_by_device():
    """CPU tensors take the plain versions (counted in REFERENCE_CALLS);
    the CUDA wrappers take only CUDA tensors and raise otherwise; a tensor
    on another device raises; asking for the card without one raises."""
    v = torch.arange(10, dtype=torch.int64)
    calls = fill.REFERENCE_CALLS["running_fill_reference"]
    assert fill.running_fill(v, "min", reverse=True).tolist() == list(
        range(10))
    assert fill.REFERENCE_CALLS["running_fill_reference"] == calls + 1
    with pytest.raises(ValueError, match="op must be"):
        fill.running_fill(v, "sum")
    i32 = torch.zeros(4, dtype=torch.int32)
    launches = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="cuda"):
        kernels.running_fill_cuda(v)
    with pytest.raises(ValueError, match="cuda"):
        kernels.tail_good_join_cuda(i32, v[:4], i32, i32, 2)
    with pytest.raises(ValueError, match="cuda"):
        kernels.run_merge_cuda(i32, i32, i32)
    with pytest.raises(ValueError, match="cuda"):
        kernels.bucket_sums_cuda(i32, i32, i32, 2, 8)
    with pytest.raises(ValueError, match="cuda"):
        kernels.tail_exact_credit_cuda(torch.zeros(4, dtype=torch.int32),
                                       i32, i32, i32, i32, 4, i32, i32, i32,
                                       i32, 2)
    assert kernels.LAUNCHES == launches
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fill.running_fill(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tm.tail_good_join(meta, meta.to(torch.int64), meta, meta, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tm.run_merge(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tm.bucket_sums(meta, meta, meta, 2, 8)
    calls = tm.REFERENCE_CALLS["_bucket_sums_reference"]
    tm.bucket_sums(i32, i32, i32, 0, 8)
    assert tm.REFERENCE_CALLS["_bucket_sums_reference"] == calls + 1
    with pytest.raises(ValueError, match="unsupported device"):
        tm.exact_credit(meta, meta, meta, meta, meta, 4, meta, meta, meta,
                        meta, 2)
    if torch.cuda.is_available():
        # on a card the wrapper launches the kernel, never the plain form
        calls = fill.REFERENCE_CALLS["running_fill_reference"]
        out = fill.running_fill(v.cuda(), "max")
        assert out.cpu().tolist() == list(range(10))
        assert kernels.LAUNCHES["running_fill"] == \
            launches["running_fill"] + 1
        assert fill.REFERENCE_CALLS["running_fill_reference"] == calls
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            fill.running_fill(v.to("cuda"))
