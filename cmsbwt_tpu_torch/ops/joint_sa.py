"""Seeded prefix-doubling suffix sort of the joint (reference ++ collection)
string — the counterpart of cmsbwt_tpu/ops/joint_sa.py, function by
function (see that module for the algorithm: a byte-8 or 4-bit 32-symbol
seed, quadrupling rounds that recover two rank levels from one order,
compacted late rounds, split levels that bound each adjacent lcp).

Where the JAX code needs a form torch lacks:

* ``lax.sort`` over several keys becomes stable ``torch.sort`` passes,
  least significant key first (``_sort_rows``); ties keep index order, as
  the stable ``lax.sort`` does.
* Sorts that only apply a permutation (the inversion sorts) become a
  scatter with unique indices.
* ``cummax(where(flag, idx, -1))`` (the last flagged index at or before
  each position) and the reverse ``cummin`` of the seeds (the first
  flagged index at or after) come from ``torch.cumsum`` of the flag and a
  gather (``_flag_fill``): torch's 1-D ``cummax`` runs in one block on a
  CUDA card, ``cumsum`` does not.
* The ``lax.scan`` over rounds with its ``lax.switch`` is a Python loop
  that reads the unresolved count once per round.
* uint64 packs are int64 bit patterns (``<<`` wraps, ``>>`` is
  arithmetic; every unpack masks, so the sign never leaks).

``lift_pairs`` is the plain twin of the CUDA kernel ``lcp_lift``
(kernels/csrc/lcp_lift.cu); ``lcp_lift`` picks between them by the device
of its tensors.
"""
from __future__ import annotations

import torch

from ..index.device import n_levels

SEED_LEVEL = 3        # byte seed resolves windows of 2^3 = 8 bytes
WIDE_SEED_LEVEL = 5   # 4-bit coarse-code seed resolves 2^5 = 32 symbols
INT32_MAX = 2**31 - 1
I32, I64 = torch.int32, torch.int64
BIG = 1 << 62
SIGN = -(1 << 63)     # int64 bit pattern of uint64 1 << 63

# calls of the plain lift (the CUDA wrapper keeps its own launch count)
REFERENCE_CALLS = {"lift_pairs": 0}


def seed_level_of(packs) -> int:
    """The seed window level is carried by the pack layout: one int64 row
    = byte-8 seed, two rows = 4-bit 32-symbol seed."""
    return SEED_LEVEL if packs.shape[0] == 1 else WIDE_SEED_LEVEL


def _flag_fill(flag: torch.Tensor):
    """(last, first): per position i, the last flagged index <= i (-1 if
    none) and the first flagged index >= i (len if none), int64. Exact:
    the k-th flag's index is scattered to slot k of a table read at the
    inclusive (resp. exclusive) flag count."""
    m = flag.shape[0]
    c = torch.cumsum(flag, 0)
    table = torch.full((m + 3,), m, dtype=I64, device=flag.device)
    table[0] = -1
    # every flagged i has its own count c[i] >= 1; the rest go to the
    # dump slot m + 2, which is never read
    table.scatter_(0, torch.where(flag, c, m + 2),
                   torch.arange(m, dtype=I64, device=flag.device))
    return table[c], table[c - flag.to(I64) + 1]


def _sort_rows(*keys: torch.Tensor):
    """Stable sort of rows by several keys, most significant first (a
    stable ``lax.sort`` with num_keys=len(keys)); returns (order int64,
    the other keys in sorted order, the first key sorted)."""
    s, order = torch.sort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        s, o = torch.sort(k[order], stable=True)
        order = order[o]
    return order, [k[order] for k in keys[1:]], s


def _changes(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """Row r starts a new group: r == 0 or any key differs from row r-1."""
    ch = torch.zeros(sorted_keys[0].shape[0], dtype=torch.bool,
                     device=sorted_keys[0].device)
    ch[0] = True
    for k in sorted_keys:
        ch[1:] |= k[1:] != k[:-1]
    return ch


def _next_is(flag: torch.Tensor) -> torch.Tensor:
    """flag shifted left by one, True past the end (group end markers)."""
    out = torch.ones_like(flag)
    out[:-1] = flag[1:]
    return out


def _invert(order: torch.Tensor, *vals: torch.Tensor):
    """Scatter values given in sorted order back to text order (the
    inversion sorts of the JAX code: ``order`` is a permutation)."""
    outs = []
    for v in vals:
        o = torch.empty_like(v)
        o[order] = v
        outs.append(o)
    return outs


def _shifted(r: torch.Tensor, shift: int) -> torch.Tensor:
    """r[i + shift], -1 past the end."""
    m = r.shape[0]
    out = torch.full((m,), -1, dtype=I32, device=r.device)
    if shift < m:
        out[:m - shift] = r[shift:]
    return out


def _wide_seed(b: torch.Tensor, sp: torch.Tensor, idx64: torch.Tensor):
    """4-bit coarse-code seed (joint_sa.py:108-161): returns (packs,
    order, change flags)."""
    m = b.shape[0]
    bi32 = b.to(I32)
    is_acgt = (b == 65) | (b == 67) | (b == 71) | (b == 84)
    code = torch.where(
        is_acgt,
        2 * ((bi32 >= 67).to(I32) + (bi32 >= 71) + (bi32 >= 84)) + 1,
        2 * ((bi32 > 65).to(I32) + (bi32 > 67) + (bi32 > 71) + (bi32 > 84))
    ).to(torch.uint8)
    # first stop at or after each position; payload (byte, sp)
    _, nxt = _flag_fill(~is_acgt)
    has = nxt < m
    at = torch.clamp(nxt, max=m - 1)
    d = torch.where(has, nxt - idx64, 32)
    payload = (b.to(I64)[at] << 26) | sp.to(I64)[at]
    v = torch.where(d < 32, payload, 0)
    cc = torch.cat([code, torch.zeros(32, dtype=torch.uint8,
                                      device=b.device)])
    p1 = torch.zeros(m, dtype=I64, device=b.device)
    p2 = torch.zeros(m, dtype=I64, device=b.device)
    for k in range(32):
        ck = torch.where(k <= d, cc[k:k + m].to(I64), 0)
        if k < 16:
            p1 = (p1 << 4) | ck
        else:
            p2 = (p2 << 4) | ck
    key1 = p1 ^ SIGN
    key2 = p2 ^ SIGN
    packs = torch.stack([key1, key2])
    order, (k2s, v_s), k1s = _sort_rows(key1, key2, v)
    return packs, order, _changes(k1s, k2s, v_s)


def _narrow_seed(b: torch.Tensor, sp: torch.Tensor, idx64: torch.Tensor):
    """Byte-8 seed (joint_sa.py:162-197): returns (packs, order, change
    flags). ``packs`` holds the unflipped pack8; the sort key flips it."""
    m = b.shape[0]
    _, nxt = _flag_fill(sp > 0)
    has = nxt < m
    d = torch.where(has, nxt - idx64, 8)
    v = torch.where(d < 8, sp[torch.clamp(nxt, max=m - 1)], 0).to(I32)
    bb = torch.cat([b, torch.zeros(8, dtype=torch.uint8, device=b.device)])
    p8 = torch.zeros(m, dtype=I64, device=b.device)
    for k in range(8):
        p8 = (p8 << 8) | torch.where(k <= d, bb[k:k + m].to(I64), 0)
    order, (v_s,), k_s = _sort_rows(p8 ^ SIGN, v)
    return p8[None, :], order, _changes(k_s, v_s)


def _full_round(rank, lv, k: int, m: int):
    """One uncompacted quadrupling round (joint_sa.py:232-268): returns
    (mid_rank, full_rank, sa, lv, resolved, u)."""
    w = 1 << k
    r1, r2, r3 = (_shifted(rank, s * w) for s in (1, 2, 3))
    kk1 = (rank.to(I64) << 32) | (r1.to(I64) + 1)
    kk2 = ((r2.to(I64) + 1) << 32) | (r3.to(I64) + 1)
    del r1, r2, r3
    o_s, (kk2_s,), kk1_s = _sort_rows(kk1, kk2)
    del kk1, kk2
    ch_mid = _changes(kk1_s)
    ch_full = ch_mid | _changes(kk2_s)
    del kk1_s, kk2_s
    lv = torch.where(ch_mid & (lv == 0), k + 1, lv).to(I32)
    lv = torch.where(ch_full & (lv == 0), k + 2, lv).to(I32)
    mid_sorted = _flag_fill(ch_mid)[0].to(I32)
    full_sorted = _flag_fill(ch_full)[0].to(I32)
    sing = ch_full & _next_is(ch_full)
    mid_rank, full_rank, res = _invert(o_s, mid_sorted, full_sorted, sing)
    u = m - int(sing.sum())
    return mid_rank, full_rank, o_s.to(I32), lv, res, u


def _comp_round(rank, lv, resolved, k: int, m: int, U: int, carry):
    """One compacted round (joint_sa.py:270-341) over the U-row slice of
    unresolved elements: extracted once (``carry`` None), then carried.
    Returns (mid_rank, full_rank, lv, resolved, u, carry)."""
    dev = rank.device
    w = 1 << k
    if carry is None:
        ckey = torch.where(resolved, INT32_MAX, rank)
        ck_s, ti_all = torch.sort(ckey, stable=True)
        ti, grp = ti_all[:U].to(I32), ck_s[:U]
        live = grp < INT32_MAX
    else:
        ti, grp, live = carry
    tic = torch.clamp(ti, 0, m - 1).to(I64)

    def sh(off):
        at = tic + off
        vv = rank[torch.clamp(at, 0, m - 1)]
        return torch.where(live & (at < m), vv, -1).to(I64)

    r1, r2, r3 = sh(w), sh(2 * w), sh(3 * w)
    urow = torch.arange(U, dtype=I32, device=dev)
    kk1 = torch.where(live, (grp.to(I64) << 32) | (r1 + 1), BIG)
    kk2 = ((r2 + 1) << 32) | (r3 + 1)
    rowsrc, (kk2_s,), kk1_s = _sort_rows(kk1, kk2)
    g_hi = (kk1_s >> 32).to(I32)
    is_g = _changes(g_hi)
    is_mid = is_g | _changes(kk1_s)
    is_full = is_mid | _changes(kk2_s)
    live_s = kk1_s < BIG
    g_row = _flag_fill(is_g)[0].to(I32)
    mid_rank_u = g_hi + (_flag_fill(is_mid)[0].to(I32) - g_row)
    full_rank_u = g_hi + (_flag_fill(is_full)[0].to(I32) - g_row)
    # new boundaries: subgroup starts that are not group starts; those
    # positions were never boundaries before, so a plain set (the JAX
    # scatter drops masked rows into a dump index; here they are filtered)
    lv = lv.clone()
    sel = live_s & is_mid & ~is_g
    lv[mid_rank_u[sel].long()] = k + 1
    sel = live_s & is_full & ~is_mid
    lv[full_rank_u[sel].long()] = k + 2
    sing = is_full & _next_is(is_full)
    ti_s = ti[torch.clamp(rowsrc, 0, U - 1)]
    at = ti_s[live_s].long()       # unique text positions: plain set
    mid_rank = rank.clone()
    mid_rank[at] = mid_rank_u[live_s]
    full_rank = rank.clone()
    full_rank[at] = full_rank_u[live_s]
    resolved = resolved.clone()
    resolved[at] = sing[live_s]
    keep = live_s & ~sing
    u = int(keep.sum())
    return mid_rank, full_rank, lv, resolved, u, (ti_s, full_rank_u, keep)


def joint_suffix_array(b: torch.Tensor, sp: torch.Tensor, m: int,
                       wide: bool = False):
    """Suffix sort of the joint string whose symbol at i is the pair
    (b[i], sp[i]) (b uint8[m], sp int32[m]; see the JAX docstring).

    Returns (sa int32[m], isa int32[m], hist int32[n_hist, m], packs
    int64[1 or 2, m], k_star int32 scalar, split_lv int32[m]), equal to
    cmsbwt_tpu.ops.joint_sa.joint_suffix_array on the same input."""
    sl = WIDE_SEED_LEVEL if wide else SEED_LEVEL
    if m >= 1 << 30:
        raise ValueError("rank+flag payload packing assumes m < 2^30")
    if wide and m >= 1 << 26:
        raise ValueError("wide seed packs (idx, byte, sp) in 60 bits: "
                         "needs m < 2^26")
    dev = b.device
    levels = n_levels(m)
    idx64 = torch.arange(m, dtype=I64, device=dev)
    U = min(m, max(64, m // 16))

    packs, ord_s, ch_b = (_wide_seed if wide else _narrow_seed)(b, sp, idx64)
    split_lv = torch.where(ch_b, sl, 0).to(I32)
    seed_rank_s = _flag_fill(ch_b)[0].to(I32)
    sing_s = ch_b & _next_is(ch_b)
    rank, resolved = _invert(ord_s, seed_rank_s, sing_s)
    del seed_rank_s
    u0 = m - int(sing_s.sum())

    ks = list(range(sl, levels - 1, 2))
    n_hist = max((ks[-1] - sl + 2) + 1 if ks else 1, 1)
    hist = torch.zeros((n_hist, m), dtype=I32, device=dev)
    hist[0] = rank
    sa = torch.zeros(m, dtype=I32, device=dev)
    u, comp_ran, carry = u0, False, None
    for k in ks:
        if u == 0:          # do_skip: both levels repeat the final ranks
            mid_rank = full_rank = rank
        elif u > U:         # do_full
            mid_rank, full_rank, sa, split_lv, resolved, u = _full_round(
                rank, split_lv, k, m)
        else:               # do_comp
            mid_rank, full_rank, split_lv, resolved, u, carry = _comp_round(
                rank, split_lv, resolved, k, m, U, carry)
            comp_ran = True
        hist[k - sl + 1] = mid_rank
        hist[k - sl + 2] = full_rank
        rank = full_rank
        del mid_rank
    # the last full round's order is stale wherever a compacted round
    # refined further (and the seed-resolved case never produced one)
    if comp_ran or u0 == 0:
        sa = torch.sort(rank, stable=True).indices.to(I32)
    return sa, rank, hist, packs, split_lv.max(), split_lv


def byte8_lcp(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Common symbol-prefix length (< 8) of two masked 8-byte window packs
    (first char in the high byte). Specials (bytes 2/255) end a match."""
    out = torch.zeros(pa.shape, dtype=I32, device=pa.device)
    eq = torch.ones(pa.shape, dtype=torch.bool, device=pa.device)
    for t in range(8):
        sh = 56 - 8 * t
        ba = (pa >> sh) & 0xFF
        bb = (pb >> sh) & 0xFF
        sp = (ba == 2) | (ba == 255) | (bb == 2) | (bb == 255)
        eq = eq & (ba == bb) & ~sp
        out += eq.to(I32)
    return out


def nib16_lcp(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Common symbol-prefix length (<= 16) of two masked 16-nibble coarse
    packs (wide seed): only odd nibbles (ACGT) match."""
    out = torch.zeros(pa.shape, dtype=I32, device=pa.device)
    eq = torch.ones(pa.shape, dtype=torch.bool, device=pa.device)
    for t in range(16):
        sh = 60 - 4 * t
        na = (pa >> sh) & 0xF
        nb = (pb >> sh) & 0xF
        eq = eq & (na == nb) & ((na & 1) == 1)
        out += eq.to(I32)
    return out


def pack_lcp_at(packs, ai, bi, m: int) -> torch.Tensor:
    """Sub-seed-window lcp of suffix pair (ai, bi) from the seed packs
    (the second nibble row counts only when the first fully matches)."""
    def g(r, at):
        return packs[r][torch.clamp(at, 0, m - 1)]

    if packs.shape[0] == 1:
        return byte8_lcp(g(0, ai), g(0, bi))
    r0 = nib16_lcp(g(0, ai), g(0, bi))
    r1 = nib16_lcp(g(1, ai), g(1, bi))
    return r0 + torch.where(r0 == 16, r1, 0).to(I32)


def lift_pairs(hist, packs, ai, bi, lv, m: int) -> torch.Tensor:
    """lcp(ai, bi) for SA-adjacent pairs by binary lifting from each
    pair's split level (plain twin of the ``lcp_lift`` kernel; every pair
    runs the shared loop from max(lv) - 2 down to the seed level, then the
    seed-pack compare). Invalid entries (ai or bi >= m) give 0."""
    REFERENCE_CALLS["lift_pairs"] += 1
    sl = seed_level_of(packs)
    valid = (ai < m) & (bi < m)
    lmax = int(torch.where(valid, lv, 0).max()) if lv.numel() else 0
    h = torch.where(valid & (lv > sl),
                    torch.ones_like(lv) << torch.clamp(lv - 1, min=0),
                    0).to(I32)
    for k in range(lmax - 2, sl - 1, -1):
        rk = hist[max(k - sl, 0)]
        va = ai + h
        vb = bi + h
        ok = valid & (va < m) & (vb < m)
        eq = ok & (rk[torch.clamp(va, 0, m - 1)]
                   == rk[torch.clamp(vb, 0, m - 1)])
        h = h + torch.where(eq, 1 << k, 0).to(I32)
    rem = pack_lcp_at(packs, ai + h, bi + h, m)
    return h + torch.where(valid, rem, 0).to(I32)


def lcp_lift(hist, packs, ai, bi, lv, m: int,
             lmax: int | None = None) -> torch.Tensor:
    """The lift on the device of its tensors: the CUDA kernel for CUDA
    tensors (given ``lmax``, the largest lv of a valid row, it runs no
    reduction and no sync), ``lift_pairs`` for CPU tensors."""
    dev = ai.device.type
    if dev == "cuda":
        from ..kernels import lcp_lift_cuda
        return lcp_lift_cuda(hist, packs, ai, bi, lv, m, lmax)
    if dev == "cpu":
        return lift_pairs(hist, packs, ai, bi, lv, m)
    raise ValueError(f"lcp_lift: unsupported device {dev!r}")
