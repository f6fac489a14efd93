"""Seeded prefix-doubling suffix sort of the joint (reference ++ collection)
string — the counterpart of cmsbwt_tpu/ops/joint_sa.py, function by
function (see that module for the algorithm: a byte-8 or 4-bit 32-symbol
seed, quadrupling rounds that recover two rank levels from one order,
compacted late rounds, split levels that bound each adjacent lcp).

Where the JAX code needs a form torch lacks:

* ``lax.sort`` over several keys becomes ``ops/sort.stable_argsort`` (the
  radix_sort kernel on a card), every key int32 or int64 with its width
  stated from m, so no call reads a device max; ties keep index order, as
  the stable ``lax.sort`` does. A round sorts four int32 rank keys, not
  two packed int64 words: the ranks take key_bits(m + 1) bits each. A
  64-bit seed pack is two keys, its unsigned high and low words; the wide
  seed's five keys are two chained stable sorts, the less significant
  keys first (``_wide_seed``). Row ids stay int32 throughout.
* The rank step after the seed's sort and after each round's (the
  change flags of the sorted rows, the running max of each group's start
  row, the singletons, the split levels, the scatters back to text order
  — the seed's inversion sort, which only applies a permutation — and
  the unresolved count) is ``seed_ranks`` and ``round_ranks``: the CUDA
  kernel ``sa_round`` (kernels/csrc/sa_round.cu) on a card, its plain
  versions ``_seed_ranks_reference`` and ``_round_ranks_reference`` on the
  CPU.
* The reverse ``cummin`` of the seeds (the first flagged index at or
  after each position) is ``ops/fill.running_fill`` of int32 indices (the
  running_fill kernel on a card): ``_first_flag``.
* The ``lax.scan`` over rounds with its ``lax.switch`` is a Python loop
  that reads the unresolved count once per round; the sorts' fault word
  (``ops/sort.check_faults``) is read there too.
* uint64 packs are int64 bit patterns, each built from its window's
  bytes by one masked ``unfold`` (``_windows``, ``_pack_be``) where the
  JAX code shifts and ors 8 or 32 times; ``>>`` is arithmetic, so every
  unpack masks and the sign never leaks.

``lift_pairs`` is the plain twin of the CUDA kernel ``lcp_lift``
(kernels/csrc/lcp_lift.cu); ``lcp_lift`` picks between them by the device
of its tensors.
"""
from __future__ import annotations

import torch

from ..index.device import n_levels
from .fill import running_fill
from .sort import check_faults, key_bits, stable_argsort

SEED_LEVEL = 3        # byte seed resolves windows of 2^3 = 8 bytes
WIDE_SEED_LEVEL = 5   # 4-bit coarse-code seed resolves 2^5 = 32 symbols
INT32_MAX = 2**31 - 1
I32, I64 = torch.int32, torch.int64
SIGN = -(1 << 63)     # int64 bit pattern of uint64 1 << 63
# A seed pack's 32-bit words are keys of 32 bits: their all-ones pattern
# (the pad's) never occurs, since a window's bytes after its first special
# (2 or 255) are masked to 0 and real bytes lie below 128, and the wide
# seed's nibble codes are at most 8.
WORD_BITS = 32
SP_BITS = 31                     # sp: any non-negative int32
WIDE_V_BITS = key_bits(1 << 34)  # (byte << 26) | sp: below 2^34

# calls of the plain versions (the CUDA wrappers keep their own launch
# counts)
REFERENCE_CALLS = {"lift_pairs": 0, "_round_ranks_reference": 0,
                   "_seed_ranks_reference": 0}


def seed_level_of(packs) -> int:
    """The seed window level is carried by the pack layout: one int64 row
    = byte-8 seed, two rows = 4-bit 32-symbol seed."""
    return SEED_LEVEL if packs.shape[0] == 1 else WIDE_SEED_LEVEL


def _last_row(flag: torch.Tensor) -> torch.Tensor:
    """Per position i, the last flagged index <= i, -1 if none (int32):
    the running max of where(flag, idx, -1), as the flagged rows' table
    read at the running flag count (a cumsum, which torch runs in
    parallel on a card; its 1-D cummax does not)."""
    n = flag.shape[0]
    c = torch.cumsum(flag, 0)
    table = torch.full((n + 2,), -1, dtype=I32, device=flag.device)
    table.scatter_(0, torch.where(flag, c, n + 1),
                   torch.arange(n, dtype=I32, device=flag.device))
    return table[c]


def _first_flag(flag: torch.Tensor) -> torch.Tensor:
    """Per position i, the first flagged index >= i, len if none (int32):
    the reverse running min of where(flag, idx, len)."""
    m = flag.shape[0]
    idx = torch.arange(m, dtype=I32, device=flag.device)
    return running_fill(torch.where(flag, idx, m), "min", reverse=True)


def _words(p: torch.Tensor):
    """The unsigned high and low 32-bit words of int64 bit patterns, as
    int64 keys: sorted high word first, they order p as uint64 (as the
    JAX sort of the flipped ``p ^ SIGN`` does)."""
    return (p >> 32) & 0xFFFFFFFF, p & 0xFFFFFFFF


def _windows(bb: torch.Tensor, d: torch.Tensor, w: int) -> torch.Tensor:
    """uint8[m, w]: the ``w`` bytes of ``bb`` from each position i < m =
    len(d), those past position i + d[i] (the window's first stop) set to
    0 (``bb`` holds w bytes of padding past m)."""
    m = d.shape[0]
    k = torch.arange(w, dtype=d.dtype, device=d.device)
    return torch.where(k <= d[:, None], bb.unfold(0, w, 1)[:m], 0)


def _pack_be(rows: torch.Tensor) -> torch.Tensor:
    """int64[m]: the 8 bytes of each row of uint8[m, 8], the first the
    most significant (the JAX seeds' shift-and-or packs), read as one
    little-endian word of the reversed row."""
    return rows.flip(1).contiguous().view(I64)[:, 0]


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


def _next_key(r: torch.Tensor, shift: int) -> torch.Tensor:
    """r[i + shift] + 1, 0 past the end: a round's sort key of the rank
    ``shift`` positions on (the JAX ``shifted(rank, shift) + 1``)."""
    m = r.shape[0]
    out = torch.zeros(m, dtype=I32, device=r.device)
    if shift < m:
        torch.add(r[shift:], 1, out=out[:m - shift])
    return out


def _wide_seed(b: torch.Tensor, sp: torch.Tensor, idx: torch.Tensor):
    """4-bit coarse-code seed (joint_sa.py:108-161): returns (packs,
    order, the rows it sorted by: [pack 1, pack 2, payload], text
    order)."""
    m = b.shape[0]
    bi32 = b.to(I32)
    is_acgt = (b == 65) | (b == 67) | (b == 71) | (b == 84)
    code = torch.where(
        is_acgt,
        2 * ((bi32 >= 67).to(I32) + (bi32 >= 71) + (bi32 >= 84)) + 1,
        2 * ((bi32 > 65).to(I32) + (bi32 > 67) + (bi32 > 71) + (bi32 > 84))
    ).to(torch.uint8)
    # first stop at or after each position; payload (byte, sp)
    nxt = _first_flag(~is_acgt)
    has = nxt < m
    at = torch.clamp(nxt, max=m - 1)
    d = torch.where(has, nxt - idx, 32)
    payload = (b.to(I64)[at] << 26) | sp.to(I64)[at]
    v = torch.where(d < 32, payload, 0)
    cc = torch.cat([code, torch.zeros(32, dtype=torch.uint8,
                                      device=b.device)])
    # the 32 codes of each window, masked after its first stop, two to a
    # byte, first code in the high nibble of the first byte
    c = _windows(cc, d, 32)
    nib = (c[:, 0::2] << 4) | c[:, 1::2]
    del c
    p1, p2 = _pack_be(nib[:, :8]), _pack_be(nib[:, 8:])
    del nib
    packs = torch.stack([p1 ^ SIGN, p2 ^ SIGN])
    # five keys, more than one sort takes: the last three first, then the
    # first two, each sort stable
    o = stable_argsort((*_words(p2), v), (WORD_BITS, WORD_BITS, WIDE_V_BITS))
    order = o[stable_argsort(_words(p1[o]), (WORD_BITS, WORD_BITS))]
    del o, p1, p2
    # the flipped packs tie where the packs do
    return packs, order, [packs[0], packs[1], v]


def _narrow_seed(b: torch.Tensor, sp: torch.Tensor, idx: torch.Tensor):
    """Byte-8 seed (joint_sa.py:162-197): returns (packs, order, the rows
    it sorted by: [pack8, payload], text order). ``packs`` holds the
    unflipped pack8, which the sort orders as uint64."""
    m = b.shape[0]
    nxt = _first_flag(sp > 0)
    has = nxt < m
    d = torch.where(has, nxt - idx, 8)
    v = torch.where(d < 8, sp[torch.clamp(nxt, max=m - 1)], 0).to(I32)
    bb = torch.cat([b, torch.zeros(8, dtype=torch.uint8, device=b.device)])
    p8 = _pack_be(_windows(bb, d, 8))
    order = stable_argsort((*_words(p8), v), (WORD_BITS, WORD_BITS, SP_BITS))
    return p8[None, :], order, [p8, v]


def seed_ranks(order, rows, sl: int):
    """The seed's rank step after its sort (JAX joint_sa.py:198-208), on
    the device of its tensors: the CUDA kernel ``sa_round``'s seed mode
    for CUDA tensors, ``_seed_ranks_reference`` for CPU tensors.

    ``order`` (int32[m]) is the stable order of the m positions by
    ``rows``, the key rows the seed sorted by, in text order (the narrow
    seed's pack8 int64 and payload int32; the wide seed's two packs and
    payload, int64); a group of the seed is a run of sorted positions
    whose rows all tie. ``sl`` is the seed level. A list ``rows`` is
    emptied once the kernel has packed it.

    Returns (split_lv, rank, resolved, u0): split_lv (int32[m], SA order)
    sl at a group's first row, else 0; rank (int32[m], text order) the
    sorted row where the position's group starts; resolved (bool[m], text
    order) the group is the position alone; u0 the unresolved count
    (int32[1], on the device: the caller reads it)."""
    dev = order.device.type
    if dev == "cuda":
        from ..kernels import sa_round_seed_cuda
        return sa_round_seed_cuda(order, rows, sl)
    if dev == "cpu":
        return _seed_ranks_reference(order, rows, sl)
    raise ValueError(f"seed_ranks: unsupported device {dev!r}")


def _seed_ranks_reference(order, rows, sl: int):
    """seed_ranks in plain torch, on any device (the torch sequence the
    port ran before the kernel's seed mode)."""
    REFERENCE_CALLS["_seed_ranks_reference"] += 1
    is_s = _changes(*(r[order] for r in rows))
    split_lv = torch.where(is_s, sl, 0).to(I32)
    sing = is_s & _next_is(is_s)
    rank, resolved = _invert(order, _last_row(is_s), sing)
    u0 = (~sing).sum().to(I32).reshape(1)
    return split_lv, rank, resolved, u0


def round_ranks(perm, keys, lv, k: int, comp=None):
    """A round's rank step after its sort (JAX joint_sa.py:244-266 for a
    full round, :307-341 for a compacted one), on the device of its
    tensors: the CUDA kernel ``sa_round`` for CUDA tensors,
    ``_round_ranks_reference`` for CPU tensors.

    ``perm`` (int32[R]) is the stable order of the R rows by ``keys``,
    four int32[R] rows: the group (the rank; a compacted round's dead rows
    hold INT32_MAX) and the ranks + 1 at the three shifts (a list is
    emptied once the kernel has packed it, so that rows held only there
    are freed before its staging is made). ``lv`` is the
    split levels (int32[m], SA order); ``k`` the round's level. A full
    round (``comp`` None) has R = m rows, row i text position i. A
    compacted round passes ``comp`` = (ti int32[R], the text position of
    each row; rank int32[m]; resolved bool[m]).

    Returns (mid_rank, full_rank, resolved, lv, u, carry): the two new
    rank rows and the resolved flags in text order (a compacted round
    changes only its live rows of rank and resolved), the split levels
    with this round's new boundaries, u the unresolved count (int32[1],
    on the device: the caller reads it), and for a compacted round the
    carried slice (ti in sorted order, each row's new rank, the rows still
    live), else None."""
    dev = perm.device.type
    if dev == "cuda":
        from ..kernels import sa_round_cuda
        return sa_round_cuda(perm, keys, lv, k, comp)
    if dev == "cpu":
        return _round_ranks_reference(perm, keys, lv, k, comp)
    raise ValueError(f"round_ranks: unsupported device {dev!r}")


def _round_ranks_reference(perm, keys, lv, k: int, comp=None):
    """round_ranks in plain torch, on any device (the torch sequence the
    port ran before the sa_round kernel)."""
    REFERENCE_CALLS["_round_ranks_reference"] += 1
    s = [key[perm] for key in keys]          # the keys in sorted order
    is_g = _changes(s[0])
    is_mid = is_g | _changes(s[1])
    is_full = is_mid | _changes(s[2], s[3])
    sing = is_full & _next_is(is_full)
    if comp is None:
        lv = torch.where(is_mid & (lv == 0), k + 1, lv)
        lv = torch.where(is_full & (lv == 0), k + 2, lv)
        mid_rank, full_rank, resolved = _invert(perm, _last_row(is_mid),
                                                _last_row(is_full), sing)
        u = (~sing).sum().to(I32).reshape(1)
        return mid_rank, full_rank, resolved, lv, u, None
    ti, rank, resolved = comp
    # a group's rows start at its rank: new rank = group rank + the row's
    # offset in the group (dead rows form one group that is never read)
    live = s[0] != INT32_MAX
    g_row = _last_row(is_g)
    mid_u = s[0] + (_last_row(is_mid) - g_row)
    full_u = s[0] + (_last_row(is_full) - g_row)
    # new boundaries: subgroup starts that are not group starts; those
    # positions were never boundaries before, so a plain set
    lv = lv.clone()
    lv[mid_u[live & is_mid & ~is_g].long()] = k + 1
    lv[full_u[live & is_full & ~is_mid].long()] = k + 2
    ti_s = ti[perm]
    at = ti_s[live].long()           # unique text positions: plain sets
    mid_rank = rank.clone()
    mid_rank[at] = mid_u[live]
    full_rank = rank.clone()
    full_rank[at] = full_u[live]
    resolved = resolved.clone()
    resolved[at] = sing[live]
    keep = live & ~sing
    u = keep.sum().to(I32).reshape(1)
    return mid_rank, full_rank, resolved, lv, u, (ti_s, full_u, keep)


def _full_round(rank, lv, k: int, m: int):
    """One uncompacted quadrupling round (joint_sa.py:232-268): returns
    (mid_rank, full_rank, sa, lv, resolved, u)."""
    w = 1 << k
    keys = [rank, *(_next_key(rank, s * w) for s in (1, 2, 3))]
    o_s = stable_argsort(keys, (key_bits(m + 1),) * 4)
    # the shifted rows are handed over: freed once packed
    mid_rank, full_rank, res, lv, u, _ = round_ranks(o_s, keys, lv, k)
    del keys
    u = int(u)
    check_faults(rank.device)
    return mid_rank, full_rank, o_s, lv, res, u


def _comp_round(rank, lv, resolved, k: int, m: int, U: int, carry):
    """One compacted round (joint_sa.py:270-341) over the U-row slice of
    unresolved elements: extracted once (``carry`` None), then carried.
    Returns (mid_rank, full_rank, lv, resolved, u, carry)."""
    w = 1 << k
    if carry is None:
        ckey = torch.where(resolved, INT32_MAX, rank)
        ti_all, ck_s = stable_argsort((ckey,), (key_bits(m),), values=True)
        # copies, so that the m-row sort outputs are freed here
        ti, grp = ti_all[:U].clone(), ck_s[:U].clone()
        live = grp < INT32_MAX
        del ckey, ti_all, ck_s
    else:
        ti, grp, live = carry
    tic = torch.clamp(ti, 0, m - 1).to(I64)

    def sh(off):
        at = tic + off
        vv = rank[torch.clamp(at, 0, m - 1)]
        return torch.where(live & (at < m), vv + 1, 0).to(I32)

    # dead rows: group INT32_MAX (the pad) and three 0 keys, so they tie
    # and keep index order, as JAX's BIG pack does
    keys = [torch.where(live, grp, INT32_MAX), sh(w), sh(2 * w), sh(3 * w)]
    rowsrc = stable_argsort(keys, (key_bits(m),) + (key_bits(m + 1),) * 3)
    mid_rank, full_rank, resolved, lv, u, carry = round_ranks(
        rowsrc, keys, lv, k, (ti, rank, resolved))
    del keys
    u = int(u)
    check_faults(rank.device)
    return mid_rank, full_rank, lv, resolved, u, carry


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
    U = min(m, max(64, m // 16))

    idx = torch.arange(m, dtype=I32, device=dev)
    packs, ord_s, rows = (_wide_seed if wide else _narrow_seed)(b, sp, idx)
    del idx
    split_lv, rank, resolved, u0 = seed_ranks(ord_s, rows, sl)
    del ord_s, rows
    u0 = int(u0)
    check_faults(dev)

    ks = list(range(sl, levels - 1, 2))
    n_hist = max((ks[-1] - sl + 2) + 1 if ks else 1, 1)
    # every row is written below: row 0 here, two rows each level
    hist = torch.empty((n_hist, m), dtype=I32, device=dev)
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
        sa = stable_argsort((rank,), (key_bits(m),))
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
