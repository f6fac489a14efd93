"""Dense matching statistics — the counterpart of cmsbwt_tpu/ops/ms_dense.py
for its unblocked device-resident scan (``ms_dense_heads_on_device``):

joint string -> joint_suffix_array -> irreducible slots -> lift (CUDA
``lcp_lift``) -> PLCP fill -> neighbor scans (CUDA ``dense_neighbors``) ->
assemble -> postprocess -> compact -> finish, into the DeviceHeadsResult
that engine/device_merge.py consumes.

The JAX code applies every permutation by sorting (a TPU sorts faster than
it scatters); here a permutation is a gather or a scatter with unique
indices, and a compaction a boolean mask, with the same results, dtypes
and pads. The joint string is built from raw bytes (no 2-bit transport
packing), but the wide-seed choice reproduces the JAX predicate, which
depends on that packing's exception count (``wide_seed_ok``).

``neighbors_reference`` is the plain twin of the ``dense_neighbors``
kernel; ``_neighbors`` picks between them by the device of its tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import SEPARATOR
from ..utils.buckets import bucket_size
from ..utils.timing import stage_timer
from .joint_sa import joint_suffix_array, lcp_lift

INT_MIN = -(2**31)
INT_MAX = 2**31 - 1
LV_BINS = 34               # split-level histogram bins (levels < 32 + spill)
I32, I64 = torch.int32, torch.int64
LOW30 = (1 << 30) - 1

# Peak device bytes per joint char of a dense CLI run (torch's
# max_memory_allocated over m), measured on an NVIDIA H100 80GB HBM3,
# 700 W: 224.2 at the ecoli_dense shape (m = 111 M, narrow seed), 216 at
# the primary shape (wide seed). The pipeline refuses an unblocked scan
# that would not fit the free device memory (PERF.md).
DENSE_BYTES_PER_CHAR = 225

# calls of the plain neighbor scans (the CUDA wrapper keeps its own count)
REFERENCE_CALLS = {"neighbors_reference": 0}


@dataclass
class DeviceHeadsResult:
    """Head records (h_pad, zero pads beyond h) and reference index (n_pad,
    zero pads beyond n), resident on one device in the layout
    engine/device_merge.py consumes."""

    head_t: torch.Tensor        # int32[h_pad]
    head_pos: torch.Tensor      # int32[h_pad]
    head_len: torch.Tensor      # int32[h_pad]
    head_smaller: torch.Tensor  # bool[h_pad]
    head_char: torch.Tensor     # uint8[h_pad]
    ref_sa: torch.Tensor        # int32[n_pad]
    ref_isa: torch.Tensor       # int32[n_pad]
    ref_bwt: torch.Tensor       # uint8[n_pad]
    h: int
    n: int
    sn: int
    irreducible: int


def _ar(k: int, like: torch.Tensor, dtype=I32) -> torch.Tensor:
    return torch.arange(k, dtype=dtype, device=like.device)


def _shift_in(v: torch.Tensor, first) -> torch.Tensor:
    """[first, v[0], ..., v[-2]] (the JAX ``concatenate([x, v[:-1]])``)."""
    out = torch.empty_like(v)
    out[0] = first
    out[1:] = v[:-1]
    return out


def _pow2_pad(x: int) -> int:
    return 1 << max(4, (max(x, 1) - 1).bit_length())


def joint_geometry(n: int, sx: np.ndarray):
    """(n_pad, sn_pad, m) of the joint string, as _dense_core pads it
    (bucketed): the seeded sort needs the joint string to end with a
    special."""
    sn = len(sx)
    n_pad, sn_pad = bucket_size(n), bucket_size(sn)
    if sn_pad == sn and (sn == 0 or sx[-1] != SEPARATOR):
        sn_pad = bucket_size(sn + 1)
    return n_pad, sn_pad, n_pad + sn_pad


def _exceptions(a: torch.Tensor):
    """The non-ACGT bytes of ``a``, or None when there are more than the
    2-bit transport packing takes (ms_dense._pack2_host)."""
    exc = ~((a == 65) | (a == 67) | (a == 71) | (a == 84))
    if int(exc.sum()) > max(1024, a.shape[0] >> 6):
        return None
    return a[exc]


def wide_seed_ok(x: torch.Tensor, sx: torch.Tensor, m: int) -> bool:
    """The JAX _dense_core's wide-seed choice (ms_dense.py:616-628) as a
    pure function of the reference and collection bytes: both pack (few
    non-ACGT bytes), every non-ACGT byte other than a collection separator
    occurs once, and m < 2^26."""
    ex, esx = _exceptions(x), _exceptions(sx)
    if ex is None or esx is None or m >= 1 << 26:
        return False
    chk = torch.cat([ex, esx[esx != SEPARATOR]])
    return int(torch.unique(chk).numel()) == int(chk.numel())


def _build_joint_core(x_u8, sx_u8, n: int, sn: int, sep_base: int,
                      n_pad: int, sn_pad: int):
    """Joint symbols (b uint8[m], sp int32[m]) from the padded raw bytes:
    real chars keep their byte with sp 0, separators byte 2 with doc-order
    instance ranks, pads byte 255 with ascending ranks."""
    ridx = _ar(n_pad, x_u8)
    is_xpad = ridx >= n
    bx = torch.where(is_xpad, 255, x_u8).to(torch.uint8)
    spx = torch.where(is_xpad, ridx + 1, 0).to(I32)
    tidx = _ar(sn_pad, sx_u8)
    is_sep = (tidx < sn) & (sx_u8 == SEPARATOR)
    sep_rank = torch.cumsum(is_sep, 0).to(I32) - 1
    is_tpad = tidx >= sn
    bsx = torch.where(is_tpad, 255,
                      torch.where(is_sep, SEPARATOR, sx_u8)).to(torch.uint8)
    spsx = torch.where(is_tpad, n_pad + tidx + 1,
                       torch.where(is_sep, sep_base + sep_rank + 1, 0)
                       ).to(I32)
    return torch.cat([bx, bsx]), torch.cat([spx, spsx])


def _irreducible_slots(b, sp, sa, isa, split_lv, n: int, sn: int, m: int,
                       n_pad: int):
    """Irreducible-LCP slots (joint-BWT run boundaries at real text
    positions), deepest split level first, ties by slot. Returns (stats
    int32[1 + LV_BINS] = [rho, level histogram], ai = sa[r], bi =
    sa[r-1], lv) over all m slots; the first rho are the irreducible
    ones."""
    sym = (sp.to(I64) << 8) | b.to(I64)
    bw_sa = _shift_in(sym, -1)[sa.long()]     # joint BWT in SA order
    r = _ar(m, sa)
    reducible = (r > 0) & (bw_sa >= 0) & (bw_sa == _shift_in(bw_sa, -2))
    del bw_sa
    is_real = (sa < n) | ((sa >= n_pad) & (sa < n_pad + sn))
    irr = ~reducible & is_real
    lvc = torch.clamp(split_lv, 0, LV_BINS - 2)
    # one stable int32 key: level bin descending, non-irreducible last
    key = torch.where(irr, LV_BINS - lvc, LV_BINS + 1)
    key_s, order = torch.sort(key, stable=True)
    ai = sa[order]
    bi = _shift_in(sa, m)[order]
    lvp = torch.where(key_s <= LV_BINS, LV_BINS - key_s, 0).to(I32)
    hist_lv = torch.bincount(torch.where(irr, lvc, LV_BINS).long(),
                             minlength=LV_BINS + 1)[:LV_BINS]
    stats = torch.cat([irr.sum().reshape(1), hist_lv]).to(I32)
    return stats, ai, bi, lvp


def _running_max(v: torch.Tensor, width: int = 4096) -> torch.Tensor:
    """torch.cummax(v).values, taken over rows of ``width`` and then
    carried across rows (max is associative, so the result is exact); a
    1-D CUDA cummax would run in one block."""
    m = v.shape[0]
    rows = -(-m // width)
    x = torch.full((rows * width,), torch.iinfo(v.dtype).min, dtype=v.dtype,
                   device=v.device)
    x[:m] = v
    loc = torch.cummax(x.view(rows, width), 1).values
    carry = torch.cummax(loc[:, -1], 0).values
    loc[1:] = torch.maximum(loc[1:], carry[:-1, None])
    return loc.reshape(-1)[:m]


def _fill_ell(h, ai, isa, m: int) -> torch.Tensor:
    """Scatter pair lcps to text order, fill PLCP by a running max of
    (lcp + i), and permute to the adjacent LCP in SA order (ell[0] = 0)."""
    valid = ai < m
    base = torch.full((m,), INT_MIN, dtype=I32, device=h.device)
    base[ai[valid].long()] = h[valid]          # distinct text positions
    r = _ar(m, h)
    best = _running_max(torch.where(base > INT_MIN, base + r, INT_MIN))
    ell = torch.empty(m, dtype=I32, device=h.device)
    ell[isa.long()] = (best.to(I64) - r).to(I32)
    ell[0] = 0
    return ell


def _seg_min_scan(vals, reset, reverse: bool = False) -> torch.Tensor:
    """Segmented running min: with segment ids s = cumsum(reset), it is
    ``BIG*s - cummax(BIG*s - vals)`` (earlier segments never win)."""
    if reverse:
        return _seg_min_scan(vals.flip(0), reset.flip(0)).flip(0)
    big = 1 << 32
    seg = torch.cumsum(reset, 0)
    t = big * seg - vals.to(I64)
    return (big * seg - torch.cummax(t, 0).values).to(I32)


def _fill_ref_value(is_ref, sa, reverse: bool = False):
    """Nearest reference slot's sa value at or below (at or above with
    reverse) each slot, and whether one exists — one packed cummax."""
    if reverse:
        v, ok = _fill_ref_value(is_ref.flip(0), sa.flip(0))
        return v.flip(0), ok.flip(0)
    idx = _ar(is_ref.shape[0], sa, I64)
    packed = torch.where(is_ref, (idx << 32) | sa.to(I64), -1)
    f = torch.cummax(packed, 0).values
    return (f & 0xFFFFFFFF).to(I32), f >= 0


def neighbors_reference(sa, ell, n: int, m: int):
    """For each joint SA slot: (pred ref pos, succ ref pos or -1, A, B) —
    A (B) is the segmented min of adjacent LCPs back to the nearest ref
    slot below (up to the nearest above), INT_MIN where there is none.
    Plain twin of the ``dense_neighbors`` kernel (ms_dense.py:366-386)."""
    REFERENCE_CALLS["neighbors_reference"] += 1
    is_ref = sa < n
    pred_pos, has_pred = _fill_ref_value(is_ref, sa)
    succ_pos, has_succ = _fill_ref_value(is_ref, sa, reverse=True)
    reset_fwd = _shift_in(is_ref, True)
    a = _seg_min_scan(ell, reset_fwd)
    ell_s = torch.zeros_like(ell)
    ell_s[:-1] = ell[1:]
    reset_bwd = torch.ones_like(is_ref)
    reset_bwd[:-1] = is_ref[1:]
    b = _seg_min_scan(ell_s, reset_bwd, reverse=True)
    b = torch.where(has_succ, b, INT_MIN).to(I32)
    a = torch.where(has_pred, a, INT_MIN).to(I32)
    return pred_pos, torch.where(has_succ, succ_pos, -1).to(I32), a, b


def _neighbors(sa, ell, n: int, m: int):
    """The neighbor scans on the device of their tensors: the CUDA kernel
    for CUDA tensors, ``neighbors_reference`` for CPU tensors."""
    dev = sa.device.type
    if dev == "cuda":
        from ..kernels import dense_neighbors_cuda
        return dense_neighbors_cuda(sa, ell, n, m)
    if dev == "cpu":
        return neighbors_reference(sa, ell, n, m)
    raise ValueError(f"dense_neighbors: unsupported device {dev!r}")


def _assemble(sa, pred_pos, succ_pos, a, b, n: int, sn: int, m: int,
              n_pad: int, sn_pad: int):
    """Per-slot MS into collection text order (pos, len, smaller;
    sn_pad long) and the reference-only SA and ISA (n_pad long). Pads hold
    what the JAX sorts leave there: the first non-collection (non-ref)
    slots in SA order, and the identity beyond n for ref_isa."""
    is_ref = sa < n
    is_coll = (sa >= n_pad) & (sa < n_pad + sn)
    choose_succ = b >= a
    pos_slot = torch.where(choose_succ, succ_pos, pred_pos)
    len_slot = torch.maximum(a, b)
    pls = (pos_slot.to(I64) << 31) | \
        (torch.clamp(len_slot, 0, LOW30).to(I64) << 1) | choose_succ.to(I64)
    pls_t = torch.empty(sn_pad, dtype=I64, device=sa.device)
    pls_t[(sa[is_coll] - n_pad).long()] = pls[is_coll]   # a permutation
    pls_t[sn:] = pls[~is_coll][:sn_pad - sn]
    pos = (pls_t >> 31).to(I32)
    length = ((pls_t >> 1) & LOW30).to(I32)
    smaller = (pls_t & 1) != 0
    ref_sa = torch.cat([sa[is_ref], sa[~is_ref][:n_pad - n]])
    ref_isa = _ar(n_pad, sa)
    ref_isa[ref_sa[:n].long()] = _ar(n, sa)
    return pos, length, smaller, ref_sa, ref_isa


def _postprocess(b, pos, length, smaller, n: int, sn: int, n_pad: int,
                 sn_pad: int):
    """Separator fixup, head flags (pos != prev + 1), the head count and
    the head char (previous collection byte, cyclic)."""
    bc = b[n_pad:n_pad + sn_pad]
    tidx = _ar(sn_pad, b)
    valid = tidx < sn
    sep = valid & (bc == SEPARATOR)
    pos = torch.where(sep, n - 1, pos).to(I32)
    length = torch.where(sep, 0, length).to(I32)
    is_head = valid & (pos != _shift_in(pos, -2) + 1)
    smaller = smaller & is_head & ~sep
    h = int(is_head.sum())
    prev_b = _shift_in(bc, bc[max(sn - 1, 0)])
    return pos, length, smaller, is_head, h, prev_b


def _compact_heads_raw(pos, length, smaller, is_head, char, sn_pad: int,
                       h_pad: int):
    """Heads in text order, then the other positions in text order, cut to
    h_pad: (t, pos, len, smaller, char int32)."""
    tidx = _ar(sn_pad, pos)
    order = torch.cat([tidx[is_head], tidx[~is_head]])[:h_pad].long()
    return (order.to(I32), pos[order], length[order], smaller[order],
            char[order].to(I32))


def _finish_for_merge(t, pos, length, smaller, char, ref_sa, ref_isa,
                      b_joint, n: int, h: int, h_pad: int, n_pad: int):
    """Zero-fill the pads and compute the reference BWT from the joint
    bytes' [0, n) prefix (ref CMS-BWT-functions.cpp:294-297)."""
    def hpad(a, dtype):
        out = torch.zeros(h_pad, dtype=dtype, device=a.device)
        k = min(h, a.shape[0])
        out[:k] = a[:k]
        return out

    rkeep = _ar(n_pad, ref_sa) < n
    ref_sa = torch.where(rkeep, ref_sa, 0).to(I32)
    ref_isa = torch.where(rkeep, ref_isa, 0).to(I32)
    x = b_joint[:n_pad]
    ref_bwt = torch.where(rkeep & (ref_sa > 0),
                          x[torch.clamp(ref_sa - 1, 0, n_pad - 1).long()],
                          0).to(torch.uint8)
    return (hpad(t, I32), hpad(pos, I32), hpad(length, I32),
            hpad(smaller, torch.bool), hpad(char, torch.uint8), ref_sa,
            ref_isa, ref_bwt)


def dense_memory_check(n: int, sn: int, free_bytes: int) -> None:
    """Refuse an unblocked dense scan whose measured peak
    (DENSE_BYTES_PER_CHAR per joint char) exceeds ``free_bytes``."""
    m_est = bucket_size(n) + bucket_size(sn + 1)
    need = DENSE_BYTES_PER_CHAR * m_est
    if need > free_bytes:
        raise NotImplementedError(
            f"the unblocked dense scan needs ~{need / 2**30:.1f} GiB for "
            f"{m_est} joint chars ({DENSE_BYTES_PER_CHAR} B/char) but "
            f"{free_bytes / 2**30:.1f} GiB are free: the blocked dense scan "
            "is not ported yet (ROADMAP.md queue 1 item 7)")


def joint_string(x_aug: np.ndarray, sx: np.ndarray, device):
    """Upload the bytes and build the joint string on ``device``: returns
    (b, sp, wide, n_pad, sn_pad, m), ``wide`` the JAX package's seed
    choice for this input."""
    n, sn = len(x_aug), len(sx)
    n_pad, sn_pad, m = joint_geometry(n, sx)
    x_u8 = torch.zeros(n_pad, dtype=torch.uint8, device=device)
    x_u8[:n] = torch.from_numpy(np.ascontiguousarray(x_aug, np.uint8))
    sx_u8 = torch.zeros(sn_pad, dtype=torch.uint8, device=device)
    sx_u8[:sn] = torch.from_numpy(np.ascontiguousarray(sx, np.uint8))
    wide = wide_seed_ok(x_u8[:n], sx_u8[:sn], m)
    b, sp = _build_joint_core(x_u8, sx_u8, n, sn, 0, n_pad, sn_pad)
    return b, sp, wide, n_pad, sn_pad, m


def ms_dense_heads_on_device(x_aug: np.ndarray, sx: np.ndarray,
                             device) -> DeviceHeadsResult:
    """Dense MS of ``sx`` against ``x_aug`` on ``device`` whose result
    stays there for the device merge; only scalars (rho, h) reach the
    host. Equal to the JAX ms_dense_heads_on_device field for field.
    CMSBWT_PROFILE=1 prints device-synced stage marks."""
    device = torch.device(device)
    mark = stage_timer(device)
    n, sn = len(x_aug), len(sx)
    b, sp, wide, n_pad, sn_pad, m = joint_string(x_aug, sx, device)
    mark("build_joint")

    sa, isa, hist, packs, _, split_lv = joint_suffix_array(b, sp, m, wide)
    mark("joint_sa")
    stats, ai_all, bi_all, lv_all = _irreducible_slots(
        b, sp, sa, isa, split_lv, n, sn, m, n_pad)
    del sp, split_lv
    rho = int(stats[0])
    mark("irreducible(rho=%d)" % rho)
    # one lift over the first rho_pad rows replaces the JAX package's
    # per-level _lift_orchestrated (the CUDA lcp_lift kernel on a card)
    rho_pad = min(_pow2_pad(rho), m)
    ai = ai_all[:rho_pad]
    h = lcp_lift(hist, packs, ai, bi_all[:rho_pad], lv_all[:rho_pad], m)
    del hist, packs, bi_all, lv_all
    mark("lift")
    ell = _fill_ell(h, ai, isa, m)
    del ai_all, ai, h, isa
    mark("fill_ell")
    pred_pos, succ_pos, av, bv = _neighbors(sa, ell, n, m)
    del ell
    mark("neighbors")
    pos, length, smaller, ref_sa, ref_isa = _assemble(
        sa, pred_pos, succ_pos, av, bv, n, sn, m, n_pad, sn_pad)
    del sa, pred_pos, succ_pos, av, bv
    mark("assemble")
    pos, length, smaller, is_head, h, char = _postprocess(
        b, pos, length, smaller, n, sn, n_pad, sn_pad)
    mark("postprocess")
    h_pad = bucket_size(h + 1)
    ch_pad = min(h_pad, sn_pad + 1)
    heads = _compact_heads_raw(pos, length, smaller, is_head, char, sn_pad,
                               ch_pad)
    del pos, length, smaller, is_head, char
    mark("compact")
    (t, pos_h, len_h, sml_h, chr_h, ref_sa, ref_isa,
     ref_bwt) = _finish_for_merge(*heads, ref_sa, ref_isa, b, n, h, h_pad,
                                  n_pad)
    mark("finish")
    return DeviceHeadsResult(
        head_t=t, head_pos=pos_h, head_len=len_h, head_smaller=sml_h,
        head_char=chr_h, ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, n=n, sn=sn, irreducible=rho)
