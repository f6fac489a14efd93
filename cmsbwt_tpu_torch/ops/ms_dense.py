"""Dense matching statistics — the counterpart of cmsbwt_tpu/ops/ms_dense.py
for its device-resident scans, unblocked (``ms_dense_heads_on_device``) and
blocked (``ms_dense_heads_blocked_on_device``, optionally with per-block
checkpoints in the JAX package's ``.npz`` layout), and for its per-position
test path (``ms_dense``):

joint string -> joint_suffix_array -> irreducible slots -> lift (CUDA
``lcp_lift``) -> PLCP fill -> neighbor scans (CUDA ``dense_neighbors``) ->
assemble -> postprocess -> compact -> finish, into the DeviceHeadsResult
that engine/device_merge.py consumes. The blocked scans run that chain
once per block of the collection (the whole reference plus the block and
a right context), and retry a block with its context doubled when a match
may have been cut by the end of the loaded window.

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

import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SEPARATOR
from ..utils.buckets import bucket_size
from ..utils.timing import count, span
from .fill import running_fill
from .joint_sa import joint_suffix_array, lcp_lift
from .sort import check_faults, key_bits, stable_argsort

INT_MIN = -(2**31)
INT_MAX = 2**31 - 1
LV_BINS = 34               # split-level histogram bins (levels < 32 + spill)
I32, I64 = torch.int32, torch.int64
LOW30 = (1 << 30) - 1

# Peak device bytes per joint char of a dense CLI run (torch's
# max_memory_allocated over m), measured on an NVIDIA H100 80GB HBM3,
# 700 W: 216 at the primary shape (wide seed), 224.2 at the ecoli_dense
# shape (m = 111 M, narrow seed), 233.2-235.5 per block of m = 272 M at
# the 500 Mchar shape (a deeper rank history); 240 holds the largest with
# ~2% to spare. With the joint sort on the port's kernels (int32 row ids,
# no int64 sort pairs) those blocks peak at 189.0-191.2 on the same card;
# the constant is kept, since it sets the blocks the guard chooses. Above
# the budget the pipeline runs the blocked scan, with blocks sized by
# dense_block_chars (PERF.md).
DENSE_BYTES_PER_CHAR = 240

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
    order, key_s = stable_argsort((key,), (key_bits(LV_BINS + 2),),
                                  values=True)
    ai = sa[order]
    bi = _shift_in(sa, m)[order]
    lvp = torch.where(key_s <= LV_BINS, LV_BINS - key_s, 0).to(I32)
    hist_lv = torch.bincount(torch.where(irr, lvc, LV_BINS).long(),
                             minlength=LV_BINS + 1)[:LV_BINS]
    stats = torch.cat([irr.sum().reshape(1), hist_lv]).to(I32)
    return stats, ai, bi, lvp


def _lift_rows(stats: torch.Tensor):
    """(rho, lmax) from the stats of _irreducible_slots, in one read: the
    irreducible row count and the deepest split level among those rows.

    Only the irreducible rows are lifted. Every lift of a pair is a lower
    bound of its lcp, and at a reducible text position PLCP[i] + i =
    PLCP[i-1] + i - 1, so the running max of _fill_ell over the
    irreducible rows alone gives the PLCP at every real text position. The
    JAX package lifts a pow2-bucketed prefix of rows: its extra rows change
    nothing there, and only pad slots where the bucket reaches pad rows,
    which no head reads. lmax only sets the shared top level of rows below
    the seed level, and the irreducible rows all split at or above it."""
    st = stats.tolist()
    live = [k for k, c in enumerate(st[1:]) if c]
    return st[0], (max(live) if live else 0)


def _running_max(v: torch.Tensor, width: int = 4096) -> torch.Tensor:
    """torch.cummax(v).values through ops/fill.running_fill (the CUDA
    kernel on the card). ``width``, the row width of the former two-level
    form, no longer changes anything: the kernel's tiles are its own."""
    return running_fill(v, "max")


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


def _postprocess_block(b, pos, length, smaller, n: int, emit_len: int,
                       prev_pos0: int, prev_b0: int, n_pad: int,
                       sn_pad: int):
    """Separator fixup, head flags (pos != prev + 1), head chars (the
    previous collection byte) and the context check of one joint string,
    emitting only its first ``emit_len`` collection positions
    (ms_dense.py:935-965). ``prev_pos0`` is the pos before the first
    position (the previous block's last, -2 for none) and ``prev_b0`` the
    byte before it. ``viol``: a match reaches within 2 chars of the loaded
    window (the non-pad bytes), so it may have been cut there. Returns
    (pos, length, smaller, is_head, char, h, viol, last_pos), the three
    scalars in one host read. The unblocked scan is the case emit_len = sn,
    prev_pos0 = -2 and prev_b0 the collection's last byte (cyclic)."""
    bc = b[n_pad:n_pad + sn_pad]
    tidx = _ar(sn_pad, b)
    valid = tidx < emit_len
    sep = valid & (bc == SEPARATOR)
    pos = torch.where(sep, n - 1, pos).to(I32)
    length = torch.where(sep, 0, length).to(I32)
    is_head = valid & (pos != _shift_in(pos, prev_pos0) + 1)
    smaller = smaller & is_head & ~sep
    char = _shift_in(bc, prev_b0)
    sn_block = (bc != 255).sum()
    viol = (valid & (tidx + length + 2 > sn_block)).any()
    h, viol, last_pos = torch.stack([
        is_head.sum(), viol.to(I64),
        pos[max(emit_len - 1, 0)].to(I64)]).tolist()
    return pos, length, smaller, is_head, char, h, bool(viol), last_pos


def _compact_heads_raw(pos, length, smaller, is_head, char, sn_pad: int,
                       h_pad: int):
    """Heads in text order, then the other positions in text order, cut to
    h_pad: (t, pos, len, smaller, char int32). The JAX package's
    _compact_heads is the same function."""
    tidx = _ar(sn_pad, pos)
    order = torch.cat([tidx[is_head], tidx[~is_head]])[:h_pad].long()
    return (order.to(I32), pos[order], length[order], smaller[order],
            char[order].to(I32))


def _finish_for_merge(t, pos, length, smaller, char, ref_sa, ref_isa,
                      x, n: int, h: int, h_pad: int, n_pad: int):
    """Zero-fill the pads and compute the reference BWT from the reference
    bytes, the [0, n) prefix of ``x`` (the joint string, or the reference
    as uploaded; ref CMS-BWT-functions.cpp:294-297)."""
    def hpad(a, dtype):
        out = torch.zeros(h_pad, dtype=dtype, device=a.device)
        k = min(h, a.shape[0])
        out[:k] = a[:k]
        return out

    rkeep = _ar(n_pad, ref_sa) < n
    ref_sa = torch.where(rkeep, ref_sa, 0).to(I32)
    ref_isa = torch.where(rkeep, ref_isa, 0).to(I32)
    x = x[:n_pad]
    ref_bwt = torch.where(rkeep & (ref_sa > 0),
                          x[torch.clamp(ref_sa - 1, 0, n_pad - 1).long()],
                          0).to(torch.uint8)
    return (hpad(t, I32), hpad(pos, I32), hpad(length, I32),
            hpad(smaller, torch.bool), hpad(char, torch.uint8), ref_sa,
            ref_isa, ref_bwt)


def free_device_bytes(device) -> int:
    """The bytes a new allocation on a CUDA device can have: the free
    memory torch.cuda.mem_get_info reports plus what torch's caching
    allocator holds reserved but unallocated (a process that ran before
    keeps its freed segments, which mem_get_info counts as used)."""
    device = torch.device(device)
    return (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def dense_budget(device) -> float | None:
    """Device bytes the dense scan may use: ``CMSBWT_HBM_GB`` GiB when
    set (as in the JAX package), else the free memory of a CUDA device
    (free_device_bytes); None on the CPU, which has no such reading."""
    gb = os.environ.get("CMSBWT_HBM_GB")
    if gb:
        return float(gb) * 2**30
    device = torch.device(device)
    if device.type == "cuda":
        return float(free_device_bytes(device))
    return None


def dense_block_chars(n: int, sn: int, budget: float | None) -> int | None:
    """The JAX pipeline's memory guard (pipeline.py:341-354) at the port's
    measured DENSE_BYTES_PER_CHAR: None when the unblocked scan fits
    ``budget`` bytes (or there is no budget), else the block size of the
    blocked scan, 60% of what the budget leaves beside the reference (at
    least 8 Mi chars)."""
    if budget is None:
        return None
    m_est = bucket_size(n) + bucket_size(sn + 1)
    if DENSE_BYTES_PER_CHAR * m_est <= budget:
        return None
    return max(8 << 20,
               int((budget / DENSE_BYTES_PER_CHAR - bucket_size(n)) * 0.6))


def upload_bytes(a: np.ndarray, size: int, device) -> torch.Tensor:
    """``a`` (uint8) zero-padded to ``size`` bytes on ``device``."""
    out = torch.zeros(size, dtype=torch.uint8, device=device)
    out[:len(a)] = torch.from_numpy(np.ascontiguousarray(a, np.uint8))
    return out


def _dense_stages(x_u8, sx_u8, n: int, sn: int, sep_base: int, wide: bool,
                  prefix: str):
    """The joint string of the padded reference and collection bytes and
    the stages from the joint sort to the per-position MS, each tensor
    freed once the next stage no longer needs it, each a span
    ``<prefix><stage>``; rho counted in ``dense.rho``. Returns (b, pos,
    length, smaller, ref_sa, ref_isa, rho)."""
    n_pad, sn_pad = x_u8.shape[0], sx_u8.shape[0]
    m = n_pad + sn_pad
    with span(prefix + "build_joint"):
        b, sp = _build_joint_core(x_u8, sx_u8, n, sn, sep_base, n_pad,
                                  sn_pad)
    with span(prefix + "joint_sa"):
        sa, isa, hist, packs, _, split_lv = joint_suffix_array(b, sp, m,
                                                               wide)
    with span(prefix + "irreducible"):
        stats, ai_all, bi_all, lv_all = _irreducible_slots(
            b, sp, sa, isa, split_lv, n, sn, m, n_pad)
        del sp, split_lv
        rho, lmax = _lift_rows(stats)
        check_faults(b.device)    # the sorts since the last round's read
    count("dense.rho", rho)
    with span(prefix + "lift"):
        # one lift over the rho irreducible rows replaces the JAX
        # package's per-level _lift_orchestrated (the CUDA lcp_lift kernel
        # on a card)
        ai = ai_all[:rho]
        h = lcp_lift(hist, packs, ai, bi_all[:rho], lv_all[:rho], m, lmax)
        del hist, packs, bi_all, lv_all
    with span(prefix + "fill_ell"):
        ell = _fill_ell(h, ai, isa, m)
        del ai_all, ai, h, isa
    with span(prefix + "neighbors"):
        pred_pos, succ_pos, av, bv = _neighbors(sa, ell, n, m)
        del ell
    with span(prefix + "assemble"):
        pos, length, smaller, ref_sa, ref_isa = _assemble(
            sa, pred_pos, succ_pos, av, bv, n, sn, m, n_pad, sn_pad)
    return b, pos, length, smaller, ref_sa, ref_isa, rho


def _unblocked_scan(x_aug: np.ndarray, sx: np.ndarray, device):
    """The unblocked scan up to its postprocess, on ``device``: the whole
    collection as one joint string, emitting all sn positions with no
    previous pos and the collection's last byte before the first (cyclic).
    Returns (b, (pos, length, smaller, is_head, char), h, ref_sa, ref_isa,
    rho, (n_pad, sn_pad, m))."""
    n, sn = len(x_aug), len(sx)
    n_pad, sn_pad, m = joint_geometry(n, sx)
    x_u8 = upload_bytes(x_aug, n_pad, device)
    sx_u8 = upload_bytes(sx, sn_pad, device)
    wide = wide_seed_ok(x_u8[:n], sx_u8[:sn], m)
    b, pos, length, smaller, ref_sa, ref_isa, rho = _dense_stages(
        x_u8, sx_u8, n, sn, 0, wide, "dense.")
    del sx_u8
    with span("dense.postprocess"):
        post = _postprocess_block(b, pos, length, smaller, n, sn, -2,
                                  int(sx[sn - 1]), n_pad, sn_pad)
    return b, post[:5], post[5], ref_sa, ref_isa, rho, (n_pad, sn_pad, m)


def ms_dense_heads_on_device(x_aug: np.ndarray, sx: np.ndarray,
                             device) -> DeviceHeadsResult:
    """Dense MS of ``sx`` (non-empty) against ``x_aug`` on ``device`` whose
    result stays there for the device merge; only scalars (rho, h) reach
    the host. Equal to the JAX ms_dense_heads_on_device field for field.
    Each stage is a span ``dense.<stage>`` (utils/timing.py); counter
    ``heads``."""
    device = torch.device(device)
    n, sn = len(x_aug), len(sx)
    b, (pos, length, smaller, is_head, char), h, ref_sa, ref_isa, rho, \
        (n_pad, sn_pad, _) = _unblocked_scan(x_aug, sx, device)
    h_pad = bucket_size(h + 1)
    ch_pad = min(h_pad, sn_pad + 1)
    with span("dense.compact"):
        heads = _compact_heads_raw(pos, length, smaller, is_head, char,
                                   sn_pad, ch_pad)
        del pos, length, smaller, is_head, char
    with span("dense.finish"):
        (t, pos_h, len_h, sml_h, chr_h, ref_sa, ref_isa,
         ref_bwt) = _finish_for_merge(*heads, ref_sa, ref_isa, b, n, h,
                                      h_pad, n_pad)
    count("heads", h)
    return DeviceHeadsResult(
        head_t=t, head_pos=pos_h, head_len=len_h, head_smaller=sml_h,
        head_char=chr_h, ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, n=n, sn=sn, irreducible=rho)


@dataclass
class DenseMSResult:
    """Matching statistics at every collection position (the JAX
    package's DenseMSResult): pos, length (int64), smaller and is_head
    (bool), cut to sn; the n-long reference index (int32 sa, isa; uint8
    bwt); the irreducible row count and the joint string's length m."""

    pos: np.ndarray
    length: np.ndarray
    smaller: np.ndarray
    is_head: np.ndarray
    ref_sa: np.ndarray
    ref_isa: np.ndarray
    ref_bwt: np.ndarray
    irreducible: int
    m: int


def ms_dense(x_aug: np.ndarray, sx: np.ndarray, device="cuda",
             bucketed: bool = True) -> DenseMSResult:
    """Dense MS of ``sx`` (non-empty) against ``x_aug`` on ``device`` at
    every position, as host arrays: the test path of the JAX package's
    ms_dense (ms_dense.py:684-706), equal to it field for field: the
    unblocked scan (_unblocked_scan, as ms_dense_heads_on_device runs it)
    without the head compaction. Only the bucketed pads are ported:
    nothing in the repository passes ``bucketed=False``."""
    if not bucketed:
        raise ValueError("ms_dense: only bucketed=True is ported (the JAX "
                         "package's default; nothing passes False)")
    device = torch.device(device)
    n, sn = len(x_aug), len(sx)
    _, (pos, length, smaller, is_head, _), _, ref_sa, ref_isa, rho, \
        (_, _, m) = _unblocked_scan(x_aug, sx, device)
    cut = lambda a, k: a[:k].cpu().numpy()
    ref_sa, ref_isa = cut(ref_sa, n), cut(ref_isa, n)
    ref_bwt = np.where(ref_sa > 0,
                       np.asarray(x_aug)[np.maximum(ref_sa - 1, 0)],
                       np.uint8(0)).astype(np.uint8)
    return DenseMSResult(
        pos=cut(pos, sn).astype(np.int64),
        length=cut(length, sn).astype(np.int64),
        smaller=cut(smaller, sn), is_head=cut(is_head, sn), ref_sa=ref_sa,
        ref_isa=ref_isa, ref_bwt=ref_bwt, irreducible=rho, m=m)


# ---------------------------------------------------------------------------
# Blocked execution (ms_dense.py:871-1318)
# ---------------------------------------------------------------------------
#
# The collection is processed in blocks of block_chars with a right context.
# Exactness: every emitted quantity is an endpoint property — pred/succ are
# decided by suffix-vs-reference comparisons that resolve within mslen+1
# chars, and A/B equal lcp(suffix, neighbor-ref) by the range-min identity,
# independent of the (possibly truncated) suffixes in between. A match that
# may have been truncated runs into the end of the loaded window; the block
# is then retried with its context doubled. Head flags chain across blocks
# through the previous block's last pos, head chars through the byte before
# the block, separator ranks through the separators before it.

class _SepCounter:
    """Separators before a block start, counted incrementally (per-block
    count_nonzero, O(block)); block starts are non-decreasing (a retry
    re-enters with the same start), and a smaller one restarts the count."""

    def __init__(self, sx):
        self.sx = sx
        self.pos = 0
        self.cnt = 0

    def before(self, b0: int) -> int:
        if b0 < self.pos:
            self.pos = 0
            self.cnt = 0
        if b0 > self.pos:
            self.cnt += int(np.count_nonzero(
                self.sx[self.pos:b0] == SEPARATOR))
            self.pos = b0
        return self.cnt


def _pow2_pad(x: int) -> int:
    return 1 << max(4, (max(x, 1) - 1).bit_length())


def block_pad(block_chars: int, ctx: int, window: np.ndarray) -> int:
    """The collection part of a block's joint string (ms_dense.py:
    1204-1209): one bucket for every block of a scan (the short last one
    too), one bucket more when the loaded ``window`` fills it and does not
    end in a separator (the joint string must end with a special)."""
    bs_pad = bucket_size(block_chars + ctx)
    if bs_pad == len(window) and window[-1] != SEPARATOR:
        bs_pad = bucket_size(bs_pad + 1)
    return bs_pad


def _scan_block(x_u8, sx: np.ndarray, n: int, *, b0: int, end: int,
                emit_len: int, bs_pad: int, sep_base: int, prev_pos0: int,
                prev_b0: int):
    """One try of one block: the collection window sx[b0:end] against the
    resident reference ``x_u8``, the wide seed where the JAX predicate
    allows it for this window. Returns None when a match may have been cut by
    the window's end and the window can still grow; else (heads compacted
    to ch_pad rows, h, rho, last_pos, ref_sa, ref_isa). Every other tensor
    of the block is freed on return."""
    n_pad = x_u8.shape[0]
    window = end - b0
    with span("dense.block.put"):
        sx_u8 = upload_bytes(sx[b0:end], bs_pad, x_u8.device)
    wide = wide_seed_ok(x_u8[:n], sx_u8[:window], n_pad + bs_pad)
    b, pos, length, smaller, ref_sa, ref_isa, rho = _dense_stages(
        x_u8, sx_u8, n, window, sep_base, wide, "dense.block.")
    del sx_u8
    with span("dense.block.post"):
        pos, length, smaller, is_head, char, h, viol, last_pos = \
            _postprocess_block(b, pos, length, smaller, n, emit_len,
                               prev_pos0, prev_b0, n_pad, bs_pad)
    if viol and end < len(sx):
        return None
    heads = _compact_heads_raw(pos, length, smaller, is_head, char, bs_pad,
                               min(_pow2_pad(h + 1), bs_pad))
    return heads, h, rho, last_pos, ref_sa, ref_isa


def _block_with_retries(x_u8, sx: np.ndarray, n: int, b0: int,
                        emit_len: int, block_chars: int, ctx: int,
                        sep_base: int, prev_pos0: int, prev_b0: int):
    """_scan_block with the adaptive context: doubled until no match
    reaches the window's end, or the window reaches the collection's."""
    while True:
        end = min(b0 + emit_len + ctx, len(sx))
        out = _scan_block(
            x_u8, sx, n, b0=b0, end=end, emit_len=emit_len,
            bs_pad=block_pad(block_chars, ctx, sx[b0:end]),
            sep_base=sep_base, prev_pos0=prev_pos0, prev_b0=prev_b0)
        if out is not None:
            return out
        print(f"#   block@{b0}: context overflow, retry ctx {ctx} -> "
              f"{ctx * 2}", file=sys.stderr)
        ctx *= 2
        if x_u8.device.type == "cuda":
            # the larger retry must not find the cache holding the
            # freed block's segments
            torch.cuda.empty_cache()


def _default_ctx(block_chars: int, ctx_chars: int | None) -> int:
    return max(1 << 16, block_chars // 8) if ctx_chars is None else ctx_chars


def _block_progress(sn: int):
    """Throughput progress of a blocked scan (chars done, Mchars/s)."""
    from ..utils.logging import Progress, get_logger
    return Progress(get_logger(), sn)


class BlockCheckpoints:
    """Per-block head persistence of the blocked scan (ms_dense.py:886-918)
    in the JAX package's layout: one ``.npz`` per finished block, keyed by
    (fingerprint, block_chars, block start), holding the block's heads (t
    global, int64 positions), rho, its last pos, and for the first block
    the reference order; either package resumes from the other's files.
    The restartable form of the reference's ``.phrases`` spill (ref
    CMS-BWT-functions.cpp:1135-1416)."""

    def __init__(self, directory: str, fingerprint: str, block_chars: int):
        from ..utils.checkpoint import CheckpointManager
        self.mgr = CheckpointManager(directory)
        self.fp = f"{fingerprint}:b{block_chars}"

    def load(self, b0: int):
        """A saved block as host arrays: (part, rho, last_pos, ref_sa,
        ref_isa), ``part`` as _heads_to_host makes it and the reference
        order n long (None past the first block); None when it was not
        saved."""
        data = self.mgr.load(f"dense_block_{b0}", self.fp)
        if data is None:
            return None
        part = {k: data[k] for k in _PART_KEYS}
        return (part, int(data["rho"]), int(data["last_pos"]),
                data.get("ref_sa"), data.get("ref_isa"))

    def save(self, b0: int, part: dict, rho: int, last_pos: int,
             ref_sa=None, ref_isa=None) -> None:
        """Save a finished block: its heads (``part``, t global) and, for
        the first block, the reference order's first n entries."""
        arrays = dict(part, rho=np.int64(rho), last_pos=np.int64(last_pos))
        if ref_sa is not None:
            arrays["ref_sa"] = ref_sa
            arrays["ref_isa"] = ref_isa
        self.mgr.save(f"dense_block_{b0}", self.fp, arrays)


@dataclass
class DenseHeadsResult:
    """Head records and reference index as host arrays — the JAX package's
    DenseHeadsResult: h heads (int64 t, pos, len; bool smaller; uint8
    char) and the n-long reference index (int32 sa, isa; uint8 bwt). The
    host merge and the ``dense_heads`` checkpoint bundle take it."""

    head_t: np.ndarray
    head_pos: np.ndarray
    head_len: np.ndarray
    head_smaller: np.ndarray
    head_char: np.ndarray
    ref_sa: np.ndarray
    ref_isa: np.ndarray
    ref_bwt: np.ndarray
    h: int
    sn: int
    irreducible: int


_PART_KEYS = ("t", "pos", "length", "smaller", "char")


def chain_block(part: dict, b0: int, prev_last: int) -> dict:
    """A block's heads (``part``, t global) chained to the block before it:
    row 0 dropped when it is the block's first position and its pos
    follows the previous block's last pos (``pos != prev + 1`` makes a
    head, ref :360). The JAX package's parallel scan computes every
    block as if it had no predecessor, saves it so, and applies this
    afterwards (its parallel/blocked.py:161-167, 213-222); the blocked scan
    applies it to every block it loads, so a file saved before the fixup
    loads as the chained block it stands for. A chained block is returned
    as it is, and so is the first block (b0 = 0)."""
    t, pos = part["t"], part["pos"]
    if b0 and len(t) and t[0] == b0 and pos[0] == prev_last + 1:
        return {k: part[k][1:] for k in _PART_KEYS}
    return part


def _heads_to_host(heads, b0: int) -> dict:
    """A block's head rows (t local to the block, int32) downloaded once,
    t made global in int64 on the host: the dtypes of a JAX block file."""
    t, pos, length, smaller, char = (a.cpu().numpy() for a in heads)
    return dict(t=t.astype(np.int64) + b0, pos=pos.astype(np.int64),
                length=length.astype(np.int64), smaller=smaller,
                char=char.astype(np.uint8))


def _part_to_device(part: dict, device) -> tuple:
    """Host block heads (t global) in the columns of _compact_heads_raw."""
    return tuple(torch.from_numpy(part[k]).to(device=device, dtype=dt)
                 for k, dt in zip(_PART_KEYS, (I32, I32, I32, torch.bool,
                                               I32)))


def _ref_to_device(a, n_pad: int, device) -> torch.Tensor:
    """A saved n-long reference order, zero-padded to n_pad."""
    out = torch.zeros(n_pad, dtype=I32, device=device)
    out[:len(a)] = torch.from_numpy(a).to(device=device, dtype=I32)
    return out


def ms_dense_heads_blocked_on_device(x_aug: np.ndarray, sx: np.ndarray,
                                     device, block_chars: int,
                                     ctx_chars: int | None = None,
                                     checkpoint: BlockCheckpoints | None = None,
                                     to_host: bool = False):
    """Blocked dense MS whose head records stay on ``device`` for the
    device merge (ms_dense.py:1152-1318): the reference is uploaded once,
    each block uploads its collection window, and per block only (h, viol,
    last_pos) and the rho stats reach the host. Each block takes the wide
    seed where the JAX predicate allows it for that block. ``irreducible``
    is the sum of the blocks' rho (each block's joint string holds the
    whole reference). Equal to the JAX function field for field, and its
    heads, reference index and rho to those of the JAX
    ms_dense_heads_blocked (which always takes the narrow seed; neither
    depends on the seed). With ``checkpoint`` each finished block is saved
    there, and a block found there is loaded instead of scanned.

    With ``to_host`` (the route for collections at or above the int32
    bound) each block's heads go to the host once, t offset by the block
    start in int64 there, and the result is a host DenseHeadsResult: no
    tensor on the device holds a global position. Each block is a span
    ``dense.block`` with its stages under ``dense.block.<stage>``; counters
    ``dense.blocks`` and ``heads``."""
    device = torch.device(device)
    n, sn = len(x_aug), len(sx)
    ctx_chars = _default_ctx(block_chars, ctx_chars)
    sep_cum = _SepCounter(sx)
    n_pad = bucket_size(n)
    x_u8 = upload_bytes(x_aug, n_pad, device)
    progress = _block_progress(sn)
    parts = []
    ref_sa = ref_isa = None
    prev_pos0, prev_b0 = -2, SEPARATOR   # cyclic: the trailing separator
    total_rho = 0
    b0 = 0
    while b0 < sn:
        with span("dense.block"):
            emit_len = min(block_chars, sn - b0)
            with span("dense.block.load"):
                saved = checkpoint.load(b0) if checkpoint else None
            heads = None
            if saved is not None:
                part, rho, last_pos, rsa, risa = saved
                part = chain_block(part, b0, prev_pos0)
            else:
                with span("dense.block.sep"):
                    sep_base = sep_cum.before(b0)
                heads, h_b, rho, last_pos, rsa, risa = _block_with_retries(
                    x_u8, sx, n, b0, emit_len, block_chars, ctx_chars,
                    sep_base, prev_pos0, prev_b0)
                # blocks are in stream order: a block's heads are its first
                # h_b rows
                heads = tuple(a[:h_b] for a in heads)
                part = (_heads_to_host(heads, b0) if checkpoint or to_host
                        else None)
                if ref_sa is None:
                    rsa = rsa[:n].cpu().numpy()
                    risa = risa[:n].cpu().numpy()
                if checkpoint:
                    first = b0 == 0
                    checkpoint.save(b0, part, rho, last_pos,
                                    rsa if first else None,
                                    risa if first else None)
            total_rho += rho
            if to_host:
                parts.append(part)
            elif heads is None:
                parts.append(_part_to_device(part, device))
            else:
                parts.append((heads[0] + b0,) + heads[1:])
            if ref_sa is None:
                ref_sa, ref_isa = rsa, risa
            del heads, part, rsa, risa
            prev_pos0 = last_pos
            prev_b0 = int(sx[b0 + emit_len - 1])
            b0 += emit_len
            progress.update(emit_len)
        count("dense.blocks", 1)

    if device.type == "cuda":
        # the cached segments were cut for a block's peak; what runs next
        # (the merge) allocates other sizes
        torch.cuda.empty_cache()
    if to_host:
        cat = lambda k: np.concatenate([p[k] for p in parts])
        with span("dense.concat_blocks"):
            head_t = cat("t")
        ref_bwt = np.where(ref_sa > 0, x_aug[np.maximum(ref_sa - 1, 0)],
                           np.uint8(0)).astype(np.uint8)
        count("heads", len(head_t))
        return DenseHeadsResult(
            head_t=head_t, head_pos=cat("pos"), head_len=cat("length"),
            head_smaller=cat("smaller"), head_char=cat("char"),
            ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt, h=len(head_t),
            sn=sn, irreducible=total_rho)
    with span("dense.concat_blocks"):
        cols = [torch.cat([p[k] for p in parts]) for k in range(5)]
        del parts
        h = int(cols[0].shape[0])
    count("heads", h)
    h_pad = bucket_size(h + 1)
    with span("dense.finish_for_merge"):
        (t, pos_h, len_h, sml_h, chr_h, ref_sa, ref_isa,
         ref_bwt) = _finish_for_merge(
            *cols, _ref_to_device(ref_sa, n_pad, device),
            _ref_to_device(ref_isa, n_pad, device), x_u8, n, h, h_pad, n_pad)
    return DeviceHeadsResult(
        head_t=t, head_pos=pos_h, head_len=len_h, head_smaller=sml_h,
        head_char=chr_h, ref_sa=ref_sa, ref_isa=ref_isa, ref_bwt=ref_bwt,
        h=h, n=n, sn=sn, irreducible=total_rho)
