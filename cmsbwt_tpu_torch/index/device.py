"""Device reference-index construction in torch — the counterpart of
cmsbwt_tpu/index/device.py, function by function.

* suffix array: Manber–Myers prefix doubling; each round is one stable
  ``ops/sort.stable_argsort`` by the two keys (rank, next + 1), each of
  the bits of n (the JAX version sorts them packed into one int64 word),
  then the round's rank step, ``dense_rank``: the dense rank of each row
  in text order and the round's largest rank, by the CUDA kernel
  ``kernels/csrc/sa_round.cu``'s dense_rank for CUDA tensors, by
  ``_dense_rank_reference`` (the torch sequence of gather, compare,
  cumsum and scatter) for CPU tensors. The JAX version inverts each
  round's order by a second sort; here the rank lands through the order.
  The JAX version skips converged rounds with ``lax.cond``; here a host
  loop reads the largest rank and the sorts' fault word in one copy a
  round, breaks early and fills the remaining history rows. The shifted
  key goes into one buffer that every round reuses.
* rank history: a [LEVELS, n] int32 buffer, kept where asked for
  (``history``; the head string's sort in engine/device_merge.py and
  engine/ranking.py needs none); LCP is computed by binary lifting over it.
* PSV/NSV: a power-of-two sparse table of LCP window minima.

All tensors are int32 (n < 2^31; the rank step's kernel takes n < 2^30).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sort import fault_word, key_bits, raise_faults, stable_argsort

INT_MAX = 2**31 - 1
I32 = torch.int32

# calls of the plain version (the CUDA wrapper keeps its own launch count)
REFERENCE_CALLS = {"_dense_rank_reference": 0}


def dense_rank(order, s0, key1=None, out=None):
    """The rank step after a round's sort, on the device of its tensors:
    the CUDA kernel for CUDA tensors, ``_dense_rank_reference`` for CPU
    tensors. Returns (rank int32[n] in text order, into ``out`` where
    given; top int32[2]: the largest rank and the sorts' fault word as it
    stood after the sort, on the device)."""
    dev = order.device
    if dev.type == "cuda":
        from ..kernels import dense_rank_cuda
        return dense_rank_cuda(order, s0, key1, fault_word(dev), out)
    if dev.type == "cpu":
        return _dense_rank_reference(order, s0, key1, out)
    raise ValueError(f"dense_rank: unsupported device {dev.type!r}")


def _dense_rank_reference(order, s0, key1=None, out=None):
    """Over the n rows in ``order`` (the stable order by (key 0, key 1);
    ``s0`` key 0 in that order, ``key1`` key 1 in text order or None):
    each row's dense rank (ties share a rank: JAX's cumsum(changed) - 1)
    at its text position, and top = (the largest rank, the fault word).
    Plain torch, on any device."""
    REFERENCE_CALLS["_dense_rank_reference"] += 1
    n = order.shape[0]
    diff = s0[1:] != s0[:-1]
    if key1 is not None:
        ks = key1[order]
        diff |= ks[1:] != ks[:-1]
    changed = torch.ones(n, dtype=I32, device=s0.device)
    changed[1:] = diff.to(I32)
    ranks = (torch.cumsum(changed, 0) - 1).to(I32)
    rank = torch.empty(n, dtype=I32, device=s0.device) if out is None \
        else out
    rank[order] = ranks  # a permutation
    top = torch.cat([ranks[-1:], fault_word(s0.device)])
    return rank, top


def _dense_rank(keys, bounds, out=None):
    """Dense rank (ties share rank) of the rows by one or two int32 keys
    (most significant first, each below its bound), int32; returns (rank,
    the stable order of the rows, top: the largest rank and the sorts'
    fault word, on the device)."""
    order, s0 = stable_argsort(keys, [key_bits(b) for b in bounds],
                               values=True)
    rank, top = dense_rank(order, s0, keys[1] if len(keys) > 1 else None,
                           out)
    return rank, order, top


def _largest(top: torch.Tensor) -> int:
    """The round's largest rank, from one copy of ``top`` that also
    brings the sorts' fault word (raised on, as check_faults does)."""
    largest, fault = top.tolist()
    raise_faults(top.device, fault)
    return largest


def n_levels(n: int) -> int:
    """Doubling levels: level k covers windows of 2**k; we need 2**k >= n."""
    lv = 1
    while (1 << lv) < n:
        lv += 1
    return lv + 1  # include level 0


def _next_key(rank: torch.Tensor, shift: int, out: torch.Tensor
              ) -> torch.Tensor:
    """The rank ``shift`` on, + 1 (0 past the end), into ``out``."""
    n = rank.shape[0]
    if shift < n:
        torch.add(rank[shift:], 1, out=out[:n - shift])
    out[max(n - shift, 0):] = 0
    return out


def suffix_array_device(x: torch.Tensor, n: int, bound: int = 256,
                        history: bool = True):
    """Return (sa int32[n], isa int32[n], history int32[LEVELS, n] or None
    when ``history`` is False, k_star) for the integer string ``x`` of
    length n, whose values lie in [0, ``bound``) (bytes by default)."""
    dev = x.device
    levels = n_levels(n)
    hist = torch.empty((levels, n), dtype=I32, device=dev) if history \
        else None
    rank0, _, _ = _dense_rank((x.to(I32),), (bound,),
                              hist[0] if history else None)
    nxt = torch.empty(n, dtype=I32, device=dev)
    # each round's rank goes straight into its history row
    rank, sa, top = _dense_rank((rank0, _next_key(rank0, 1, nxt)),
                                (n, n + 1), hist[1] if history else None)
    del rank0
    done = _largest(top) == n - 1
    k_star = 1 if done else levels
    for k in range(1, levels - 1):
        if done:
            if history:
                hist[k + 1:] = hist[k]
            break
        rank, sa, top = _dense_rank((rank, _next_key(rank, 1 << k, nxt)),
                                    (n, n + 1),
                                    hist[k + 1] if history else None)
        if _largest(top) == n - 1:
            done = True
            k_star = k + 1
    # converged at level 1, the rank is a permutation and its order the SA
    return sa, rank, hist, k_star


def lcp_device(sa: torch.Tensor, history: torch.Tensor, n: int
               ) -> torch.Tensor:
    """LCP int32[n+1]: LCP[i] = lcp(SA[i-1], SA[i]), LCP[0]=0, LCP[n]=-1."""
    levels = history.shape[0]
    a = sa[:-1]
    b = sa[1:]
    h = torch.zeros(n - 1, dtype=I32, device=sa.device)
    for k in range(levels - 1, -1, -1):
        rk = history[k]
        va = a + h
        vb = b + h
        ok = (va < n) & (vb < n)
        eq = ok & (rk[torch.clamp(va, max=n - 1)]
                   == rk[torch.clamp(vb, max=n - 1)])
        h = h + torch.where(eq, 1 << k, 0).to(I32)
    lcp = torch.empty(n + 1, dtype=I32, device=sa.device)
    lcp[0] = 0
    lcp[1:n] = h
    lcp[n] = -1
    return lcp


def sparse_table_levels(n: int) -> int:
    lv = 1
    while (1 << lv) <= n:
        lv += 1
    return lv


def _window_table(base: torch.Tensor, n: int, fill: int, op):
    """table[k][i] = op over base[i .. i+2^k), ``fill`` past n."""
    levels = sparse_table_levels(n)
    table = torch.empty((levels, n), dtype=I32, device=base.device)
    table[0] = base
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev = table[k - 1]
        other = torch.full((n,), fill, dtype=I32, device=base.device)
        if half < n:
            other[:n - half] = prev[half:]
        table[k] = op(prev, other)
    return table


def build_lcp_sparse_table(lcp: torch.Tensor, n: int) -> torch.Tensor:
    """jump[k][i] = min(LCP[i .. i+2^k)), padded with INF past n."""
    return _window_table(lcp[:n], n, INT_MAX, torch.minimum)


def psv_device(jump: torch.Tensor, i: torch.Tensor, ub: torch.Tensor,
               n: int) -> torch.Tensor:
    """Vector PSV: largest j <= i with LCP[j] < ub, else -1."""
    d = torch.zeros_like(i)
    for k in range(jump.shape[0] - 1, -1, -1):
        w = 1 << k
        s = i - d - w + 1
        mins = jump[k][torch.clamp(s, min=0)]
        d = d + torch.where((s >= 0) & (mins >= ub), w, 0).to(I32)
    res = i - d
    return torch.where(res >= 0, res, -1).to(I32)


def nsv_device(jump: torch.Tensor, i: torch.Tensor, ub: torch.Tensor,
               n: int) -> torch.Tensor:
    """Vector NSV: smallest j >= i (j < n) with LCP[j] < ub, else -1."""
    d = torch.zeros_like(i)
    for k in range(jump.shape[0] - 1, -1, -1):
        w = 1 << k
        s = i + d
        mins = jump[k][torch.clamp(s, max=n - 1)]
        d = d + torch.where((s + w <= n) & (mins >= ub), w, 0).to(I32)
    res = i + d
    return torch.where(res < n, res, -1).to(I32)


@dataclass
class DeviceIndex:
    """Reference index resident on one device (int32 throughout)."""

    x_padded: torch.Tensor   # uint8 [n + PAD] (x_padded[n] = 0, rest 0xFF)
    n: int
    sa: torch.Tensor         # int32 [n]
    isa: torch.Tensor        # int32 [n]
    lcp: torch.Tensor        # int32 [n+1]
    plcp: torch.Tensor       # int32 [n]
    bwt: torch.Tensor        # uint8 [n]
    jump: torch.Tensor       # int32 [levels, n] sparse-table minima

    PAD = 1024  # text overrun pad for windowed compares (mismatching bytes)


FIELDS = ("x_padded", "sa", "isa", "lcp", "plcp", "bwt", "jump")


def _index_tail(x, sa, isa, lcp, n: int):
    """PLCP skip bound, reference BWT, sparse table, padded text."""
    plcp = torch.maximum(lcp[isa], lcp[torch.clamp(isa + 1, max=n)])
    bwt = torch.where(sa > 0, x[torch.clamp(sa - 1, min=0)],
                      torch.zeros((), dtype=torch.uint8, device=x.device))
    jump = build_lcp_sparse_table(lcp, n)
    pad = torch.full((DeviceIndex.PAD,), 255, dtype=torch.uint8,
                     device=x.device)
    pad[0] = 0
    return plcp.to(I32), bwt, jump, torch.cat([x, pad])


def build_device_index(x_aug: np.ndarray, device) -> DeviceIndex:
    n = len(x_aug)
    x = torch.from_numpy(np.ascontiguousarray(x_aug, np.uint8)).to(device)
    sa, isa, history, _ = suffix_array_device(x, n)
    lcp = lcp_device(sa, history, n)
    del history
    plcp, bwt, jump, x_padded = _index_tail(x, sa, isa, lcp, n)
    return DeviceIndex(x_padded=x_padded, n=n, sa=sa, isa=isa, lcp=lcp,
                       plcp=plcp, bwt=bwt, jump=jump)


def export_reference_index(d: DeviceIndex, x_aug: np.ndarray):
    """Host ReferenceIndex view of a device-built index (one download of
    each array; the JAX pipeline's ``_export_device_index``)."""
    from .host import ReferenceIndex
    return ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=d.n, sa=d.sa.cpu().numpy(), isa=d.isa.cpu().numpy(),
        lcp=d.lcp.cpu().numpy(), plcp=d.plcp.cpu().numpy(),
        bwt=d.bwt.cpu().numpy(), rank_history=[])


def build_reference_index_device(x_aug: np.ndarray, device):
    """Device-built index exported to the host ReferenceIndex container."""
    return export_reference_index(build_device_index(x_aug, device), x_aug)


def index_from_numpy(arrays: dict, device) -> DeviceIndex:
    """A DeviceIndex from host arrays named as its fields (for example the
    JAX package's DeviceIndex fields through ``np.asarray``)."""
    t = {k: torch.from_numpy(np.array(arrays[k], order="C")).to(device)
         for k in FIELDS}
    return DeviceIndex(n=int(t["sa"].shape[0]), **t)
