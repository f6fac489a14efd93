"""Device reference-index construction in torch — the counterpart of
cmsbwt_tpu/index/device.py, function by function.

* suffix array: Manber–Myers prefix doubling; each round is one stable
  ``torch.sort`` of the packed int64 key ``(rank << 32) | (next + 1)``.
  The JAX version skips converged rounds with ``lax.cond``; here a host
  loop breaks early and fills the remaining history rows.
* rank history: a [LEVELS, n] int32 buffer; LCP is computed by binary
  lifting over it.
* PSV/NSV: a power-of-two sparse table of LCP window minima.

All tensors are int32 (n < 2^31), except the packed sort keys.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

INT_MAX = 2**31 - 1
I32 = torch.int32


def _dense_rank(vals: torch.Tensor) -> torch.Tensor:
    """Dense rank (ties share rank) of an integer tensor, int32."""
    n = vals.shape[0]
    sv, order = torch.sort(vals, stable=True)
    changed = torch.ones(n, dtype=I32, device=vals.device)
    changed[1:] = (sv[1:] != sv[:-1]).to(I32)
    rank = torch.empty(n, dtype=I32, device=vals.device)
    rank[order] = (torch.cumsum(changed, 0) - 1).to(I32)  # permutation
    return rank


def n_levels(n: int) -> int:
    """Doubling levels: level k covers windows of 2**k; we need 2**k >= n."""
    lv = 1
    while (1 << lv) < n:
        lv += 1
    return lv + 1  # include level 0


def _shifted(rank: torch.Tensor, shift: int) -> torch.Tensor:
    n = rank.shape[0]
    out = torch.full((n,), -1, dtype=I32, device=rank.device)
    if shift < n:
        out[:n - shift] = rank[shift:]
    return out


def _pack(rank: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    return (rank.to(torch.int64) << 32) | (nxt.to(torch.int64) + 1)


def suffix_array_device(x: torch.Tensor, n: int):
    """Return (sa int32[n], isa int32[n], history int32[LEVELS, n],
    k_star) for the integer string ``x`` of length n."""
    dev = x.device
    levels = n_levels(n)
    rank0 = _dense_rank(x.to(I32))
    history = torch.zeros((levels, n), dtype=I32, device=dev)
    history[0] = rank0
    rank = _dense_rank(_pack(rank0, _shifted(rank0, 1)))
    history[1] = rank
    done = int(rank.max()) == n - 1
    k_star = 1 if done else levels
    sa = None
    for k in range(1, levels - 1):
        if done:
            history[k + 1:] = history[k]
            break
        k_s, ord_s = torch.sort(_pack(rank, _shifted(rank, 1 << k)),
                                stable=True)
        changed = torch.ones(n, dtype=I32, device=dev)
        changed[1:] = (k_s[1:] != k_s[:-1]).to(I32)
        new_rank = torch.empty(n, dtype=I32, device=dev)
        new_rank[ord_s] = (torch.cumsum(changed, 0) - 1).to(I32)
        history[k + 1] = new_rank
        rank, sa = new_rank, ord_s.to(I32)
        if int(new_rank.max()) == n - 1:
            done = True
            k_star = k + 1
    if sa is None:  # converged at level 1: invert the rank explicitly
        sa = torch.sort(rank, stable=True).indices.to(I32)
    return sa, rank, history, k_star


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
