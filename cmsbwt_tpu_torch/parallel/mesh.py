"""The blocked dense scan over a group of ranks, one block per rank per
wave — the counterpart of cmsbwt_tpu/parallel/mesh.py.

Each rank holds the whole augmented reference and collection (rank 0's,
broadcast once) and scans block w*R + r of wave w on its own device with
the port's per-block dense stages (ops/ms_dense._block_with_retries: the
joint sort and the hand-written ``lcp_lift`` and ``dense_neighbors``
kernels), as if the block had no predecessor. The cross-block chain is
then one send of each block's last match position to rank r+1 (rank 0
keeps rank R-1's for its next block): a block whose first head follows
that position by one drops it (ops/ms_dense.chain_block, the rule
``pos != prevPos + 1`` of ref CMS-BWT-functions.cpp:360). Wave health is
one all_reduce of the wave's irreducible rows and heads, and each wave's
heads are gathered to rank 0 in block order.

The JAX program shares static caps over a wave and re-runs the whole scan
sequentially when a block overflows them. The port has no static caps: a
block whose match may have been cut by its window retries on its own rank
with the context doubled, as the sequential blocked loop does. The
context default is the JAX one, max(1 << 16, block_chars // 8): the
irreducible count depends on it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import SEPARATOR
from ..ops import ms_dense as md
from ..utils.buckets import bucket_size
from ..utils.timing import stage_timer
from . import distributed
from .dist import bcast_array, bcast_object, gather_rows, send_recv

I64 = torch.int64


def _ring(g, last_pos: int) -> int:
    """Send this rank's last match position to rank r+1 (rank R-1's goes
    to rank 0, for its next block) and return the one received."""
    if g.size == 1:
        return last_pos
    out = torch.empty(1, dtype=I64, device=g.device)
    send_recv([(torch.tensor([last_pos], dtype=I64, device=g.device),
           (g.rank + 1) % g.size)], [(out, (g.rank - 1) % g.size)])
    return int(out)


def _mesh_rank(g, inputs):
    """One rank of ms_dense_heads_mesh; ``inputs`` (rank 0's): x_aug, sx,
    (block_chars, ctx_chars, checkpoint)."""
    mark = stage_timer(g.device) if g.rank == 0 else (lambda name: None)
    x_aug, sx, params = inputs if g.rank == 0 else (None, None, None)
    block_chars, ctx, ckpt = bcast_object(g, params)
    ctx = md._default_ctx(block_chars, ctx)
    x_aug = bcast_array(g, np.asarray(x_aug, np.uint8) if g.rank == 0 else None)
    sx = bcast_array(g, np.asarray(sx, np.uint8) if g.rank == 0 else None)
    n, sn = len(x_aug), len(sx)
    x_u8 = md.upload_bytes(x_aug, bucket_size(n), g.device)
    seps = md._SepCounter(sx)
    starts = list(range(0, sn, block_chars))
    parts, ref_sa, ref_isa, total_rho = [], None, None, 0
    carry = -2                        # rank 0: the block before its next
    mark("mesh_setup")
    for w0 in range(0, len(starts), g.size):
        bi = w0 + g.rank
        part, rho, last_pos = None, 0, -2
        if bi < len(starts):
            b0 = starts[bi]
            emit = min(block_chars, sn - b0)
            saved = ckpt.load(b0) if ckpt else None
            if saved is not None:
                part, rho, last_pos, rsa, risa = saved
            else:
                heads, h_b, rho, last_pos, rsa, risa = md._block_with_retries(
                    x_u8, sx, n, b0, emit, block_chars, ctx, seps.before(b0),
                    -2, SEPARATOR if b0 == 0 else int(sx[b0 - 1]), mark)
                part = md._heads_to_host(tuple(a[:h_b] for a in heads), b0)
                del heads
                if b0 == 0:
                    rsa, risa = rsa[:n].cpu().numpy(), risa[:n].cpu().numpy()
                if ckpt:
                    ckpt.save(b0, part, rho, last_pos,
                              rsa if b0 == 0 else None,
                              risa if b0 == 0 else None)
            if b0 == 0:
                ref_sa, ref_isa = rsa, risa
        prev = _ring(g, last_pos)
        if g.rank == 0:
            prev, carry = carry, prev
        if part is not None:
            part = md.chain_block(part, starts[bi], prev)
        # wave health: the wave's irreducible rows and heads, summed
        h_b = len(part["t"]) if part is not None else 0
        health = torch.tensor([rho, h_b], dtype=I64, device=g.device)
        if g.size > 1:
            dist.all_reduce(health)
        total_rho += int(health[0])
        cols = torch.zeros((h_b, 5), dtype=I64, device=g.device)
        if h_b:
            cols[:] = torch.from_numpy(np.stack(
                [part[k].astype(np.int64) for k in md._PART_KEYS], 1)).to(
                    g.device)
        got = gather_rows(g, cols, h_b)
        if got is not None:
            parts.append(got.cpu().numpy())
        mark("mesh_wave@%d(h=%d)" % (w0, int(health[1])))
    if g.rank != 0:
        return None
    allh = (np.concatenate(parts) if parts
            else np.zeros((0, 5), np.int64))
    ref_bwt = np.where(ref_sa > 0, x_aug[np.maximum(ref_sa - 1, 0)],
                       np.uint8(0)).astype(np.uint8)
    return md.DenseHeadsResult(
        head_t=allh[:, 0].copy(), head_pos=allh[:, 1].copy(),
        head_len=allh[:, 2].copy(), head_smaller=allh[:, 3] != 0,
        head_char=allh[:, 4].astype(np.uint8), ref_sa=ref_sa,
        ref_isa=ref_isa, ref_bwt=ref_bwt, h=len(allh), sn=sn,
        irreducible=total_rho)


def ms_dense_heads_mesh(x_aug: np.ndarray, sx: np.ndarray, block_chars: int,
                        ctx_chars: int | None = None,
                        n_devices: int | None = None, device="cuda",
                        checkpoint: md.BlockCheckpoints | None = None
                        ) -> md.DenseHeadsResult | None:
    """Dense MS of ``sx`` (non-empty) against ``x_aug`` over a group of
    ranks on ``device``, blocks of ``block_chars`` in waves of R: the
    heads, reference index and irreducible count of the sequential blocked
    scan (and of the JAX ms_dense_heads_mesh where its waves did not fall
    back) as a host DenseHeadsResult on rank 0, None on the others. With
    ``checkpoint`` each rank saves its finished blocks there and loads a
    saved block instead of scanning it. The ranks are the launcher's, or
    n_devices (default: the visible cards on cuda, 1 on cpu) started here
    (parallel/distributed.run)."""
    return distributed.run(_mesh_rank,
                           (x_aug, sx, (block_chars, ctx_chars, checkpoint)),
                           device, n_devices)
