"""The ``--parallel`` dense scan — the counterpart of
cmsbwt_tpu/parallel/blocked.py (``ms_dense_heads_parallel``).

The JAX function scans the blocks as independent tries, round-robin over
its devices, and chains them on the host afterwards. On one card a
block's joint sort already fills the device, so the blocks run one after
another whatever the order; the port runs them through the sequential
blocked loop (ops/ms_dense.ms_dense_heads_blocked_on_device), which
chains each block as it goes and gives the same heads, reference index
and irreducible count. Over several cards the blocks are the mesh scan's
(parallel/mesh.ms_dense_heads_mesh), one rank per card.

Block files are saved chained by the sequential loop and unchained by the
mesh scan, as the JAX parallel loop saves them; both load through
ops/ms_dense.chain_block.
"""
from __future__ import annotations

import torch

from ..ops import ms_dense as md


def ms_dense_heads_parallel(x_aug, sx, block_chars: int,
                            ctx_chars: int | None = None, devices=None,
                            checkpoint_dir: str | None = None,
                            fingerprint: str | None = None,
                            device="cuda") -> md.DenseHeadsResult:
    """Blocked dense MS of ``sx`` (non-empty) against ``x_aug`` on
    ``device``, or on ``devices``: one device, or R distinct CUDA devices
    cuda:0..cuda:R-1, one mesh rank each. The heads, reference index and
    irreducible count of the JAX package's ms_dense_heads_parallel, as a
    host DenseHeadsResult. With ``checkpoint_dir`` each finished block is
    saved there, and a saved block is loaded instead of scanned."""
    devs = sorted({torch.device(d) for d in (devices or [device])}, key=str)
    ckpt = (md.BlockCheckpoints(checkpoint_dir, fingerprint or "",
                                block_chars) if checkpoint_dir else None)
    if len(devs) > 1:
        want = [torch.device("cuda", i) for i in range(len(devs))]
        if sorted(devs, key=lambda d: (d.type, d.index or 0)) != want:
            raise ValueError(
                f"the mesh scan runs one rank on each of cuda:0..cuda:R-1, "
                f"not on {[str(d) for d in devs]}")
        from .mesh import ms_dense_heads_mesh
        return ms_dense_heads_mesh(x_aug, sx, block_chars, ctx_chars,
                                   n_devices=len(devs), device="cuda",
                                   checkpoint=ckpt)
    return md.ms_dense_heads_blocked_on_device(
        x_aug, sx, devs[0], block_chars, ctx_chars, ckpt, to_host=True)
