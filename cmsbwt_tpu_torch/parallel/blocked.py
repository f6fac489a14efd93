"""The ``--parallel`` dense scan on one device — the counterpart of
cmsbwt_tpu/parallel/blocked.py (``ms_dense_heads_parallel``).

The JAX function scans the blocks as independent tries, round-robin over
its devices, and chains them on the host afterwards. On one card a
block's joint sort already fills the device, so the blocks run one after
another whatever the order; the port runs them through the sequential
blocked loop (ops/ms_dense.ms_dense_heads_blocked_on_device), which
chains each block as it goes and gives the same heads, reference index
and irreducible count. Independent blocks pay only where there are
several devices to take them: that is the mesh program (ROADMAP.md queue
1 item 11), and more than one device raises here.

Block files are saved chained, as the sequential loops save them; a file
the JAX parallel loop saved before its fixup loads through
ops/ms_dense.chain_block like any other.
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
    ``device`` (or on ``devices``, which must all name one device): the
    heads, reference index and irreducible count of the JAX package's
    ms_dense_heads_parallel, as a host DenseHeadsResult. With
    ``checkpoint_dir`` each finished block is saved there, and a saved
    block is loaded instead of scanned."""
    devs = {torch.device(d) for d in (devices or [device])}
    if len(devs) > 1:
        raise NotImplementedError(
            f"ms_dense_heads_parallel over {len(devs)} devices is not ported "
            "yet: ROADMAP.md queue 1 item 11 (the mesh modules)")
    ckpt = (md.BlockCheckpoints(checkpoint_dir, fingerprint or "",
                                block_chars) if checkpoint_dir else None)
    return md.ms_dense_heads_blocked_on_device(
        x_aug, sx, devs.pop(), block_chars, ctx_chars, ckpt, to_host=True)
