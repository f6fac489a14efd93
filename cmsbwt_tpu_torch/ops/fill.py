"""The running fill: the inclusive running max or min of a 1-D int32 or
int64 tensor, forward or reverse — the counterpart of ``jax.lax.cummax`` /
``jax.lax.cummin`` and of the JAX merge's ``_rev_fill_min``
(cmsbwt_tpu/engine/device_merge.py:57-64).

It has two forms with one contract:

* ``running_fill_reference`` — ``torch.cummax`` / ``torch.cummin``, flipped
  for reverse. It is what the port runs on the CPU; on the card only
  tests and chip_smoke.py call it.
* the CUDA kernel ``kernels/csrc/running_fill.cu`` — one launch, a
  single-pass scan with decoupled look-back over 32 KB tiles moved
  coalesced through shared memory, each row read once and written once;
  it runs backward for reverse, with no flipped copy. torch's 1-D CUDA
  cummax / cummin runs in one block.

``running_fill`` picks between them by the device of its tensor. The
device merge's fills, the dense scan's PLCP fill (``ms_dense._running_max``)
and the sharded merge's local scans (``parallel/dist.py``) all go through
it.
"""
from __future__ import annotations

import torch

# calls of the plain fill (the CUDA wrapper keeps its own launch count)
REFERENCE_CALLS = {"running_fill_reference": 0}


def running_fill_reference(v: torch.Tensor, op: str = "max",
                           reverse: bool = False) -> torch.Tensor:
    """out[i] = op(v[0..i]), or op(v[i..]) with ``reverse``; op is "max"
    or "min"."""
    REFERENCE_CALLS["running_fill_reference"] += 1
    cum = torch.cummax if op == "max" else torch.cummin
    if reverse:
        return torch.flip(cum(torch.flip(v, [0]), 0).values, [0])
    return cum(v, 0).values


def running_fill(v: torch.Tensor, op: str = "max",
                 reverse: bool = False) -> torch.Tensor:
    """The running fill on the device of ``v``: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if op not in ("max", "min"):
        raise ValueError(f"running_fill: op must be 'max' or 'min', not "
                         f"{op!r}")
    dev = v.device.type
    if dev == "cuda":
        from ..kernels import running_fill_cuda
        return running_fill_cuda(v, op, reverse)
    if dev == "cpu":
        return running_fill_reference(v, op, reverse)
    raise ValueError(f"running_fill: unsupported device {dev!r}")
