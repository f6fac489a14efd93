"""Counterpart of cmsbwt_tpu/ops/ms_dense.py. Only the result type that the
device merge consumes is ported so far; the dense joint-sort scan itself
is the next slice (ROADMAP.md)."""
from __future__ import annotations

from dataclasses import dataclass

import torch


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
