"""Per-position matching statistics on a device — the counterpart of
cmsbwt_tpu/ops/ms_device.py (``ms_scan_device``, the ``device`` backend).

The JAX package runs a second lane state machine (``ms_scan_kernel``, an
XLA program) that writes (pos, len, smaller) at every collection position.
The port derives the same arrays from the head records of the jump scan
(ops/ms_jump.ms_jump_heads, the CUDA ``ms_jump_scan`` kernel on a card):
at a position t that is not a head, pos[t] = pos[t-1] + 1 by definition,
and then len[t] = len[t-1] - 1 exactly, because the match at t-1 is
maximal (a longer match at pos[t] would extend it by one char). So each
position carries its covering head's (pos + k, len - k), k chars after the
head: a scatter of the heads and a forward fill of the head index over the
collection. ``smaller`` is kept at heads only, as the JAX function keeps
it; the arrays are downloaded once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.device import DeviceIndex
from .ms_jump import ms_jump_heads


@dataclass
class MSDeviceOut:
    pos: np.ndarray       # int64 [sn]
    length: np.ndarray    # int64 [sn]
    smaller: np.ndarray   # bool [sn], False off the heads
    is_head: np.ndarray   # bool [sn]


def expand_heads(head_t, head_pos, head_len, head_smaller, h: int,
                 sn: int) -> torch.Tensor:
    """Per-position (pos, len, smaller, is_head) of the first h head
    records (t ascending, t[0] = 0), as one int32 [4, sn] tensor on their
    device."""
    dev = head_t.device
    t = head_t[:h].long()
    is_head = torch.zeros(sn, dtype=torch.bool, device=dev)
    is_head[t] = True
    hid = torch.cumsum(is_head, 0) - 1            # covering head of each t
    k = torch.arange(sn, device=dev) - t[hid]     # chars since that head
    out = torch.empty((4, sn), dtype=torch.int32, device=dev)
    out[0] = head_pos[:h][hid] + k
    out[1] = head_len[:h][hid] - k
    out[2] = head_smaller[:h][hid] & is_head
    out[3] = is_head
    return out


def ms_scan_device(index: DeviceIndex, sx: np.ndarray, device,
                   lanes: int = 4096, window: int = 64) -> MSDeviceOut:
    """MS at every position of ``sx`` against ``index`` on ``device``:
    the jump scan's heads, expanded (see the module docstring). Host
    arrays in the layout of the host scan (engine/ms_host.MSArrays)."""
    sn = int(len(sx))
    jres = ms_jump_heads(None, sx, device, lanes=lanes, window=window,
                         index=index)
    ms = expand_heads(jres.head_t, jres.head_pos, jres.head_len,
                      jres.head_smaller, jres.h, sn).cpu().numpy()
    return MSDeviceOut(pos=ms[0].astype(np.int64),
                       length=ms[1].astype(np.int64),
                       smaller=ms[2] != 0, is_head=ms[3] != 0)
