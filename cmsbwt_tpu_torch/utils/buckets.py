"""Geometric size buckets, copied from cmsbwt_tpu/utils/jaxcache.py so the
port pads to the same shapes (h_pad, n_pad, cap) as the JAX package and
the two can be compared stage by stage."""
from __future__ import annotations

import os

_RATIO = float(os.environ.get("CMSBWT_BUCKET_RATIO", "1.08"))


def bucket_size(x: int, ratio: float | None = None,
                minimum: int = 1 << 12) -> int:
    """Smallest geometric bucket >= x."""
    b = minimum
    r = _RATIO if ratio is None else ratio
    while b < x:
        b = int(b * r) + 1
    return b
