"""Output encoders of a run list — the port's copy of ``runs_to_plain`` and
``runs_to_rle`` of cmsbwt_tpu/engine/merge.py: the numpy writers used when
the native IO runtime (io/native.py) cannot be built."""
from __future__ import annotations

import numpy as np


def runs_to_plain(run_len: np.ndarray, run_char: np.ndarray) -> bytes:
    keep = run_len > 0
    return np.repeat(run_char[keep], run_len[keep]).tobytes()


def runs_to_rle(run_len: np.ndarray, run_char: np.ndarray) -> bytes:
    """Merge adjacent equal-char runs, emit (uint64 len, uint8 char) records
    (ref :1003-1085; the initial prevChar=0/runLength=0 state never emits an
    empty first record because BWT chars are >= 2)."""
    keep = run_len > 0
    run_len = run_len[keep]
    run_char = run_char[keep]
    if len(run_len) == 0:
        return b"\x00" * 8 + b"\x00"  # ref writes the (0, 0) initial state
    new = np.ones(len(run_char), dtype=bool)
    new[1:] = run_char[1:] != run_char[:-1]
    gid = np.cumsum(new) - 1
    merged_len = np.zeros(int(gid[-1]) + 1, dtype=np.int64)
    np.add.at(merged_len, gid, run_len)
    merged_len = merged_len.astype(np.uint64)
    merged_char = run_char[new]
    out = np.zeros(len(merged_len) * 9, dtype=np.uint8)
    out[: len(merged_len) * 9].reshape(-1, 9)[:, :8] = (
        merged_len[:, None] >> (8 * np.arange(8, dtype=np.uint64))[None, :]
    ).astype(np.uint8)
    out.reshape(-1, 9)[:, 8] = merged_char
    return out.tobytes()
