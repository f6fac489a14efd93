"""The benchmark's yardstick for kernels: the card's peak and the bytes a
kernel must move, frozen here so that the program cannot change them.

A roofline share is the least time the card could take (the bytes over
the peak memory rate: these kernels do no arithmetic worth counting) over
the time the trace gives the kernel. Each input byte is counted read once
and each output byte written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM, 80 GB HBM3: 3.35 TB/s (NVIDIA's data sheet), at the
# card's 700 W limit
HBM_BYTES_PER_S = 3.35e12


def bound_ms(moved: int) -> float:
    return moved / HBM_BYTES_PER_S * 1e3


def fasta_parse_bytes(file_bytes: int, sn: int, window: int) -> int:
    """fasta_parse.cu: the file's raw bytes read once; SX and its window of
    zero bytes written once."""
    return file_bytes + sn + window


def rle_pack_bytes(runs: int) -> int:
    """run_output.cu's rle_pack: a run's int32 length and its byte read,
    its 9-byte record written: 14 bytes a run."""
    return 14 * runs


def bwt_expand_bytes(runs: int, sn: int) -> int:
    """run_output.cu's tile_starts and bwt_expand: a run's int32 length and
    its byte read, the .bwt's sn chars written once: 5 bytes a run and 1 a
    char."""
    return 5 * runs + sn


def share_pct(moved: int, seconds: float) -> float | None:
    """The roofline share in %, or None where the kernel took no time in
    the trace (it did not run there)."""
    if seconds <= 0:
        return None
    return 100.0 * moved / HBM_BYTES_PER_S / seconds
