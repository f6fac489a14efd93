"""The benchmark's plain reference: the run-length BWT of a collection
FASTA file, worked out again from the file in plain PyTorch, and the
comparison that decides ``correct``.

It imports nothing of the program under test and takes nothing the
program made: it reads the collection file the benchmark wrote.

* ``collection_string(raw)``: the collection string SX of a FASTA file's
  bytes, by the CMS-BWT tool's rules (lines as a std::getline loop reads
  them, so a last line without a newline is not read;
  a header or an empty line appends one separator, byte 2, after the
  document before it; sequence lines are concatenated; the file's end
  appends one when the last document has content). A file whose line
  count would trigger the tool's ``-p`` cut is refused.
* ``suffix_array(sx)``: prefix doubling with ``torch.sort`` on 64-bit keys
  (rank of i, rank of i + k), until every rank is distinct. Separators
  sort below every other byte and among themselves by document order: the
  d-th separator takes the value d, a byte c the value (separators) + c.
* ``bwt(sx)``: SX's BWT, BWT[i] = SX[SA[i] - 1], cyclically (the .bwt);
  ``rl_bwt(sx)``: the .rl_bwt bytes of SX's BWT: one record a maximal
  run, its length as a little-endian uint64, then its byte;
  ``output_of_file``: SX's length and either output, from a file.
* ``mismatch_bytes(a, b)``: the bytes by which two outputs differ: unequal
  bytes over their common length, plus the difference of their lengths.

Everything runs on the device of the tensor it is given.
"""
from __future__ import annotations

import numpy as np
import torch

SEPARATOR = 2
NEWLINE, HEADER = 0x0A, 0x3E


def read_file(path, device) -> torch.Tensor:
    return torch.from_numpy(np.fromfile(path, dtype=np.uint8)).to(device)


def collection_string(raw: torch.Tensor) -> torch.Tensor:
    """SX (uint8) of a collection FASTA file's bytes ``raw``."""
    dev = raw.device
    # a last line with no newline is not read (a getline loop on good())
    nls = torch.nonzero(raw == NEWLINE)
    n = int(nls[-1, 0]) + 1 if nls.numel() else 0
    size = int(raw.numel())
    raw = raw[:n]
    if n == 0:
        return raw
    is_nl = raw == NEWLINE
    # line starts: 0 and every byte after a newline, inside the file
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.nonzero(is_nl[:-1]).flatten() + 1])
    # a separator line is empty (its first byte is its newline) or a header
    first = raw[starts]
    sep_line = (first == NEWLINE) | (first == HEADER)
    sep_at = starts[sep_line]
    line_of = torch.zeros(n, dtype=torch.int32, device=dev)
    line_of[starts] = 1
    line_of = torch.cumsum(line_of, 0, dtype=torch.int32) - 1
    keep = ~is_nl & ~sep_line[line_of]
    del line_of, is_nl
    # the tool's characters read: 1 a separator line, its length a
    # sequence line; reaching the file's size less one cuts the collection
    if int(keep.sum()) + int(sep_at.numel()) >= size - 1:
        raise ValueError("collection_string: the file's lines reach the "
                         "tool's cut, which the reference does not model")
    keep[sep_at] = True
    val = raw.clone()
    val[sep_at] = SEPARATOR
    is_sep_byte = torch.zeros(n, dtype=torch.bool, device=dev)
    is_sep_byte[sep_at] = True
    sx = val[keep]
    last_from_sep = bool(is_sep_byte[keep][-1]) if sx.numel() else True
    if not last_from_sep:     # the last document still open at the end
        sx = torch.cat([sx, torch.full((1,), SEPARATOR, dtype=torch.uint8,
                                       device=dev)])
    return sx


def suffix_array(sx: torch.Tensor) -> torch.Tensor:
    """Suffix array (int64) of SX, separators distinct and in document
    order, every other byte above them."""
    n = int(sx.numel())
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=sx.device)
    is_sep = sx == SEPARATOR
    n_seps = int(is_sep.sum())
    rank = torch.where(is_sep, torch.cumsum(is_sep, 0) - 1,
                       sx.to(torch.int64) + n_seps)
    del is_sep
    k = 1
    while True:
        key = rank << 32
        key[:n - k] |= rank[k:] + 1    # a suffix that ends first is smaller
        del rank
        skey, sa = torch.sort(key)
        del key
        step = torch.ones(n, dtype=torch.int64, device=sx.device)
        step[0] = 0
        step[1:] = skey[1:] != skey[:-1]
        del skey
        ranked = torch.cumsum(step, 0)
        del step
        distinct = int(ranked[-1]) + 1
        rank = torch.empty_like(ranked)
        rank[sa] = ranked
        del ranked
        if distinct == n or k >= n:
            return sa
        del sa
        k *= 2


def runs_of(bwt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lengths int64, bytes uint8) of the maximal runs of ``bwt``."""
    n = int(bwt.numel())
    change = torch.ones(n, dtype=torch.bool, device=bwt.device)
    change[1:] = bwt[1:] != bwt[:-1]
    starts = torch.nonzero(change).flatten()
    ends = torch.cat([starts[1:], torch.tensor([n], device=bwt.device)])
    return ends - starts, bwt[starts]


def bwt(sx: torch.Tensor) -> torch.Tensor:
    """SX's BWT: BWT[i] = SX[SA[i] - 1], cyclically."""
    sa = suffix_array(sx)
    return sx[(sa - 1) % max(int(sx.numel()), 1)]


def rl_bwt(sx: torch.Tensor) -> bytes:
    """The .rl_bwt bytes of SX's BWT."""
    if sx.numel() == 0:
        return (0).to_bytes(8, "little") + b"\0"
    length, char = runs_of(bwt(sx))
    rec = torch.empty((length.numel(), 9), dtype=torch.uint8,
                      device=sx.device)
    rec[:, :8] = length.contiguous().view(torch.uint8).view(-1, 8)
    rec[:, 8] = char
    return rec.cpu().numpy().tobytes()


def output_of_file(path, device, rle: bool) -> tuple[int, bytes]:
    """(sn, the .rl_bwt bytes if ``rle`` else the .bwt bytes) of a
    collection FASTA file, worked out on ``device``."""
    sx = collection_string(read_file(path, device))
    if rle:
        return int(sx.numel()), rl_bwt(sx)
    return int(sx.numel()), bwt(sx).cpu().numpy().tobytes()


def mismatch_bytes(a: bytes, b: bytes) -> int:
    """Unequal bytes over the common length plus the lengths' difference."""
    x = np.frombuffer(a, dtype=np.uint8)
    y = np.frombuffer(b, dtype=np.uint8)
    m = min(x.size, y.size)
    return int(np.count_nonzero(x[:m] != y[:m])) + abs(x.size - y.size)
