"""The collection parsed where the scan reads it: the file's raw bytes
read into device memory, then made into SX there.

* ``read_raw(path, device)`` reads the file into one device buffer of its
  size, in chunks through io/output.py's pinned staging pair (one per
  process, made by whichever of reading and writing comes first): chunk
  k + 1 is read from the file while chunk k is copied on a side stream.
  On the CPU it is the file's bytes. ``LAST_READ`` keeps the last call's
  bytes and times.
* ``parse_collection_dev(raw, sn_limit, window)`` picks by the device of
  ``raw``: the CUDA kernel ``fasta_parse`` (kernels/csrc/fasta_parse.cu)
  for a CUDA tensor, ``parse_collection_reference`` for a CPU tensor.
  Both give a ``Parsed``: SX followed by ``window`` zero bytes (as the
  jump scan's split takes it), sn, the separators appended and the first
  offset whose byte is outside [3, 128) and is not the separator
  (validate_collection's test), all equal to the JAX package's default
  parse (its native parser; cmsbwt_tpu/io/fasta.py:114-133, 192-204).
* ``parse_collection_reference`` is the plain torch version of the same
  function (nonzero, cumsum, gathers), counted in ``REFERENCE_CALLS``.
* ``load_collection(path, sn_limit, device, window)`` reads, parses and
  validates a collection file on ``device`` and returns a
  fasta.Collection that holds SX there (``sx_dev``); the raw buffer is
  freed before it returns.

The rules are those of io/fasta.py (std::getline's lines, the -p cut,
the EOF separator), with sn_limit <= 0 as no cut.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import ALPHABET_AUGMENT_HI, ALPHABET_AUGMENT_LO, SEPARATOR
from ..utils.timing import count, span
from . import fasta

NEWLINE, HEADER = 0x0A, 0x3E   # '\n', '>'
REFERENCE_CALLS = {"parse_collection_reference": 0}
# the last read_raw on a card: bytes, the file reads' seconds into the
# staging pair (read_s), the whole call's (total_s, the last copy's end
# included) and the staging pair's making (stage_s)
LAST_READ: dict = {}


class Parsed(NamedTuple):
    sx_padded: torch.Tensor   # uint8[sn + window]: SX, then window zeros
    sn: int
    n_separators: int
    bad: int                  # first offset with a bad byte, -1 for none


def read_raw(path: str, device) -> torch.Tensor:
    """The file's bytes as a uint8 tensor on ``device``; on a card read in
    chunks through the pinned staging pair, each chunk's copy overlapping
    the next chunk's read. Span ``parse.read``: the file's reads under
    ``parse.read.file``, the waits for a chunk's copy under
    ``parse.read.wait``; counters ``parse.bytes``, ``parse.read.chunks``."""
    dev = torch.device(device)
    with span("parse.read"):
        if dev.type == "cpu":
            with span("parse.read.file"):
                raw = np.fromfile(path, dtype=np.uint8)
            count("parse.bytes", int(raw.size))
            count("parse.read.chunks", 1)
            return torch.from_numpy(raw)
        return _read_raw_cuda(path, dev)


def _read_raw_cuda(path: str, dev: torch.device) -> torch.Tensor:
    from .output import STAGE_BYTES, _stage
    t0 = time.perf_counter()
    size = os.path.getsize(path)
    raw = torch.empty(size, dtype=torch.uint8, device=dev)
    st = _stage(dev)
    stage_s = time.perf_counter() - t0
    side, bufs, done = st["stream"], st["bufs"], st["done"]
    read_s = 0.0
    chunks = 0
    with st["lock"], open(path, "rb", buffering=0) as f:
        # the side stream writes raw after the current stream made it
        side.wait_stream(torch.cuda.current_stream(dev))
        for k, off in enumerate(range(0, size, STAGE_BYTES)):
            m = min(STAGE_BYTES, size - off)
            if k >= 2:
                with span("parse.read.wait"):
                    done[k % 2].synchronize()   # chunk k - 2 has left it
            view = memoryview(bufs[k % 2].numpy())[:m]
            t1 = time.perf_counter()
            with span("parse.read.file"):
                got = 0
                while got < m:
                    n = f.readinto(view[got:])
                    if not n:
                        raise OSError(f"{path}: file ended at {off + got} "
                                      f"of {size} bytes")
                    got += n
            read_s += time.perf_counter() - t1
            with torch.cuda.stream(side):
                raw[off:off + m].copy_(bufs[k % 2][:m], non_blocking=True)
                done[k % 2].record(side)
            chunks += 1
        torch.cuda.current_stream(dev).wait_stream(side)
        raw.record_stream(side)
        with span("parse.read.wait"):
            for e in done:  # the pair is free for the next reader or writer
                e.synchronize()
    LAST_READ.clear()
    LAST_READ.update(bytes=size, read_s=read_s, stage_s=stage_s,
                     total_s=time.perf_counter() - t0)
    count("parse.bytes", size)
    count("parse.read.chunks", chunks)
    return raw


def _limit(sn_limit: int) -> int:
    # the reference's uint64 `charactersRead >= _sn - 1` never holds for
    # _sn <= 0 (io/fasta.py): no cut
    return min(sn_limit, 2**64 - 1) if sn_limit > 0 else 0


def parse_collection_dev(raw: torch.Tensor, sn_limit: int,
                         window: int) -> Parsed:
    """Parse a collection file's raw bytes on their device: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    dev = raw.device.type
    if dev == "cpu":
        with span("parse.kernel"):
            return parse_collection_reference(raw, sn_limit, window)
    if dev != "cuda":
        raise ValueError(f"parse_collection_dev: unsupported device {dev!r}")
    from ..kernels import fasta_parse_cuda
    with span("parse.kernel"):
        out, res = fasta_parse_cuda(raw, _limit(sn_limit), window)
        words = res.cpu().tolist()
    sn, seps, bad = words[1], words[2], words[5]
    sx = out[:sn + window]
    if 2 * (sn + window) < out.numel():
        sx = sx.clone()     # a short prefix: the buffer is the file's size
    return Parsed(sx, sn, seps, bad)


def parse_collection_reference(raw: torch.Tensor, sn_limit: int,
                               window: int) -> Parsed:
    """Plain torch on ``raw``'s device, the same function as the kernel:
    each complete line's end, start, kind and charactersRead (nonzero,
    cumsum), the cut, then SX as the kept bytes of the file in order: a
    sequence line's first ``take`` bytes, a flushing line's '\\n' as the
    separator."""
    REFERENCE_CALLS["parse_collection_reference"] += 1
    dev = raw.device
    i64 = torch.int64
    limit = _limit(sn_limit)
    is_nl = raw == NEWLINE
    ends = torch.nonzero(is_nl).squeeze(1)
    L = int(ends.numel())
    starts = torch.zeros(L, dtype=i64, device=dev)
    starts[1:] = ends[:-1] + 1
    lens = ends - starts
    first = raw[torch.clamp(starts, max=max(int(raw.numel()) - 1, 0))] \
        if L else torch.zeros(0, dtype=torch.uint8, device=dev)
    flush = (lens == 0) | (first == HEADER)
    cr = torch.cumsum(torch.where(flush, 1, lens), 0)
    take = torch.where(flush, 0, lens)
    kept = L
    if limit and L and limit - 1 <= int(cr[-1]):
        hit = torch.nonzero(~flush & (cr >= limit - 1)).squeeze(1)
        if hit.numel():
            c = int(hit[0])
            kept = c + 1
            ln = int(lens[c])
            take[c] = min(max(ln - (int(cr[c]) - limit) - 1, 0), ln)
    # the EOF separator: bytes since the last flush among the kept lines
    # (a sequence line before the last kept one holds at least one byte)
    eof = 0
    if kept:
        last = kept - 1
        eof = int(not bool(flush[last]) and (
            int(take[last]) > 0 or (last > 0 and not bool(flush[last - 1]))))
    # each byte's line (a '\n' ends its own line), its offset in the line
    line = torch.cumsum(is_nl, 0, dtype=i64) - is_nl.to(i64)
    inside = line < kept
    li = torch.clamp(line, max=max(kept - 1, 0))
    pos = torch.arange(int(raw.numel()), dtype=i64, device=dev)
    if kept:
        keep = inside & torch.where(flush[li], is_nl,
                                    (pos - starts[li]) < take[li])
    else:
        keep = torch.zeros_like(is_nl)
    body = torch.where(is_nl, SEPARATOR, raw)[keep]
    sn = int(body.numel()) + eof
    out = torch.zeros(sn + window, dtype=torch.uint8, device=dev)
    out[:body.numel()] = body
    if eof:
        out[sn - 1] = SEPARATOR
    seps = int(flush[:kept].sum()) + eof
    sx = out[:sn]
    bad = ((sx < ALPHABET_AUGMENT_LO) | (sx >= ALPHABET_AUGMENT_HI)) \
        & (sx != SEPARATOR)
    hits = torch.nonzero(bad)
    return Parsed(out, sn, seps, int(hits[0, 0]) if hits.numel() else -1)


def load_collection(path: str, sn_limit: int, device,
                    window: int) -> fasta.Collection:
    """Read, parse and validate a collection file on ``device``: a
    Collection holding SX there (``sx_dev``, ``window`` zero bytes after
    it). Raises validate_collection's ValueError, with the same byte and
    offset, on a byte outside [3, 128) that is not the separator."""
    raw = read_raw(path, device)
    p = parse_collection_dev(raw, sn_limit, window)
    del raw
    count("sn", p.sn)
    if p.bad >= 0:
        raise ValueError(fasta.bad_byte_message(
            int(p.sx_padded[p.bad]), p.bad))
    return fasta.Collection(sn=p.sn, n_separators=p.n_separators,
                            sx_dev=p.sx_padded, window=window)
