"""The collection parsed where the scan reads it: the file's raw bytes
read into device memory, then made into SX there.

* ``read_raw(path, device)`` reads the file into one device buffer of its
  size. On a card ``_read_ring`` reads it in chunks of READ_CHUNK by
  ``read_threads`` reader threads (``os.preadv``, which releases the GIL;
  one pool a thread count, made at first use) into a ring of 2 slots a
  reader, pinned once per process: chunk k goes into slot k mod S, the
  calling thread copies the chunks onto the card in file order on a side
  stream and hands a slot to a reader again only once its copy has
  ended, so reads run up to S chunks ahead of the copies. On the CPU it
  is the file's bytes. ``LAST_READ`` keeps the last call's bytes and
  times.
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
import threading
import time
from concurrent import futures
from typing import NamedTuple

import numpy as np
import torch

from ..config import ALPHABET_AUGMENT_HI, ALPHABET_AUGMENT_LO, SEPARATOR
from ..utils.timing import count, span
from . import fasta

NEWLINE, HEADER = 0x0A, 0x3E   # '\n', '>'
REFERENCE_CALLS = {"parse_collection_reference": 0}
# the card's read: chunks of READ_CHUNK bytes, at most READ_MAX_THREADS
# readers and 2 ring slots a reader (READ_SLOTS pinned slots, 64 MiB). On
# the H100's host (8 CPUs) a warm 508 MB file took 98 ms to one reader in
# 8 MiB chunks, 25 to 4, 17 to 8 (4 MiB and 16 MiB chunks alike); onto the
# card, copies included, 4 readers of 8 MiB chunks took 32 ms against the
# one-thread read's 107, and 8 readers no less: the calling thread, which
# launches the copies, then shares the CPUs with them (PERF.md)
READ_CHUNK = 8 << 20
READ_MAX_THREADS = 4
READ_SLOTS = 2 * READ_MAX_THREADS
# the last read_raw on a card: bytes, the caller's waits for the chunks'
# reads (read_s), the whole call's seconds (total_s, the last copy's end
# included) and the output buffer's and the ring's making (stage_s)
LAST_READ: dict = {}

_lock = threading.Lock()
_rings: dict = {}      # device index -> the pinned ring, made at first use
_pools: dict = {}      # thread count -> the readers, made at first use


class Parsed(NamedTuple):
    sx_padded: torch.Tensor   # uint8[sn + window]: SX, then window zeros
    sn: int
    n_separators: int
    bad: int                  # first offset with a bad byte, -1 for none


def read_raw(path: str, device) -> torch.Tensor:
    """The file's bytes as a uint8 tensor on ``device``; on a card read in
    chunks by several readers into the pinned ring, each chunk's copy
    overlapping the reads of the chunks after it (``_read_ring``). Span
    ``parse.read``: the waits for a chunk's read under
    ``parse.read.file``, the waits for a slot's copy under
    ``parse.read.wait``; counters ``parse.bytes``, ``parse.read.chunks``,
    ``parse.read.threads`` (the readers; 1 on the CPU)."""
    dev = torch.device(device)
    with span("parse.read"):
        if dev.type == "cpu":
            with span("parse.read.file"):
                raw = np.fromfile(path, dtype=np.uint8)
            count("parse.bytes", int(raw.size))
            count("parse.read.chunks", 1)
            count("parse.read.threads", 1)
            return torch.from_numpy(raw)
        return _read_raw_cuda(path, dev)


def read_threads(chunks: int) -> int:
    """Readers of a file of ``chunks`` chunks: one a chunk, no more than
    the CPUs this process may run on, at most READ_MAX_THREADS, at least
    one."""
    return max(1, min(len(os.sched_getaffinity(0)), chunks,
                      READ_MAX_THREADS))


def _readers(threads: int) -> futures.ThreadPoolExecutor:
    """The pool of ``threads`` readers, made at first use and kept for the
    process."""
    with _lock:
        pool = _pools.get(threads)
        if pool is None:
            pool = _pools[threads] = futures.ThreadPoolExecutor(
                threads, thread_name_prefix="cmsbwt-read")
        return pool


def _ring(dev: torch.device) -> dict:
    """The pinned ring of READ_SLOTS chunks, an event a slot and a side
    stream for ``dev``, made at first use and kept for the process."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    with _lock:
        ring = _rings.get(key)
        if ring is None:
            with torch.cuda.device(key):
                buf = torch.empty(READ_SLOTS * READ_CHUNK, dtype=torch.uint8,
                                  pin_memory=True)
                bufs = list(buf.split(READ_CHUNK))
                ring = _rings[key] = {
                    "bufs": bufs, "views": [b.numpy() for b in bufs],
                    "done": [torch.cuda.Event() for _ in bufs],
                    "stream": torch.cuda.Stream(),
                    # one read at a time through the ring
                    "lock": threading.Lock()}
        return ring


def _read_ring(path: str, size: int, chunk: int, slots: list, threads: int,
               put, wait_slot) -> float:
    """Read the first ``size`` bytes of ``path`` in chunks of ``chunk``
    through the ring ``slots`` (S writable buffers of ``chunk`` bytes):
    chunk k is read into slot k mod S by one of ``threads`` readers (on
    this thread for one reader or one chunk), and once it is read
    ``put(slot, offset, bytes)`` is called, in file order, on this
    thread. A slot is handed to a reader again only after
    ``wait_slot(slot)`` has returned, and every slot used is waited for
    before the call returns. Returns the seconds this thread waited for
    the reads (span ``parse.read.file``; ``wait_slot`` runs under
    ``parse.read.wait``). A file shorter than ``size`` raises OSError, and
    so does, as the reader raised it, a read that fails, each after every
    read in flight has ended."""
    n = -(-size // chunk)
    S = len(slots)
    lag = 1 if S > 1 else 0     # chunk k's copy overlaps chunk k + 1's wait
    pool = _readers(threads) if threads > 1 and n > 1 else None
    pending: dict = {}
    read_s = 0.0
    with open(path, "rb", buffering=0) as f:
        fd = f.fileno()

        def read(k):
            off = k * chunk
            view = memoryview(slots[k % S])[:min(chunk, size - off)]
            got = 0
            while got < len(view):
                r = os.preadv(fd, [view[got:]], off + got)
                if not r:
                    break
                got += r
            return got

        def start(k):
            pending[k] = pool.submit(read, k) if pool else k

        try:
            for k in range(min(S, n)):
                start(k)
            for k in range(n):
                off = k * chunk
                m = min(chunk, size - off)
                with span("parse.read.file") as sp:
                    p = pending.pop(k)
                    got = p.result() if pool else read(p)
                read_s += sp.seconds
                if got < m:
                    raise OSError(f"{path}: file ended at {off + got} "
                                  f"of {size} bytes")
                put(k % S, off, m)
                j = k - lag
                if j >= 0 and j + S < n:
                    with span("parse.read.wait"):
                        wait_slot(j % S)
                    start(j + S)
        finally:
            if pool:
                # after an error: no reader may write into a slot later
                futures.wait(pending.values())
            with span("parse.read.wait"):
                for s in range(min(S, n)):
                    wait_slot(s)
    return read_s


def _read_raw_cuda(path: str, dev: torch.device) -> torch.Tensor:
    t0 = time.perf_counter()
    size = os.path.getsize(path)
    raw = torch.empty(size, dtype=torch.uint8, device=dev)
    ring = _ring(dev)
    stage_s = time.perf_counter() - t0
    chunks = -(-size // READ_CHUNK)
    threads = read_threads(chunks)
    side, bufs, done = ring["stream"], ring["bufs"], ring["done"]

    def put(s, off, m):
        with torch.cuda.stream(side):
            raw[off:off + m].copy_(bufs[s][:m], non_blocking=True)
            done[s].record(side)

    with ring["lock"]:
        # the side stream writes raw after the current stream made it
        side.wait_stream(torch.cuda.current_stream(dev))
        read_s = _read_ring(path, size, READ_CHUNK,
                            ring["views"][:2 * threads], threads, put,
                            lambda s: done[s].synchronize())
        torch.cuda.current_stream(dev).wait_stream(side)
        raw.record_stream(side)
    LAST_READ.clear()
    LAST_READ.update(bytes=size, read_s=read_s, stage_s=stage_s,
                     total_s=time.perf_counter() - t0)
    count("parse.bytes", size)
    count("parse.read.chunks", chunks)
    count("parse.read.threads", threads)
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
