"""The card's read of a collection file (io/parse._read_ring), driven on
the CPU with numpy slots: the bytes as ``np.fromfile`` reads them at the
chunk's edges for one to eight readers and rings of T and 2T slots, one
``put`` a chunk in file order, no slot handed to a reader before its
``wait_slot``, a file shorter than its size and a failing read raised
with no read left in flight, one pool a thread count. One case needs a
card (``read_raw`` onto it; skips elsewhere). The file imports neither
JAX nor the test helpers, so that on a card it runs alone:

    python3 -m pytest tests/test_torch_read_ring.py --noconftest \\
        -o addopts= -p no:cacheprovider
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time

import numpy as np
import pytest

from cmsbwt_tpu_torch.io import parse
from cmsbwt_tpu_torch.utils import timing

CHUNK = 4096
SIZES = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 5 * CHUNK + CHUNK // 2]
THREADS = [1, 2, 3, 8]


def write(tmp_path, size, seed=29):
    path = tmp_path / f"coll-{size}.fa"
    rng = np.random.default_rng([seed, size])
    path.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return path


class Ring:
    """Numpy slots, a ``put`` that copies a slot into ``out`` and a log of
    the calls; ``wait_slot`` logs its slot."""

    def __init__(self, size, slots, chunk=CHUNK):
        self.slots = [np.zeros(chunk, np.uint8) for _ in range(slots)]
        self.out = np.zeros(size, np.uint8)
        self.log = []
        self.lock = threading.Lock()

    def note(self, *event):
        with self.lock:
            self.log.append(event)

    def put(self, s, off, m):
        self.note("put", s, off, m)
        self.out[off:off + m] = self.slots[s][:m]

    def wait_slot(self, s):
        self.note("wait", s)

    def run(self, path, size, threads, chunk=CHUNK):
        return parse._read_ring(str(path), size, chunk, self.slots, threads,
                                self.put, self.wait_slot)


@pytest.fixture
def reads(monkeypatch):
    """os.preadv as the readers call it, logged: each chunk's first read
    (by its offset), the reads running at a time, optionally slowed by a
    random sleep or failing at a chosen offset."""
    real = os.preadv

    class Reads:
        ring = None
        jitter = 0.0
        fail_at = None
        running = 0
        calls = 0
        lock = threading.Lock()
        rng = random.Random(29)

    def preadv(fd, bufs, off):
        with Reads.lock:
            Reads.running += 1
            Reads.calls += 1
            pause = Reads.rng.random() * Reads.jitter
        try:
            if Reads.ring is not None and off % CHUNK == 0:
                Reads.ring.note("read", off // CHUNK)
            if pause:
                time.sleep(pause)
            if off == Reads.fail_at:
                raise OSError(5, "Input/output error (made by the test)")
            return real(fd, bufs, off)
        finally:
            with Reads.lock:
                Reads.running -= 1

    monkeypatch.setattr(parse.os, "preadv", preadv)
    return Reads


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("per_reader", [1, 2])
def test_bytes_equal_fromfile(tmp_path, size, threads, per_reader):
    path = write(tmp_path, size)
    ring = Ring(size, per_reader * threads)
    ring.run(path, size, threads)
    assert np.array_equal(ring.out, np.fromfile(path, dtype=np.uint8))


@pytest.mark.parametrize("threads", THREADS)
def test_put_once_a_chunk_in_file_order(tmp_path, reads, threads):
    """Readers that finish out of order (random sleeps) still give one
    ``put`` a chunk, in file order, each from the chunk's slot."""
    size = 11 * CHUNK + 5
    path = write(tmp_path, size)
    ring = Ring(size, 2 * threads)
    reads.jitter = 2e-3
    ring.run(path, size, threads)
    puts = [e[1:] for e in ring.log if e[0] == "put"]
    S = 2 * threads
    assert puts == [(k % S, off, min(CHUNK, size - off))
                    for k, off in enumerate(range(0, size, CHUNK))]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("per_reader", [1, 2])
def test_no_slot_is_read_into_before_its_wait(tmp_path, reads, threads,
                                              per_reader):
    """Chunk k >= S is read into slot k mod S only after ``wait_slot`` of
    that slot was called after chunk k - S's ``put``; every slot used is
    waited for after the last ``put``."""
    S = per_reader * threads
    size = 13 * CHUNK + 7
    n = -(-size // CHUNK)
    path = write(tmp_path, size)
    ring = Ring(size, S)
    reads.ring, reads.jitter = ring, 1e-3
    ring.run(path, size, threads)
    log = ring.log
    at = {("put", e[2] // CHUNK): i for i, e in enumerate(log)
          if e[0] == "put"}
    at.update({("read", e[1]): i for i, e in enumerate(log)
               if e[0] == "read"})
    assert sorted(k for kind, k in at if kind == "read") == list(range(n))
    for k in range(S, n):
        waits = [i for i, e in enumerate(log) if e == ("wait", k % S)
                 and at[("put", k - S)] < i < at[("read", k)]]
        assert waits, f"chunk {k} read into slot {k % S} before its wait"
    last = at[("put", n - 1)]
    assert {e[1] for e in log[last:] if e[0] == "wait"} == set(
        range(min(S, n)))


def open_fds_to(path):
    fds = "/proc/self/fd"
    return [fd for fd in os.listdir(fds)
            if os.path.realpath(os.path.join(fds, fd)) == str(path)]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("real", [5 * CHUNK + CHUNK // 2, 5 * CHUNK, 0])
def test_a_file_shorter_than_its_size_raises(tmp_path, reads, threads,
                                             real):
    """A file that shrank after its size was read: the OSError of the
    one-thread read, raised after every read in flight ended, the file
    closed and every slot used waited for."""
    size = 9 * CHUNK
    path = write(tmp_path, real)
    ring = Ring(size, 2 * threads)
    reads.jitter = 1e-3
    with pytest.raises(OSError) as err:
        ring.run(path, size, threads)
    assert str(err.value) == f"{path}: file ended at {real} of {size} bytes"
    assert reads.running == 0
    calls = reads.calls
    time.sleep(0.02)
    assert reads.calls == calls, "a read started after the call raised"
    assert not open_fds_to(path)
    S = min(2 * threads, -(-size // CHUNK))
    assert {e[1] for e in ring.log if e[0] == "wait"} >= set(range(S))


@pytest.mark.parametrize("threads", THREADS)
def test_a_reader_error_reaches_the_caller(tmp_path, reads, threads):
    size = 9 * CHUNK
    path = write(tmp_path, size)
    ring = Ring(size, 2 * threads)
    reads.fail_at, reads.jitter = 3 * CHUNK, 1e-3
    with pytest.raises(OSError, match="made by the test") as err:
        ring.run(path, size, threads)
    assert err.value.errno == 5
    assert reads.running == 0
    assert not open_fds_to(path)
    # the chunks before the failing one were handed over
    puts = [e[2] for e in ring.log if e[0] == "put"]
    assert puts == [0, CHUNK, 2 * CHUNK]


def test_the_pool_is_made_once_a_thread_count(tmp_path, monkeypatch):
    monkeypatch.setattr(parse, "_pools", {})
    size = 6 * CHUNK
    path = write(tmp_path, size)
    Ring(size, 6).run(path, size, 3)
    pool = parse._pools[3]
    Ring(size, 6).run(path, size, 3)
    assert parse._pools == {3: pool}
    assert parse._readers(3) is pool
    # a file of one chunk is read on the calling thread
    Ring(CHUNK, 6).run(write(tmp_path, CHUNK), CHUNK, 3)
    monkeypatch.setattr(parse, "_pools", {})
    Ring(CHUNK, 6).run(write(tmp_path, CHUNK), CHUNK, 3)
    assert parse._pools == {}


@pytest.mark.parametrize("chunks", [0, 1, 2, 1000])
def test_read_threads(chunks):
    cpus = len(os.sched_getaffinity(0))
    assert parse.read_threads(chunks) == max(
        1, min(cpus, chunks, parse.READ_MAX_THREADS))


def test_the_ring_fits_its_pinned_budget():
    assert parse.READ_SLOTS == 2 * parse.READ_MAX_THREADS
    assert parse.READ_SLOTS * parse.READ_CHUNK <= 128 << 20


def test_many_readers_under_fast_switching(tmp_path, reads):
    """More readers than CPUs, the interpreter switching threads every
    microsecond, the reads slowed at random: the bytes still arrive whole
    and in order."""
    size = 64 * CHUNK + 3
    path = write(tmp_path, size)
    threads = 2 * len(os.sched_getaffinity(0)) + 1
    reads.jitter = 2e-4
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            ring = Ring(size, 2 * threads)
            ring.run(path, size, threads)
            assert np.array_equal(ring.out,
                                  np.fromfile(path, dtype=np.uint8))
    finally:
        sys.setswitchinterval(interval)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.card
def test_read_raw_onto_the_card(card, tmp_path):
    """~100 MB of odd size, several chunks: the card's bytes equal the
    file's, through several readers; LAST_READ keeps its keys."""
    import torch
    size = 100 * 1000 * 1000 + 7
    path = write(tmp_path, size)
    timing.reset()
    raw = parse.read_raw(str(path), card)
    torch.cuda.synchronize()
    assert raw.device.type == "cuda" and raw.numel() == size
    assert np.array_equal(raw.cpu().numpy(),
                          np.fromfile(path, dtype=np.uint8))
    c = timing.COUNTS
    assert c["parse.bytes"] == size
    assert c["parse.read.chunks"] == -(-size // parse.READ_CHUNK)
    assert c["parse.read.threads"] > 1
    assert set(parse.LAST_READ) == {"bytes", "read_s", "stage_s",
                                    "total_s"}
    assert "parse.read.file" in timing.SPANS
