"""The device writer: a device merge's runs made into the output file's
bytes where they lie, then copied into the file.

The device merge (engine/device_merge.merge_device) leaves its run list on
its device, merged: run_len int32[R] (every length > 0) and run_char
uint8[R] (neighbouring chars differ). For that list the writers' record
rule (engine/merge.runs_to_rle: adjacent equal chars merged, empty runs
skipped, the tool's prevChar = 0 start, R = 0 as the single (0, 0) record)
is one record a run, so

* ``rle_pack(run_len, run_char)`` -> uint8[9 * max(R, 1)]: the .rl_bwt,
  each record a uint64-LE length followed by the char;
* ``bwt_expand(run_len, run_char, sn)`` -> uint8[sn]: the .bwt, each run's
  char repeated its length (engine/merge.runs_to_plain), the lengths
  summing to the collection's sn.

Each picks by the device of its tensors: the CUDA kernels of
``kernels/csrc/run_output.cu`` for CUDA tensors, the plain torch versions
``rle_pack_reference`` / ``bwt_expand_reference`` (counted in
``REFERENCE_CALLS``) for CPU tensors. Both check what the record rule
relies on and raise on a list that breaks it (a length <= 0, two
neighbours of one char, lengths that do not sum to sn), before any byte
reaches a file.

``copy_out(buf, sink)`` brings a device buffer to the host through a
pinned staging pair made once per process (2 x STAGE_BYTES): chunk k + 1
is copied on a side stream while ``sink`` takes chunk k, so the file
write overlaps the copy and nothing but the staging pair is pinned.
``write_runs`` writes the file that way and ``encode_runs`` returns the
bytes (the model API); ``LAST_WRITE`` keeps the last call's runs, bytes
and times.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

# one staging buffer; two are pinned per process. Pinning is paid by the
# first write of every process (each CLI run): 2 x 64 MiB took ~80 ms on
# the H100's host (PERF.md), and a 16 MiB chunk still moves at the
# copy's rate while the file write of the chunk before it runs
STAGE_BYTES = 16 << 20
REC = 9                  # an .rl_bwt record: uint64 LE length, char
LEN_FAULT, CHAR_FAULT, SUM_FAULT = 1, 2, 4   # run_output.cu's fault bits

# calls of the plain versions (the CUDA wrappers keep their own launch
# counts in kernels.LAUNCHES)
REFERENCE_CALLS = {"rle_pack_reference": 0, "bwt_expand_reference": 0}
# the last write_runs / encode_runs: runs, bytes, the kernel's ms (its
# launch to its fault word's read), the copy's s (host clock) and of it
# the staging pair's making (stage_s; 0 after a process's first write)
LAST_WRITE: dict = {}

_lock = threading.Lock()
_staging: dict = {}


def check_fault(fault, what: str) -> None:
    """Raise if a run list broke the record rule (``fault``, the kernel's
    or the plain version's fault word; reading it waits for the kernel)."""
    f = int(fault.reshape(-1)[0])
    if not f:
        return
    why = []
    if f & LEN_FAULT:
        why.append("a run length is not positive")
    if f & CHAR_FAULT:
        why.append("two neighbouring runs have the same char")
    if f & SUM_FAULT:
        why.append("the run lengths do not sum to the collection's length")
    raise RuntimeError(f"{what}: the run list is not the device merge's "
                       f"merged list ({'; '.join(why)}); no output written")


def rle_pack(run_len: torch.Tensor, run_char: torch.Tensor) -> torch.Tensor:
    """The .rl_bwt of a merged run list, on the device of its tensors: the
    CUDA kernel for CUDA tensors, ``rle_pack_reference`` for CPU tensors.
    Raises if the list is not merged."""
    dev = run_len.device.type
    if dev == "cuda":
        from ..kernels import rle_pack_cuda
        out, fault = rle_pack_cuda(run_len, run_char)
    elif dev == "cpu":
        out, fault = rle_pack_reference(run_len, run_char)
    else:
        raise ValueError(f"rle_pack: unsupported device {dev!r}")
    check_fault(fault, "rle_pack")
    return out


def bwt_expand(run_len: torch.Tensor, run_char: torch.Tensor,
               sn: int) -> torch.Tensor:
    """The .bwt of a merged run list whose lengths sum to ``sn``, on the
    device of its tensors: the CUDA kernel for CUDA tensors,
    ``bwt_expand_reference`` for CPU tensors. Raises if a length is not
    positive or the lengths do not sum to sn."""
    dev = run_len.device.type
    if int(run_len.shape[0]) == 0 or sn == 0:
        if int(run_len.shape[0]) or sn:
            raise RuntimeError(
                f"bwt_expand: {int(run_len.shape[0])} runs for {sn} chars; "
                "no output written")
        return torch.empty(0, dtype=torch.uint8, device=run_len.device)
    if dev == "cuda":
        from ..kernels import bwt_expand_cuda
        out, fault = bwt_expand_cuda(run_len, run_char, sn)
    elif dev == "cpu":
        out, fault = bwt_expand_reference(run_len, run_char, sn)
    else:
        raise ValueError(f"bwt_expand: unsupported device {dev!r}")
    check_fault(fault, "bwt_expand")
    return out


def rle_pack_reference(run_len: torch.Tensor, run_char: torch.Tensor):
    """Plain torch on any device: (uint8[9 * max(R, 1)], fault int32[1])
    as the kernel gives them: a record a run (the merged list's
    runs_to_rle), the single (0, 0) record for R = 0; fault bit 0 where a
    length is not positive, bit 1 where a char equals its predecessor's."""
    REFERENCE_CALLS["rle_pack_reference"] += 1
    dev = run_len.device
    R = int(run_len.shape[0])
    fault = (LEN_FAULT * int(bool((run_len <= 0).any()))
             | CHAR_FAULT * int(bool((run_char[1:] == run_char[:-1]).any())))
    out = torch.zeros(max(R, 1), REC, dtype=torch.uint8, device=dev)
    if R:
        ln = run_len.to(torch.int64)
        shifts = 8 * torch.arange(8, dtype=torch.int64, device=dev)
        # the uint64 length's bytes, low first (a negative length as its
        # two's complement, as the kernel writes it)
        out[:, :8] = ((ln[:, None] >> shifts[None, :]) & 0xFF).to(
            torch.uint8)
        out[:, 8] = run_char
    return out.reshape(-1), torch.tensor([fault], dtype=torch.int32,
                                         device=dev)


def bwt_expand_reference(run_len: torch.Tensor, run_char: torch.Tensor,
                         sn: int):
    """Plain torch on any device: (uint8[sn], fault int32[1]) as the
    kernel gives them: each run's char repeated its length
    (runs_to_plain); fault bit 0 where a length is not positive, bit 2
    when the lengths do not sum to sn (the bytes are then cut or padded
    with zeros to sn)."""
    REFERENCE_CALLS["bwt_expand_reference"] += 1
    dev = run_len.device
    ln = run_len.to(torch.int64)
    fault = (LEN_FAULT * int(bool((ln <= 0).any()))
             | SUM_FAULT * int(int(ln.sum()) != sn))
    out = torch.zeros(sn, dtype=torch.uint8, device=dev)
    body = torch.repeat_interleave(run_char, torch.clamp(ln, min=0))[:sn]
    out[:body.numel()] = body
    return out, torch.tensor([fault], dtype=torch.int32, device=dev)


def _stage(dev: torch.device) -> dict:
    """The pinned staging pair, its events and a side stream for ``dev``,
    made at first use and kept for the process."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    with _lock:
        st = _staging.get(key)
        LAST_WRITE["stage_s"] = 0.0
        if st is None:
            t0 = time.perf_counter()
            with torch.cuda.device(key):
                st = {"bufs": [torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                           pin_memory=True)
                               for _ in range(2)],
                      "done": [torch.cuda.Event() for _ in range(2)],
                      "stream": torch.cuda.Stream(),
                      # one copy at a time through the pair
                      "lock": threading.Lock()}
            _staging[key] = st
            LAST_WRITE["stage_s"] = time.perf_counter() - t0
        return st


def copy_out(buf: torch.Tensor, sink) -> int:
    """Hand the bytes of a contiguous uint8 tensor to ``sink`` (one call a
    chunk, each a memoryview valid during the call), in order; returns
    their count. A CUDA tensor goes through the pinned staging pair:
    chunk k + 1 is copied on a side stream while ``sink`` takes chunk k.
    A CPU tensor is handed over in chunks of STAGE_BYTES."""
    n = int(buf.numel())
    if buf.device.type != "cuda":
        view = memoryview(buf.numpy())
        for off in range(0, n, STAGE_BYTES):
            sink(view[off:off + STAGE_BYTES])
        return n
    st = _stage(buf.device)
    side = st["stream"]
    chunks = (n + STAGE_BYTES - 1) // STAGE_BYTES

    def enqueue(k):
        off = k * STAGE_BYTES
        m = min(STAGE_BYTES, n - off)
        with torch.cuda.stream(side):
            st["bufs"][k % 2][:m].copy_(buf[off:off + m], non_blocking=True)
            st["done"][k % 2].record(side)

    with st["lock"]:
        # the side stream copies what the current stream has written
        side.wait_stream(torch.cuda.current_stream(buf.device))
        buf.record_stream(side)
        if chunks:
            enqueue(0)
        for k in range(chunks):
            if k + 1 < chunks:
                # its buffer held chunk k - 1, which sink has taken
                enqueue(k + 1)
            st["done"][k % 2].synchronize()
            m = min(STAGE_BYTES, n - k * STAGE_BYTES)
            sink(memoryview(st["bufs"][k % 2].numpy())[:m])
    return n


def encode(run_len: torch.Tensor, run_char: torch.Tensor, rle: bool,
           sn: int) -> torch.Tensor:
    """The output file's bytes of a merged run list on its device:
    rle_pack's records (``rle``) or bwt_expand's chars; recorded in
    LAST_WRITE."""
    t0 = time.perf_counter()
    buf = (rle_pack(run_len, run_char) if rle
           else bwt_expand(run_len, run_char, sn))
    LAST_WRITE.clear()
    LAST_WRITE.update(runs=int(run_len.shape[0]), bytes=int(buf.numel()),
                      rle=rle, encode_ms=(time.perf_counter() - t0) * 1e3)
    return buf


def write_runs(path: str, run_len: torch.Tensor, run_char: torch.Tensor,
               rle: bool, sn: int) -> int:
    """Write the .rl_bwt (``rle``) or .bwt of a merged run list to
    ``path``: encoded where the runs lie, then copied into the file
    (copy_out). Returns the file's size."""
    buf = encode(run_len, run_char, rle, sn)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        n = copy_out(buf, f.write)
    LAST_WRITE["copy_s"] = time.perf_counter() - t0
    return n


def encode_runs(run_len: torch.Tensor, run_char: torch.Tensor, rle: bool,
                sn: int) -> bytes:
    """The .rl_bwt (``rle``) or .bwt bytes of a merged run list, encoded
    where the runs lie and brought to the host through copy_out."""
    buf = encode(run_len, run_char, rle, sn)
    t0 = time.perf_counter()
    host = np.empty(int(buf.numel()), dtype=np.uint8)
    at = [0]

    def take(chunk):
        host[at[0]:at[0] + len(chunk)] = np.frombuffer(chunk, np.uint8)
        at[0] += len(chunk)
    copy_out(buf, take)
    LAST_WRITE["copy_s"] = time.perf_counter() - t0
    return host.tobytes()
