"""End-to-end pipeline of the port — the counterpart of
cmsbwt_tpu/engine/pipeline.py, for the routes ported so far:

* backend=jump: parse (io/fasta.py) -> build_device_index ->
  ms_jump_heads (the CUDA ``ms_jump_scan`` kernel on a CUDA device) ->
  merge_heads_device_resident -> _write_outputs
* backend=dense, one device: parse -> ms_dense_heads_on_device, or
  ms_dense_heads_blocked_on_device with ``dense_block_chars``, when the
  memory guard finds that the unblocked scan does not fit, or with
  ``checkpoint_dir`` (each finished block saved there; unblocked, the
  whole collection is one block) (joint suffix sort; the CUDA ``lcp_lift``
  and ``dense_neighbors`` kernels on a CUDA device) ->
  merge_heads_device_resident -> _write_outputs

On a CUDA device a collection whose merge would not fit the card's free
memory is refused before the scan (device_merge.merge_memory_check).

Other backends, merge engines and options raise NotImplementedError naming
their ROADMAP.md entry; nothing silently routes elsewhere.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..config import UINT64_MAX, Config
from ..io import fasta, native
from ..utils.timing import PhaseTimer, maybe_torch_trace
from .merge import runs_to_plain, runs_to_rle

_NOT_PORTED = {
    "auto": "queue 1 item 5 (the auto dispatch)",
    "device": "queue 1 item 10 (ops/ms_device.py)",
    "host": "queue 1 item 9 (the host and native routes)",
    "native": "queue 1 item 9 (the host and native routes)",
    "sharded": "queue 1 item 11 (multi-device)",
}


@dataclass
class PipelineResult:
    run_len: np.ndarray
    run_char: np.ndarray
    d: int
    sn: int
    h: int
    counter: np.ndarray | None = None  # counterSmallerThanHead (debug artifact)


def resolve_device(device) -> torch.device:
    """The device a run was asked for. ``cuda`` without a usable CUDA
    device is an error, never a switch to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain torch route")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev


def _check_route(cfg: Config) -> None:
    if cfg.backend not in ("jump", "dense"):
        raise NotImplementedError(
            f"backend={cfg.backend!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED.get(cfg.backend, 'queue 1')}; use backend='jump' "
            "or 'dense'")
    if cfg.merge_backend not in ("device", "auto"):
        raise NotImplementedError(
            f"merge_backend={cfg.merge_backend!r} is not ported yet: "
            f"ROADMAP.md {_NOT_PORTED.get(cfg.merge_backend, 'queue 1')}; "
            "use merge_backend='device'")
    if cfg.dense_parallel:
        raise NotImplementedError(
            "dense_parallel is not ported yet: ROADMAP.md queue 1 item 11 "
            "(multi-device)")


def load_inputs(filename: str, prefix_length: int = UINT64_MAX,
                timer: PhaseTimer | None = None):
    """The augmented reference (uint8) and the parsed, validated collection
    named by an input-list file; ``timer`` records load_reference and
    parse_collection."""
    timer = timer or PhaseTimer()
    ref_path, coll_path = fasta.read_input_list(filename)
    with timer.phase("load_reference"):
        x_aug = fasta.augment_reference(fasta.load_reference_bytes(ref_path))
    n = len(x_aug)
    if n >= 1 << 31:
        raise ValueError(
            f"reference is {n} chars (>= the int32 index bound): the "
            "sharded int64 index is not ported yet (ROADMAP.md queue 1 "
            "item 11)")
    sn_limit = fasta.collection_sn_limit(coll_path, prefix_length)
    with timer.phase("parse_collection"):
        coll = fasta.parse_collection(coll_path, sn_limit)
        fasta.validate_collection(coll)
    return x_aug, coll


def compute_bwt(cfg: Config, device) -> dict:
    """Full file-to-file run on ``device`` (``cuda`` or ``cpu``)."""
    device = resolve_device(device)
    _check_route(cfg)
    from ..index.device import build_device_index
    from ..ops.ms_jump import ms_jump_heads
    from .device_merge import (merge_heads_device_resident,
                               merge_memory_check, sn_bound)

    timer = PhaseTimer()
    outname = cfg.resolved_outname()
    x_aug, coll = load_inputs(cfg.filename, cfg.prefix_length, timer)
    n = len(x_aug)
    if coll.sn == 0:
        # empty collection -> empty BWT (the reference emits nothing)
        result = PipelineResult(run_len=np.zeros(0, np.int64),
                                run_char=np.zeros(0, np.uint8),
                                d=coll.d, sn=0, h=0)
        return _write_outputs(cfg, outname, n, result, timer)
    if coll.sn >= sn_bound():
        raise ValueError(
            f"collection has {coll.sn} chars (>= the int32 bound "
            f"{sn_bound()}): backend={cfg.backend} uses int32 device scans "
            "and the device merge; the int64 route (blocked scan + host "
            "merge) is not ported yet (ROADMAP.md queue 1 item 9)")

    if device.type == "cuda":
        # the merge is not blocked: refuse what it cannot hold before the
        # scan runs
        merge_memory_check(coll.sn, torch.cuda.mem_get_info(device)[0])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if cfg.backend == "dense":
        from ..ops import ms_dense as md
        block_chars, ctx = cfg.dense_block_chars, cfg.dense_ctx_chars
        if block_chars is None:
            # memory guard: above the budget the scan streams in blocks
            block_chars = md.dense_block_chars(n, coll.sn,
                                               md.dense_budget(device))
        ckpt = None
        if cfg.checkpoint_dir:
            if block_chars is None:
                block_chars, ctx = coll.sn, 0   # the unblocked scan's window
            ckpt = md.BlockCheckpoints(cfg.checkpoint_dir,
                                       _dense_fingerprint(cfg), block_chars)
        with timer.phase("ms_scan"), maybe_torch_trace("ms_scan"):
            if block_chars:
                heads = md.ms_dense_heads_blocked_on_device(
                    x_aug, coll.sx, device, block_chars, ctx, ckpt)
            else:
                heads = md.ms_dense_heads_on_device(x_aug, coll.sx, device)
            sync()
    else:
        with timer.phase("build_index"):
            dindex = build_device_index(x_aug, device)
            sync()
        with maybe_torch_trace("ms_scan"):
            heads = ms_jump_heads(x_aug, coll.sx, device, lanes=cfg.lanes,
                                  window=cfg.skip_window, index=dindex,
                                  timer=timer)
        del dindex
    rq = cfg.rle and cfg.replicate_reference_rle_quirk
    with timer.phase("merge_device"), maybe_torch_trace("merge_device"):
        run_len, run_char, counter = merge_heads_device_resident(
            heads, coll.d, rq, want_counter=n < cfg.small_ref_threshold)
    result = PipelineResult(run_len=run_len, run_char=run_char, d=coll.d,
                            sn=coll.sn, h=heads.h, counter=counter)
    return _write_outputs(cfg, outname, n, result, timer)


def _dense_fingerprint(cfg: Config) -> str:
    """The JAX pipeline's checkpoint fingerprint of a dense run (its
    pipeline.py:327-330): the two input files' stamps and the prefix."""
    from ..utils.checkpoint import CheckpointManager, file_stamp
    ref_path, coll_path = fasta.read_input_list(cfg.filename)
    return CheckpointManager.fingerprint(
        ref=file_stamp(ref_path), coll=file_stamp(coll_path),
        prefix=cfg.prefix_length, phase="dense_heads")


def _write_outputs(cfg: Config, outname: str, n: int,
                   result: PipelineResult, timer: PhaseTimer) -> dict:
    # small-path debug artifact (ref :919-924, written unconditionally by
    # the small-reference variant)
    if n < cfg.small_ref_threshold and result.counter is not None:
        with open(outname + ".counterSmallerThanHead_true", "wb") as f:
            f.write(result.counter.astype("<u8").tobytes())

    with timer.phase("write_output"):
        out_path = outname + (".rl_bwt" if cfg.rle else ".bwt")
        wrote = (native.write_rle_native(out_path, result.run_len,
                                         result.run_char)
                 if cfg.rle else
                 native.write_plain_native(out_path, result.run_len,
                                           result.run_char))
        if wrote:
            nbytes = os.path.getsize(out_path)
        else:  # numpy writers when no C++ toolchain is present
            data = (runs_to_rle if cfg.rle else runs_to_plain)(
                result.run_len, result.run_char)
            wb = max(int(cfg.write_buffer_bytes), 1 << 12)
            with open(out_path, "wb") as f:
                for i in range(0, len(data), wb):  # ref's 1 MiB buffer (:943)
                    f.write(data[i:i + wb])
            nbytes = len(data)
    with open(outname + ".log", "w") as f:
        f.write(timer.report())
        f.write(f"\nsn: {result.sn}\nheads: {result.h}\nD: {result.d}\n")
    return {"out_path": out_path, "bytes": nbytes, "timer": timer,
            "result": result, "backend": cfg.backend}
