"""End-to-end pipeline of the port — the counterpart of
cmsbwt_tpu/engine/pipeline.py:

* backend=jump: parse (io/fasta.py) -> build_device_index -> ms_jump_heads
  (the CUDA ``ms_jump_scan`` kernel on a CUDA device) -> the device merge
  (merge_heads_device_resident), the host merge (merge_from_heads) or the
  sharded merge (merge_from_heads_sharded)
* backend=dense: parse -> the ``dense_heads`` checkpoint bundle when one is
  saved, else ms_dense_heads_on_device, or ms_dense_heads_blocked_on_device
  for ``dense_block_chars``, when the memory guard finds that the unblocked
  scan does not fit, with ``dense_parallel`` on one device (the JAX
  package's block size; the blocks' order does not matter there), with
  ``checkpoint_dir`` (each finished block saved; unblocked, the whole
  collection is one block), and for collections at or above the int32
  bound (heads to the host block by block, int64 t) (joint suffix sort;
  the CUDA ``lcp_lift`` and ``dense_neighbors`` kernels on a CUDA device);
  ``dense_parallel`` over R > 1 ranks is the mesh scan
  (parallel/mesh.ms_dense_heads_mesh) -> the device, host or sharded merge
* backend=device: build_device_index -> ms_scan_device (the jump scan's
  heads expanded to every position) -> compute_bwt_arrays (the host merge)
* backend=native: the host reference index (device-built on a card,
  cached on disk) -> ms_scan_native (io/csrc/cmsbwt_scan.cpp; the spec scan
  when g++ cannot build it) -> the host merge
* backend=host: the host index (cached) -> ms_scan_collection (the
  per-phrase spec scan) -> the host merge
* backend=auto: one of the above, chosen after parsing (auto_backend): on
  ``cpu`` by the JAX package's rule, on ``cuda`` by the rule measured on
  the H100 (PERF.md §5)
* a reference at or above the giant threshold (the int32 bound, or
  CMSBWT_GIANT_THRESHOLD): the sharded int64 index
  (parallel/sharded_index.build_sharded_reference_index, cached like the
  host indexes) -> the native int64 scan (the spec scan for backend=host)
  -> the host merge; only backend auto and host run it

then _write_outputs, whose ``.log`` names the backend that ran. The device
merge's runs stay on its device, and the output file's bytes are made
there and copied into the file (io/output.write_runs); the host and
sharded merges write through the native writers. The merge
engine of the jump and dense routes follows the JAX rules with ``cuda`` in
the role of an accelerator and ``cpu`` in that of a CPU-only process
(_choose_merge); on a card, 'auto' also takes the host merge above the
device merge's memory ceiling (device_merge.MERGE_BYTES_PER_CHAR), where
merge_backend='device' is refused before the scan. 'auto' never takes the
sharded merge, as in the JAX package.

The mesh steps (the sharded index, the mesh scan, the sharded merge) run
over R ranks (parallel/distributed): a launcher's processes, or ranks this
process starts, one per visible card on ``cuda`` (one rank on ``cpu``).
Under a launcher every process runs compute_bwt; the ranks other than 0
join the mesh steps and write nothing. Nothing falls back from a device
call.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import UINT64_MAX, Config
from ..index.host import ReferenceIndex, build_reference_index
from ..io import fasta, native
from ..utils.timing import PhaseTimer, maybe_torch_trace
from . import heads as heads_mod
from . import merge as merge_mod
from . import ranking as ranking_mod
from . import tails as tails_mod
from .ms_host import MSArrays, ms_scan_collection

BACKENDS = ("jump", "dense", "device", "native", "host")
MERGE_BACKENDS = ("auto", "device", "host", "sharded")

# The JAX package's auto constants (its pipeline.py:608 and :669), measured
# on a TPU and on a CPU: below AUTO_DENSE_MIN_CHARS collection chars a
# CPU-only process scans on the host, and an auto-resolved jump scan on
# the CPU runs at most AUTO_CPU_JUMP_LANES lanes.
AUTO_DENSE_MIN_CHARS = 2_000_000
AUTO_CPU_JUMP_LANES = 1024


class PipelineResult:
    """A merge's runs and what the ``.log`` reports. ``device_runs``: the
    device merge's (run_len int32, run_char uint8) tensors where the merge
    left them, which _write_outputs encodes on their device
    (io/output.write_runs); ``run_len`` (int64) and ``run_char`` (uint8)
    are numpy arrays, downloaded from ``device_runs`` at their first
    read."""

    def __init__(self, run_len: np.ndarray | None = None,
                 run_char: np.ndarray | None = None, d: int = 0, sn: int = 0,
                 h: int = 0, counter: np.ndarray | None = None,
                 engine: str | None = None, device_runs=None):
        self._runs = (run_len, run_char)
        self.d, self.sn, self.h = d, sn, h
        self.counter = counter    # counterSmallerThanHead (debug artifact)
        self.engine = engine      # the native branch's scan engine
        self.device_runs = device_runs

    def _host_runs(self) -> tuple:
        if self._runs[0] is None and self.device_runs is not None:
            from .device_merge import download_runs
            self._runs = download_runs(*self.device_runs)
        return self._runs

    @property
    def run_len(self) -> np.ndarray:
        return self._host_runs()[0]

    @property
    def run_char(self) -> np.ndarray:
        return self._host_runs()[1]


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


def _check_route(cfg: Config, device: torch.device) -> None:
    if cfg.backend not in BACKENDS + ("auto",):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.merge_backend not in MERGE_BACKENDS:
        raise ValueError(f"unknown merge_backend {cfg.merge_backend!r}")


def load_inputs(filename: str, prefix_length: int = UINT64_MAX,
                timer: PhaseTimer | None = None):
    """The augmented reference (uint8) and the parsed, validated collection
    named by an input-list file; ``timer`` records load_reference and
    parse_collection."""
    timer = timer or PhaseTimer()
    ref_path, coll_path = fasta.read_input_list(filename)
    with timer.phase("load_reference"):
        x_aug = fasta.augment_reference(fasta.load_reference_bytes(ref_path))
    sn_limit = fasta.collection_sn_limit(coll_path, prefix_length)
    with timer.phase("parse_collection"):
        coll = fasta.parse_collection(coll_path, sn_limit)
        fasta.validate_collection(coll)
    return x_aug, coll


def compute_bwt_arrays(index: ReferenceIndex, coll: fasta.Collection,
                       rle_quirk: bool, device, ms: MSArrays | None = None,
                       timer: PhaseTimer | None = None,
                       buffer_bytes: int | None = None) -> PipelineResult:
    """Run the full CMS pipeline on in-memory arrays: ``ms`` precomputed
    (the device scan), else the host spec scan, then the host merge."""
    timer = timer or PhaseTimer()
    if ms is None:
        with timer.phase("ms_scan"):
            ms = ms_scan_collection(index, coll.sx, coll.sep_positions)
    with timer.phase("head_extract"):
        heads = heads_mod.extract_heads(index, ms, coll.sx)
    return merge_from_heads(index, heads, coll.d, coll.sn, rle_quirk, device,
                            timer, buffer_bytes=buffer_bytes)


def merge_from_heads(index: ReferenceIndex, heads, d: int, sn: int,
                     rle_quirk: bool, device,
                     timer: PhaseTimer | None = None,
                     buffer_bytes: int | None = None) -> PipelineResult:
    """The host merge engine: head fixup -> grouping -> ranking -> tail
    positioning -> run assembly, numpy plus the native OpenMP runtime
    (the head-string suffix sort on ``device`` when it is long).
    Input-agnostic: every scan produces the same head records.

    Tail bucket counts are derived from the head records: head h owns tails
    at reference positions pos_h+1 .. pos_h+to_next_h (consecutive by the
    MS sliding property), so a difference array over those spans equals the
    reference's bucketsForExpandedBWT tail tally (ref :368-377)."""
    timer = timer or PhaseTimer()
    with timer.phase("head_fixup"):
        heads_mod.fixup_heads(index, heads)
    with timer.phase("bucket_counts"):
        # bincount, not np.add.at: ~3.5x faster at tens of millions of heads
        hn = heads.to_next > 0
        hp = heads.pos[hn] + 1
        diff = np.bincount(hp, minlength=index.n + 1)[:index.n + 1]
        diff = diff.astype(np.int64)
        diff -= np.bincount(hp + heads.to_next[hn],
                            minlength=index.n + 1)[:index.n + 1]
        tails_cnt = np.cumsum(diff[:-1])
    with timer.phase("head_group"):
        classes = heads_mod.build_classes(index, heads)
    with timer.phase("head_rank"):
        ranked = ranking_mod.rank_heads(index, classes, heads, d, device)
    with timer.phase("tail_position"):
        counter = tails_mod.position_tails(index, classes, ranked,
                                           buffer_bytes=buffer_bytes)
    with timer.phase("merge"):
        run_len, run_char = merge_mod.build_runs(
            index, classes, ranked, counter, tails_cnt, d, rle_quirk)
    return PipelineResult(run_len=run_len, run_char=run_char, d=d,
                          sn=sn, h=heads.h, counter=counter)


def compute_bwt(cfg: Config, device) -> dict:
    """Full file-to-file run on ``device`` (``cuda`` or ``cpu``). Under a
    launcher's group only rank 0 writes the outputs; the other ranks join
    the mesh steps and return with ``out_path`` None."""
    device = resolve_device(device)
    _check_route(cfg, device)
    from ..parallel import distributed
    from .device_merge import sn_bound

    timer = PhaseTimer()
    outname = cfg.resolved_outname()
    x_aug, coll = load_inputs(cfg.filename, cfg.prefix_length, timer)
    n = len(x_aug)
    # references at or above the int32 index bound (the reference tool's
    # own cap, ref CMS-BWT-functions.cpp:246, CMS-BWT.h:44) take the
    # sharded int64 index; the threshold can be lowered to run the route
    # at toy scale
    giant = n >= giant_threshold()
    if giant and cfg.backend not in ("auto", "host"):
        raise ValueError(
            f"reference is {n} chars (>= the int32 index bound "
            f"{giant_threshold()}): backend={cfg.backend} uses int32 device "
            "paths (the reference tool's own cap); giant references run "
            "backend=auto or host through the sharded int64 index")
    # auto resolves after parsing, as in the JAX package
    auto = cfg.backend == "auto"
    cfg = dataclasses.replace(cfg, backend=(
        ("host" if cfg.backend == "host" or native.get_scan_lib() is None
         else "native") if giant else _resolve_backend(cfg, device)))
    # a launcher's rank other than 0: joins the mesh steps, writes nothing
    follower = distributed.process_index() != 0

    def finish(result: PipelineResult | None) -> dict:
        if follower or result is None:
            return {"out_path": None, "bytes": 0, "timer": timer,
                    "result": None, "backend": cfg.backend}
        return _write_outputs(cfg, outname, n, result, timer)

    if coll.sn == 0:
        # empty collection -> empty BWT (the reference emits nothing)
        return finish(PipelineResult(run_len=np.zeros(0, np.int64),
                                     run_char=np.zeros(0, np.uint8),
                                     d=coll.d, sn=0, h=0))
    # collections at/above the int32 bound (the reference's sn is uint64,
    # ref CMS-BWT.h:26,46) take the int64-safe route: the blocked dense
    # scan with heads assembled on the host, then the host (or sharded)
    # merge
    sn_big = coll.sn >= sn_bound()
    if sn_big:
        if cfg.merge_backend == "device":
            raise ValueError(
                f"collection has {coll.sn} chars (>= the int32 device-merge "
                f"bound {sn_bound()}): merge_backend='device' cannot run "
                "it; use merge_backend=auto/host/sharded")
        if cfg.backend in ("jump", "device") and not auto:
            raise ValueError(
                f"collection has {coll.sn} chars (>= the int32 bound "
                f"{sn_bound()}): backend={cfg.backend} uses int32 device "
                "scans; use backend=dense (blocked), native or host")
        if cfg.backend in ("jump", "device"):
            # auto's device scans: the blocked int64 route
            cfg = dataclasses.replace(cfg, backend="dense")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rq = cfg.rle and cfg.replicate_reference_rle_quirk
    buf = cfg.buffer_gib << 30
    if cfg.backend in ("host", "native"):
        if follower and not giant:
            return finish(None)
        with timer.phase("build_index"):
            index = _host_index(cfg, x_aug, device, giant)
        if index is None or follower:
            return finish(None)
        if cfg.backend == "host":
            result = compute_bwt_arrays(index, coll, rq, device, timer=timer,
                                        buffer_bytes=buf)
        else:
            heads, engine = _native_heads(index, coll, timer)
            result = merge_from_heads(index, heads, coll.d, coll.sn, rq,
                                      device, timer, buffer_bytes=buf)
            result.engine = engine
        return finish(result)
    if cfg.backend == "device":
        if follower:
            return finish(None)
        from ..index.device import build_device_index, export_reference_index
        from ..ops.ms_device import ms_scan_device
        with timer.phase("build_index"):
            dindex = build_device_index(x_aug, device)
            index = export_reference_index(dindex, x_aug)
        with timer.phase("ms_scan"), maybe_torch_trace("ms_scan"):
            dev = ms_scan_device(dindex, coll.sx, device, lanes=cfg.lanes,
                                 window=cfg.skip_window)
        del dindex
        ms = MSArrays(pos=dev.pos, length=dev.length, smaller=dev.smaller,
                      is_head=dev.is_head)
        result = compute_bwt_arrays(index, coll, rq, device, ms=ms,
                                    timer=timer, buffer_bytes=buf)
        return finish(result)

    # jump and dense: the merge engine is chosen before the scan, so that
    # a device merge the card cannot hold is refused before any work
    engine = _choose_merge(cfg, device, coll.sn, sn_big)
    ranks = distributed.n_ranks(device)
    mesh_scan = cfg.backend == "dense" and cfg.dense_parallel and ranks > 1
    if follower and not mesh_scan and engine != "sharded":
        return finish(None)
    heads = None
    if cfg.backend == "dense" and (mesh_scan or not follower):
        heads = _dense_heads(cfg, device, x_aug, coll, sn_big, timer, sync,
                             ranks)
    elif not follower:
        from ..index.device import build_device_index
        from ..ops.ms_jump import ms_jump_heads
        with timer.phase("build_index"):
            dindex = build_device_index(x_aug, device)
            sync()
        lanes = cfg.lanes
        if auto and device.type == "cpu":
            # the JAX rule: the accelerator's lane default over-subscribes
            # the CPU (AUTO_CPU_JUMP_LANES)
            lanes = min(lanes, AUTO_CPU_JUMP_LANES)
        with maybe_torch_trace("ms_scan"):
            heads = ms_jump_heads(x_aug, coll.sx, device, lanes=lanes,
                                  window=cfg.skip_window, index=dindex,
                                  timer=timer)
        del dindex
    if engine != "sharded" and (follower or heads is None):
        return finish(None)
    held = [heads]
    del heads
    return finish(merge_heads(engine, x_aug, held, coll, rq, device, timer,
                              buf, want_counter=n < cfg.small_ref_threshold))


def merge_heads(engine: str, x_aug: np.ndarray, held: list, coll, rq: bool,
                device, timer: PhaseTimer, buffer_bytes: int,
                want_counter: bool = False) -> PipelineResult | None:
    """The jump and dense routes' merge on ``engine`` (_choose_merge) of
    the heads in ``held`` (a one-item list, emptied here so that the
    heads' memory goes once they are no longer needed): a DeviceHeadsResult
    or a host DenseHeadsResult, None on the sharded merge's other ranks.

    'sharded': merge_from_heads_sharded. 'host': the heads downloaded and
    merged by merge_from_heads. 'device': the heads uploaded when on the
    host, merged where they lie (phase ``merge_device``), the runs left on
    the device (PipelineResult.device_runs)."""
    from ..ops.ms_dense import DenseHeadsResult
    heads = held.pop()
    n = len(x_aug)
    if engine == "sharded":
        return merge_from_heads_sharded(x_aug, heads, coll.d, coll.sn, rq,
                                        device, timer)
    if engine == "host":
        if not isinstance(heads, DenseHeadsResult):
            heads = download_heads_result(heads, n)
        index, hh = dense_result_to_inputs(x_aug, heads)
        del heads
        return merge_from_heads(index, hh, coll.d, coll.sn, rq, device,
                                timer, buffer_bytes=buffer_bytes)
    from .device_merge import merge_heads_device_resident
    if isinstance(heads, DenseHeadsResult):
        heads = upload_heads_result(heads, n, device)
    with timer.phase("merge_device"), maybe_torch_trace("merge_device"):
        run_len, run_char, counter = merge_heads_device_resident(
            heads, coll.d, rq, want_counter=want_counter)
    return PipelineResult(d=coll.d, sn=coll.sn, h=heads.h, counter=counter,
                          device_runs=(run_len, run_char))


def merge_from_heads_sharded(x_aug: np.ndarray, dres, d: int, sn: int,
                             rle_quirk: bool, device,
                             timer: PhaseTimer | None = None,
                             n_devices: int | None = None
                             ) -> PipelineResult | None:
    """The downstream merge sharded over a group of ranks
    (parallel/sharded_merge.py), phase ``merge_sharded``: every stage a
    sample-sort join or a routed collective with int64 keys, so no device
    holds the whole head set and collections past the int32 device
    merge's bound are safe. ``dres`` is rank 0's DeviceHeadsResult or host
    DenseHeadsResult (None on the other ranks, which get None back)."""
    from ..parallel.sharded_merge import merge_heads_sharded
    timer = timer or PhaseTimer()
    fields = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
              "ref_sa", "ref_isa", "ref_bwt")
    arrays = [getattr(dres, f) if dres is not None else None for f in fields]
    h = dres.h if dres is not None else 0
    with timer.phase("merge_sharded"), maybe_torch_trace("merge_sharded"):
        out = merge_heads_sharded(*arrays, h, len(x_aug), sn, d, rle_quirk,
                                  n_devices=n_devices, device=device)
    if out is None:
        return None
    return PipelineResult(run_len=out[0], run_char=out[1], d=d, sn=sn, h=h,
                          counter=None)


def giant_threshold() -> int:
    """Reference length at which the int32 index paths stop and the sharded
    int64 index takes over: the int32 bound, or CMSBWT_GIANT_THRESHOLD
    (the JAX package's variable, which runs the route at toy scale)."""
    return int(os.environ.get("CMSBWT_GIANT_THRESHOLD", 1 << 31))


def _choose_merge(cfg: Config, device: torch.device, sn: int,
                  sn_big: bool) -> str:
    """The merge engine of a jump or dense run, 'device', 'host' or
    'sharded' (only when asked for, and then even for the int64 route, as
    in the JAX package: the sharded merge is int64-safe): the JAX
    package's rules (its pipeline.py:269-280, 366, 466, 635-663) with
    ``cuda`` in the role of an accelerator and ``cpu`` in that of a
    CPU-only process. CMSBWT_MERGE_BACKEND=host|device overrides auto.
    Auto on ``cpu`` is the host merge, except on the jump route, whose
    heads are device-resident; auto on ``cuda`` is the device merge. (The
    JAX package's SARS-shape rule, the host merge for jump with a
    reference under 1 M chars and a collection over 16 times it, measured
    on a TPU, does not hold on the H100: at the bench's sars_stream shape
    the jump CLI ran in 0.65-0.71 s with the device merge against
    1.02-1.12 s with the host merge, and in 2.30-2.39 s against 2.97-3.17
    s at its 80 M-char cut; PERF.md §5.) The int64 route always merges on
    the host. On a card a device merge above the memory ceiling is auto's
    host merge, and a refusal when it was asked for."""
    from ..ops.ms_dense import free_device_bytes
    from .device_merge import merge_fits, merge_memory_check
    if cfg.merge_backend == "sharded":
        return "sharded"
    if sn_big:
        return "host"
    engine = cfg.merge_backend
    forced = os.environ.get("CMSBWT_MERGE_BACKEND")
    auto = engine == "auto" and forced not in ("host", "device")
    if engine == "auto":
        if not auto:
            engine = forced
        elif device.type == "cpu":
            engine = "device" if cfg.backend == "jump" else "host"
        else:
            engine = "device"
    if engine == "device" and device.type == "cuda":
        free = free_device_bytes(device)
        if auto and not merge_fits(sn, free):
            return "host"
        merge_memory_check(sn, free)
    return engine


def auto_backend(coll_chars: int, device_type: str, native_ok: bool) -> str:
    """The backend ``auto`` runs, from what a run knows once its inputs
    are parsed: the collection file's chars (cut to the prefix), the
    device type and whether the native scan library is built.

    ``cpu`` is the JAX package's rule for a CPU-only process, decision for
    decision (its pipeline.py:735-749): the native scan when the library
    is built, else the host spec scan below AUTO_DENSE_MIN_CHARS and the
    jump scan above it; no probe.

    ``cuda`` is the rule read off the route table measured on the H100
    (PERF.md §5, tools/profile_slice.py --routes): the jump scan with the
    device merge ran the CLI fastest at every shape measured, from 1.6 M
    to 500 M collection chars, 0.1% to 10% SNP, and a 30 Kbp reference
    under 25 M and 80 M chars. Dense came closest at 5% and 10% SNP,
    about 0.1 s behind, which at 5% is inside the spread between calls:
    both spend 0.85-1.64 s there in the same merge, and the jump scan
    phase took 20-32 ms against the dense scan's 95-116 ms. Native was
    1.3-8 times slower everywhere. So neither the divergence probe nor the
    native library changes the choice, nor do sn and n, and the JAX
    package's accelerator rule (the native scan below the probe's 0.72,
    else dense: TPU measurements) is not copied. Collections of 2^31
    chars or more take the blocked dense scan in compute_bwt, as the JAX
    package turns its device routes there."""
    if device_type == "cpu":
        if native_ok:
            return "native"
        return "host" if coll_chars < AUTO_DENSE_MIN_CHARS else "jump"
    return "jump"


def _resolve_backend(cfg: Config, device: torch.device) -> str:
    """cfg.backend, or auto_backend's choice for 'auto' (the native
    library is looked up, and built, only where the rule reads it: on the
    CPU)."""
    if cfg.backend != "auto":
        return cfg.backend
    _, coll_path = fasta.read_input_list(cfg.filename)
    coll_chars = min(os.path.getsize(coll_path), cfg.prefix_length)
    native_ok = device.type == "cpu" and native.get_scan_lib() is not None
    return auto_backend(coll_chars, device.type, native_ok)


def _dense_heads(cfg: Config, device, x_aug: np.ndarray, coll, sn_big: bool,
                 timer: PhaseTimer, sync, ranks: int = 1):
    """The dense route's heads: the ``dense_heads`` bundle of a
    checkpoint directory when one is saved there (by either package; no
    scan), else the scan, whose result is saved as that bundle with the
    JAX package's keys, dtypes and slicing. A DeviceHeadsResult, or a host
    DenseHeadsResult for a loaded bundle, for the int64 route and for the
    mesh scan (dense_parallel over ``ranks`` > 1; None on the ranks other
    than 0)."""
    from ..ops import ms_dense as md
    from ..utils.checkpoint import CheckpointManager
    from .device_merge import sn_bound
    n, sn = len(x_aug), coll.sn
    mgr = fp = bundle = None
    if cfg.checkpoint_dir:
        mgr = CheckpointManager(cfg.checkpoint_dir)
        fp = _dense_fingerprint(cfg)
        bundle = mgr.load("dense_heads", fp)
        if cfg.dense_parallel and ranks > 1:
            if not _rank0_says(device, bundle is not None):
                bundle = None        # every rank joins the mesh scan
            elif bundle is None:
                return None          # rank 0 loads the bundle, no scan runs
    block_chars, ctx = cfg.dense_block_chars, cfg.dense_ctx_chars
    if block_chars is None and bundle is None:
        # memory guard: above the budget the scan streams in blocks
        block_chars = md.dense_block_chars(n, sn, md.dense_budget(device))
        if cfg.dense_parallel:
            # the JAX pipeline's per-device block (its pipeline.py:333-340):
            # sn over the ranks, capped by the phrase-chunk cap and by the
            # guard's block (each rank's card holds one block at a time)
            par = max(min(-(-sn // ranks), cfg.chunk_cap_bytes // 8),
                      1 << 16)
            block_chars = min(block_chars, par) if block_chars else par
    if sn_big:
        # int64-safe route: per-block scans stay under the int32 bound
        # while the global head t is assembled in int64 on the host
        cap = max(min(cfg.chunk_cap_bytes // 8, sn_bound() // 2), 1 << 12)
        block_chars = min(block_chars, cap) if block_chars else cap
    with timer.phase("ms_scan"), maybe_torch_trace("ms_scan"):
        if bundle is not None:
            h, sn_b, rho = (int(bundle.pop(k))
                            for k in ("h", "sn", "irreducible"))
            return md.DenseHeadsResult(h=h, sn=sn_b, irreducible=rho,
                                       **bundle)
        blocks = None
        if mgr is not None:
            if block_chars is None:
                block_chars, ctx = sn, 0   # the unblocked scan's window
            blocks = md.BlockCheckpoints(cfg.checkpoint_dir, fp, block_chars)
        if cfg.dense_parallel and ranks > 1:
            from ..parallel.mesh import ms_dense_heads_mesh
            heads = ms_dense_heads_mesh(x_aug, coll.sx, block_chars, ctx,
                                        device=device, checkpoint=blocks)
        elif block_chars:
            heads = md.ms_dense_heads_blocked_on_device(
                x_aug, coll.sx, device, block_chars, ctx, blocks,
                to_host=sn_big)
        else:
            heads = md.ms_dense_heads_on_device(x_aug, coll.sx, device)
        sync()
        if mgr is not None and heads is not None:
            dl = (heads if isinstance(heads, md.DenseHeadsResult)
                  else download_heads_result(heads, n))
            mgr.save("dense_heads", fp, {
                "head_t": dl.head_t, "head_pos": dl.head_pos,
                "head_len": dl.head_len, "head_smaller": dl.head_smaller,
                "head_char": dl.head_char, "ref_sa": dl.ref_sa,
                "ref_isa": dl.ref_isa, "ref_bwt": dl.ref_bwt,
                "h": np.int64(dl.h), "sn": np.int64(dl.sn),
                "irreducible": np.int64(dl.irreducible)})
    return heads


def _rank0_says(device, local: bool) -> bool:
    """Rank 0's ``local`` on every rank of a launcher's group, ``local``
    itself without one: whether a cache or checkpoint file is there must be
    one answer for all ranks, or their mesh steps' collectives part ways
    (rank 0 may save the file while another rank looks for it)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return local
    from ..parallel import distributed
    from ..parallel.dist import bcast_object
    return bool(bcast_object(distributed.current(device),
                             local if distributed.is_primary() else None))


def _native_heads(index: ReferenceIndex, coll, timer: PhaseTimer):
    """Heads of the native OpenMP PLCP-skip scan (io/csrc/cmsbwt_scan.cpp),
    or of the host spec scan when g++ cannot build it (host code either
    way); returns (HeadArrays, the engine that ran)."""
    with timer.phase("ms_scan"):
        res = native.ms_scan_native(
            index.x_padded, index.sa, index.isa, index.lcp, index.plcp,
            index.n, coll.sx, coll.sep_positions)
        if res is None:
            ms = ms_scan_collection(index, coll.sx, coll.sep_positions)
            return heads_mod.extract_heads(index, ms, coll.sx), "host_spec"
        t, pos, ln, sml = res
        z = lambda: np.zeros(len(t), np.int64)
        char = coll.sx[(t - 1) % max(coll.sn, 1)]
        return heads_mod.HeadArrays(
            t=t, pos=pos, length=ln, smaller=sml, char=char, to_next=z(),
            isa_next=z(), succ=z(), h=len(t)), "native"


def _host_index(cfg: Config, x_aug: np.ndarray, device,
                giant: bool = False) -> ReferenceIndex | None:
    """The host ReferenceIndex of the host and native backends, through
    the on-disk cache (the checkpoint directory when given, else
    Config.resolved_index_cache_dir()): the JAX package's directory and
    fingerprint, so the two packages share it. A ``giant`` reference's is
    the sharded int64 build over the mesh's ranks, which returns it on
    rank 0 and None on the others."""
    from ..utils.checkpoint import CheckpointManager, file_stamp
    cache_root = cfg.checkpoint_dir or cfg.resolved_index_cache_dir()
    mgr = fp = None
    if cache_root:
        ref_path, _ = fasta.read_input_list(cfg.filename)
        mgr = CheckpointManager(cache_root)
        fp = mgr.fingerprint(ref=file_stamp(ref_path), giant=giant,
                             phase="ref_index")
        cached = mgr.load("ref_index", fp)
        hit = cached is not None
        if giant:
            hit = _rank0_says(device, hit)
        if hit:
            # a rank that missed rank 0's fresh save: rank 0 goes on alone
            return (_index_from_arrays(x_aug, cached) if cached is not None
                    else None)
    if giant:
        from ..parallel.sharded_index import build_sharded_reference_index
        index = build_sharded_reference_index(x_aug, device=device)
    elif cfg.backend == "native":
        index = _build_host_index_fast(x_aug, device)
    else:
        index = build_reference_index(x_aug)
    if mgr is not None and index is not None:
        mgr.save("ref_index", fp, {
            "sa": index.sa, "isa": index.isa, "lcp": index.lcp,
            "plcp": index.plcp, "bwt": index.bwt})
    return index


def _build_host_index_fast(x_aug: np.ndarray, device) -> ReferenceIndex:
    """Host ReferenceIndex for the native scan engine: built on the card
    (device doubling + one download) when the run is on ``cuda``, else on
    the host."""
    if device.type == "cuda":
        from ..index.device import build_reference_index_device
        return build_reference_index_device(x_aug, device)
    return build_reference_index(x_aug)


def _index_from_arrays(x_aug: np.ndarray, arrays: dict) -> ReferenceIndex:
    """ReferenceIndex from a ref_index cache bundle (rank_history is a
    build intermediate — no downstream consumer, not persisted)."""
    return ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=len(x_aug), sa=arrays["sa"], isa=arrays["isa"],
        lcp=arrays["lcp"], plcp=arrays["plcp"], bwt=arrays["bwt"],
        rank_history=[])


def download_heads_result(dres, n: int):
    """Device-resident DeviceHeadsResult -> host DenseHeadsResult: head
    arrays sliced to h (int64 t, pos, len), reference arrays sliced to n
    (the host merge expects unpadded arrays)."""
    from ..ops.ms_dense import DenseHeadsResult
    h = dres.h
    cpu = lambda a, k: a[:k].cpu().numpy()
    return DenseHeadsResult(
        head_t=cpu(dres.head_t, h).astype(np.int64),
        head_pos=cpu(dres.head_pos, h).astype(np.int64),
        head_len=cpu(dres.head_len, h).astype(np.int64),
        head_smaller=cpu(dres.head_smaller, h),
        head_char=cpu(dres.head_char, h).astype(np.uint8),
        ref_sa=cpu(dres.ref_sa, n), ref_isa=cpu(dres.ref_isa, n),
        ref_bwt=cpu(dres.ref_bwt, n), h=h, sn=dres.sn,
        irreducible=dres.irreducible)


def upload_heads_result(dl, n: int, device):
    """Host DenseHeadsResult -> DeviceHeadsResult in merge layout: heads
    zero-padded to bucket_size(h + 1), the reference to bucket_size(n + 1)
    (the pads of the JAX package's merge_heads_numpy)."""
    from ..ops.ms_dense import DeviceHeadsResult
    from ..utils.buckets import bucket_size
    h_pad, n_pad = bucket_size(dl.h + 1), bucket_size(n + 1)

    def pad(a, size, dtype):
        out = torch.zeros(size, dtype=dtype, device=device)
        out[:len(a)] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)
        return out
    i32 = torch.int32
    return DeviceHeadsResult(
        head_t=pad(dl.head_t, h_pad, i32), head_pos=pad(dl.head_pos, h_pad, i32),
        head_len=pad(dl.head_len, h_pad, i32),
        head_smaller=pad(dl.head_smaller, h_pad, torch.bool),
        head_char=pad(dl.head_char, h_pad, torch.uint8),
        ref_sa=pad(dl.ref_sa, n_pad, i32), ref_isa=pad(dl.ref_isa, n_pad, i32),
        ref_bwt=pad(dl.ref_bwt, n_pad, torch.uint8), h=dl.h, n=n, sn=dl.sn,
        irreducible=dl.irreducible)


def dense_result_to_inputs(x_aug: np.ndarray, dres):
    """(ReferenceIndex, HeadArrays) of the host merge from a host
    DenseHeadsResult."""
    index = ReferenceIndex(
        x=x_aug,
        x_padded=np.concatenate([x_aug, np.zeros(1, np.uint8)]),
        n=len(x_aug), sa=dres.ref_sa, isa=dres.ref_isa,
        lcp=np.zeros(len(x_aug) + 1, np.int32),
        plcp=np.zeros(len(x_aug), np.int32),
        bwt=dres.ref_bwt, rank_history=[])
    heads = heads_mod.HeadArrays(
        t=dres.head_t, pos=dres.head_pos, length=dres.head_len,
        smaller=dres.head_smaller, char=dres.head_char,
        to_next=np.zeros(dres.h, np.int64),
        isa_next=np.zeros(dres.h, np.int64),
        succ=np.zeros(dres.h, np.int64), h=dres.h)
    return index, heads


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
    """The output file, the counter debug artifact and the ``.log``: the
    phases, then sn, heads, D, the backend that ran and the native
    branch's scan engine."""
    # small-path debug artifact (ref :919-924, written unconditionally by
    # the small-reference variant)
    if n < cfg.small_ref_threshold and result.counter is not None:
        with open(outname + ".counterSmallerThanHead_true", "wb") as f:
            f.write(result.counter.astype("<u8").tobytes())

    with timer.phase("write_output"):
        out_path = outname + (".rl_bwt" if cfg.rle else ".bwt")
        if result.device_runs is not None:
            # the device merge's runs: the file's bytes made on their
            # device and copied into the file
            from ..io.output import write_runs
            nbytes = write_runs(out_path, *result.device_runs, rle=cfg.rle,
                                sn=result.sn)
        elif (native.write_rle_native(out_path, result.run_len,
                                      result.run_char)
              if cfg.rle else
              native.write_plain_native(out_path, result.run_len,
                                        result.run_char)):
            nbytes = os.path.getsize(out_path)
        else:  # numpy writers when no C++ toolchain is present
            data = (merge_mod.runs_to_rle if cfg.rle
                    else merge_mod.runs_to_plain)(result.run_len,
                                                  result.run_char)
            wb = max(int(cfg.write_buffer_bytes), 1 << 12)
            with open(out_path, "wb") as f:
                for i in range(0, len(data), wb):  # ref's 1 MiB buffer (:943)
                    f.write(data[i:i + wb])
            nbytes = len(data)
    with open(outname + ".log", "w") as f:
        f.write(timer.report())
        f.write(f"\nsn: {result.sn}\nheads: {result.h}\nD: {result.d}\n")
        f.write(f"backend: {cfg.backend}\n")
        if result.engine:
            f.write(f"scan_engine: {result.engine}\n")
    return {"out_path": out_path, "bytes": nbytes, "timer": timer,
            "result": result, "backend": cfg.backend}
