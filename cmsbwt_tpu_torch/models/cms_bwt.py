"""The CMS-BWT transform as an object — the counterpart of
cmsbwt_tpu/models/cms_bwt.py.

``CMSBWT`` holds one reference and its indexes, built once and kept (the
host index for the native and host backends, the device index for the
jump and device backends), and ``transform`` computes the BWT of one
collection after another against it: one pangenome reference, many
batches of haplotypes. The jump and dense scans merge on the engine the
pipeline's rule picks from the config's merge_backend
(engine/pipeline._choose_merge: the device merge for 'auto' on a card
and for jump on the CPU, the host merge, or the sharded merge over the
mesh's ranks, engine/pipeline.merge_from_heads_sharded); the other
backends end in the host merge, as in the JAX package (whose model
always merges on the host: the engines' runs are equal). After the
device merge, ``encode`` makes the output's bytes on the runs' device
(io/output.encode_runs: the rle_pack and bwt_expand kernels on a card)
and downloads only them. It is a plain class, not a torch.nn.Module: it
holds indexes, not parameters.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import Config
from ..engine import merge as merge_mod
from ..engine import pipeline as pipeline_mod
from ..engine.ms_host import MSArrays
from ..index.host import ReferenceIndex
from ..io import fasta
from ..utils.timing import PhaseTimer, span


@dataclass
class TransformResult:
    bwt: bytes | None
    rle: bytes | None
    sn: int
    heads: int
    timer: PhaseTimer


class CMSBWT:
    """Reference-indexed BWT constructor for repetitive collections, on
    ``device`` (``cuda`` or ``cpu``; ``cuda`` without a card raises)."""

    def __init__(self, reference: bytes | str | np.ndarray,
                 config: Optional[Config] = None, device="cuda"):
        """``reference``: raw bytes, a FASTA/raw file path, or a
        pre-augmented uint8 array."""
        self.config = config or Config()
        self.device = pipeline_mod.resolve_device(device)
        with span("index.load"):
            if isinstance(reference, str):
                reference = fasta.load_reference_bytes(reference)
            if isinstance(reference, (bytes, bytearray)):
                self.x_aug = fasta.augment_reference(bytes(reference))
            else:
                self.x_aug = np.asarray(reference, dtype=np.uint8)
        self._host_index: Optional[ReferenceIndex] = None
        self._device_index = None

    @property
    def index(self) -> ReferenceIndex:
        """The host reference index, built once (on the card when the
        model runs on one, as the native backend builds it)."""
        if self._host_index is None:
            self._host_index = pipeline_mod._build_host_index_fast(
                self.x_aug, self.device)
        return self._host_index

    @property
    def device_index(self):
        """The reference index on the model's device
        (index/device.DeviceIndex), built once and reused by every jump
        and device transform."""
        if self._device_index is None:
            from ..index.device import build_device_index
            self._device_index = build_device_index(self.x_aug, self.device)
        return self._device_index

    def transform(self, collection: str | fasta.Collection,
                  rle: bool = False,
                  backend: Optional[str] = None) -> TransformResult:
        """The collection's BWT against the held reference (a path, parsed
        on the model's device, or a fasta.Collection): ``backend``
        (default the config's), 'auto' resolved by the pipeline's rule
        (engine/pipeline.auto_backend) with the collection's length in
        place of its file's size, as the JAX package resolves it here.
        The call is the span ``transform``."""
        with span("transform"):
            return self._transform(collection, rle, backend)

    def _transform(self, collection, rle: bool,
                   backend: Optional[str]) -> TransformResult:
        cfg = self.config
        if isinstance(collection, str):
            # parsed and validated on the model's device (io/parse.py)
            from ..io.parse import load_collection
            sn_limit = fasta.collection_sn_limit(collection,
                                                 cfg.prefix_length)
            coll = load_collection(collection, sn_limit, self.device,
                                   cfg.skip_window)
        else:
            coll = collection
            fasta.validate_collection(coll)
        backend = backend or cfg.backend
        if backend == "auto":
            from ..io.native import get_scan_lib
            cpu = self.device.type == "cpu"
            backend = pipeline_mod.auto_backend(
                coll.sn, self.device.type,
                cpu and get_scan_lib() is not None)
        timer = PhaseTimer()
        rq = rle and cfg.replicate_reference_rle_quirk
        buf = cfg.buffer_gib << 30
        dev = self.device
        if backend in ("dense", "jump"):
            from ..engine.device_merge import sn_bound
            engine = pipeline_mod._choose_merge(
                dataclasses.replace(cfg, backend=backend), dev, coll.sn,
                coll.sn >= sn_bound())
            with timer.phase("ms_scan"):
                if backend == "dense":
                    from ..ops.ms_dense import ms_dense_heads_on_device
                    held = [ms_dense_heads_on_device(self.x_aug, coll.sx,
                                                     dev)]
                else:
                    from ..ops.ms_jump import ms_jump_heads
                    held = [ms_jump_heads(self.x_aug, coll, dev,
                                          lanes=cfg.lanes,
                                          window=cfg.skip_window,
                                          index=self.device_index)]
            result = pipeline_mod.merge_heads(engine, self.x_aug, held, coll,
                                              rq, dev, timer, buf)
        elif backend == "device":
            from ..index.device import export_reference_index
            from ..ops.ms_device import ms_scan_device
            index = export_reference_index(self.device_index, self.x_aug)
            with timer.phase("ms_scan"):
                ms = ms_scan_device(self.device_index, coll.sx, dev,
                                    lanes=cfg.lanes, window=cfg.skip_window)
            result = pipeline_mod.compute_bwt_arrays(
                index, coll, rq, dev, timer=timer, buffer_bytes=buf,
                ms=MSArrays(pos=ms.pos, length=ms.length,
                            smaller=ms.smaller, is_head=ms.is_head))
        elif backend == "native":
            heads, _ = pipeline_mod._native_heads(self.index, coll, timer)
            result = pipeline_mod.merge_from_heads(
                self.index, heads, coll.d, coll.sn, rq, dev, timer,
                buffer_bytes=buf)
        elif backend == "host":
            result = pipeline_mod.compute_bwt_arrays(
                self.index, coll, rq, dev, timer=timer, buffer_bytes=buf)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        with timer.phase("encode"):
            if result.device_runs is not None:
                from ..io.output import encode_runs
                data = encode_runs(*result.device_runs, rle=rle,
                                   sn=result.sn)
                rle_bytes, bwt_bytes = (data, None) if rle else (None, data)
            else:
                runs = (result.run_len, result.run_char)
                rle_bytes = merge_mod.runs_to_rle(*runs) if rle else None
                bwt_bytes = None if rle else merge_mod.runs_to_plain(*runs)
        return TransformResult(bwt=bwt_bytes, rle=rle_bytes, sn=result.sn,
                               heads=result.h, timer=timer)
