"""The CMS-BWT transform as an object — the counterpart of
cmsbwt_tpu/models/cms_bwt.py.

``CMSBWT`` holds one reference and its indexes, built once at their first
use and kept (the host index for the native and host backends, the device
index for the jump and device backends), and ``transform`` computes the
BWT of one collection after another against it: one pangenome reference,
many batches of haplotypes. A transform parses the collection and runs
the CLI's route (engine/pipeline.run_collection) with the held indexes:
the same backends, guards and merge engines. The jump and dense scans
merge on the engine _choose_merge picks from the config's merge_backend
(the device merge for 'auto' on a card and for jump on the CPU, the host
merge, or the sharded merge over the mesh's ranks); the other backends
end in the host merge. The JAX package's model always merges on the host:
the engines' runs are equal. After the device merge, ``encode`` makes the
output's bytes on the runs' device (io/output.encode_runs: the rle_pack
and bwt_expand kernels on a card) and downloads only them. It is a plain
class, not a torch.nn.Module: it holds indexes, not parameters.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import Config
from ..engine import merge as merge_mod
from ..engine import pipeline as pipeline_mod
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
    ``device`` (``cuda`` or ``cpu``; ``cuda`` without a card raises). It
    is the route's ``indexes`` (engine/pipeline.run_collection): each
    index built at its first use, under no phase and with no disk cache,
    and kept."""

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
        model runs on one)."""
        return self.host_index(False)

    def host_index(self, giant: bool) -> Optional[ReferenceIndex]:
        """The host reference index, built once: a ``giant`` reference's
        is the sharded int64 build (None on a launcher's ranks other than
        0)."""
        if self._host_index is None:
            self._host_index = pipeline_mod._build_host_index_fast(
                self.x_aug, self.device, giant)
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

    def dense_fingerprint(self, coll: fasta.Collection) -> str:
        """The key of a dense transform's checkpoints (config
        checkpoint_dir): the reference's and the collection's bytes, as
        the model may hold neither as a file."""
        from ..utils.checkpoint import CheckpointManager
        return CheckpointManager.fingerprint(
            ref=hashlib.sha256(self.x_aug).hexdigest(),
            coll=hashlib.sha256(coll.sx).hexdigest(), phase="dense_heads")

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
        cfg = dataclasses.replace(self.config, rle=rle,
                                  backend=backend or self.config.backend)
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
        timer = PhaseTimer()
        _, result = pipeline_mod.run_collection(
            cfg, self.x_aug, coll, self.device, timer, self, coll.sn)
        if result is None:
            # a launcher's rank other than 0 joined the mesh steps
            return TransformResult(bwt=None, rle=None, sn=coll.sn, heads=0,
                                   timer=timer)
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
