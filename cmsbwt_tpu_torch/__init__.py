"""cmsbwt_tpu_torch — the PyTorch/CUDA port of cmsbwt_tpu.

Mirrors the JAX package's module paths and function names, and imports
nothing of it: what it takes from framework-free modules there (the
config, FASTA parsing, the native IO bindings, the numpy writers, the
phase timer) it keeps as its own copies under the same paths. Two routes
are ported, each feeding the device merge (engine/device_merge.py) and
driven by engine/pipeline.compute_bwt and the CLI:

* ``jump`` (the default): the head-jumping scan over a reference index, a
  hand-written CUDA kernel (kernels/csrc/ms_jump_scan.cu);
* ``dense``: one joint suffix sort of reference and collection (unblocked),
  with the CUDA kernels kernels/csrc/lcp_lift.cu and dense_neighbors.cu.

Every entry point takes an explicit ``device``; nothing falls back from
``cuda`` to ``cpu``.
"""
from .config import Config

__all__ = ["Config", "compute_bwt"]


def compute_bwt(cfg, device):
    from .engine.pipeline import compute_bwt as _impl
    return _impl(cfg, device)
