"""cmsbwt_tpu_torch — the PyTorch/CUDA port of cmsbwt_tpu.

Mirrors the JAX package's module paths and function names, and imports
nothing of it: what it takes from framework-free modules there (the
config, FASTA parsing, the native IO bindings, the numpy writers, the
phase timer, the divergence probe) it keeps as its own copies under the
same paths. engine/pipeline.compute_bwt and the CLI drive every backend:
``auto`` (the default: on ``cuda`` the rule measured on the H100, on
``cpu`` the JAX package's), ``jump`` (a hand-written CUDA scan kernel,
kernels/csrc/ms_jump_scan.cu), ``dense`` (one joint suffix sort per block,
with the CUDA kernels kernels/csrc/lcp_lift.cu and dense_neighbors.cu;
``--parallel`` on one card scans its blocks one after another, over
several the mesh scan of parallel/mesh.py), ``device``, ``native`` and
``host``, with the device, the host or the sharded merge
(parallel/sharded_merge.py); references of 2^31 chars or more take the
sharded int64 index (parallel/sharded_index.py). The mesh routes run on
torch.distributed ranks (parallel/distributed.py).

Public API:
    Config                      run configuration (the JAX package's)
    compute_bwt(cfg, device)    file-to-file pipeline (CLI core)
    CMSBWT                      index-once / transform-many model object

Every entry point takes an explicit ``device``; nothing falls back from
``cuda`` to ``cpu``.
"""
from .config import Config

__all__ = ["CMSBWT", "Config", "compute_bwt"]


def compute_bwt(cfg, device="cuda"):
    from .engine.pipeline import compute_bwt as _impl
    return _impl(cfg, device)


def __getattr__(name):
    if name == "CMSBWT":
        from .models.cms_bwt import CMSBWT
        return CMSBWT
    raise AttributeError(name)
