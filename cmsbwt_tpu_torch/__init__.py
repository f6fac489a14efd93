"""cmsbwt_tpu_torch — the PyTorch/CUDA port of cmsbwt_tpu.

Mirrors the JAX package's module paths and function names. The slice
ported so far is the ``jump`` scan (a hand-written CUDA kernel,
kernels/csrc/ms_jump_scan.cu) feeding the device merge
(engine/device_merge.py), driven by engine/pipeline.compute_bwt and the
CLI. Every entry point takes an explicit ``device``; nothing falls back
from ``cuda`` to ``cpu``.
"""
from cmsbwt_tpu.config import Config

__all__ = ["Config", "compute_bwt"]


def compute_bwt(cfg, device):
    from .engine.pipeline import compute_bwt as _impl
    return _impl(cfg, device)
