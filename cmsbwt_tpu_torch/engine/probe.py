"""Divergence probe of the ``auto`` dispatch — the port's copy of
cmsbwt_tpu/engine/probe.py (numpy only; the same float result).

The probe estimates divergence without an index: the fraction of sampled
collection k-mers absent from the reference's k-mer set. With SNP rate s
and k-mer length k it is about 1 - (1 - s)^k (k = 24: 0.1% SNP -> ~2.4%,
1% -> ~21%, 5% -> ~71%). Cost: one pass over the reference plus a
65536-sample gather.

A measurement helper in the port: tools/profile_slice.py --routes prints
it beside each shape. No routing rule reads it: the JAX package's
accelerator rule does (through its cached ``_probe_cached``), but the
H100's rule (engine/pipeline.auto_backend) came out the same at every
divergence measured, so the pipeline neither runs nor caches it.
"""
from __future__ import annotations

import numpy as np

_B = np.uint64(1099511628211)  # FNV-ish odd multiplier (wraparound mod 2^64)


def _kmer_hashes_sliding(x: np.ndarray, k: int) -> np.ndarray:
    """Polynomial hashes of every length-k window of ``x`` (vectorized)."""
    n = len(x)
    if n < k:
        return np.zeros(0, np.uint64)
    h = np.zeros(n - k + 1, np.uint64)
    for j in range(k):
        h = h * _B + x[j: n - k + 1 + j].astype(np.uint64)
    return h


def kmer_absent_fraction(x_aug: np.ndarray, sx: np.ndarray, k: int = 24,
                         samples: int = 1 << 16,
                         ref_cap: int = 8 << 20) -> float | None:
    """Fraction of sampled collection k-mers absent from the reference,
    or None when the probe does not apply (tiny or huge inputs)."""
    n = len(x_aug)
    sn = len(sx)
    if n > ref_cap or n < 4 * k or sn < 4 * k:
        return None
    ref_h = np.sort(_kmer_hashes_sliding(np.asarray(x_aug), k))
    m = min(samples, sn - k + 1)
    pos = np.linspace(0, sn - k, m).astype(np.int64)
    win = np.asarray(sx)[pos[:, None] + np.arange(k)[None, :]]
    h = np.zeros(m, np.uint64)
    for j in range(k):
        h = h * _B + win[:, j].astype(np.uint64)
    idx = np.searchsorted(ref_h, h)
    idx = np.clip(idx, 0, len(ref_h) - 1)
    present = ref_h[idx] == h
    return float(1.0 - present.mean())
