"""The port's device index (cmsbwt_tpu_torch/index/device.py) equals the
JAX package's field by field, dtype included. Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import random_dna
from torch_cases import assert_same, to_torch
from cmsbwt_tpu.index import device as jdev
from cmsbwt_tpu.io.fasta import augment_reference
from cmsbwt_tpu_torch.index import device as tdev

torch.set_num_threads(1)


def _text(n, augment, seed=0):
    rng = np.random.default_rng(seed + n)
    x = np.frombuffer(random_dna(rng, n), np.uint8)
    return np.frombuffer(augment_reference(x.tobytes()), np.uint8) \
        if augment else x.copy()


@pytest.mark.parametrize("n,augment", [
    (1, False), (2, False), (3, False), (64, False),  # incl. a power of two
    (257, True), (1000, True)])
def test_build_device_index_matches_jax(n, augment):
    x = _text(n, augment)
    j = jdev.build_device_index(x)
    t = tdev.build_device_index(x, "cpu")
    assert t.n == j.n
    for f in tdev.FIELDS:
        assert_same(getattr(j, f), getattr(t, f), f)


@pytest.mark.parametrize("n", [2, 128, 700])
def test_suffix_array_history_matches_jax(n):
    """Doubling with an early-breaking host loop: SA, ISA, every history
    row and k_star equal the lax.cond-skipping JAX scan."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 3, size=n).astype(np.int32)  # repetitive alphabet
    sa, isa, hist, k_star = jdev.suffix_array_device(x, n)
    tsa, tisa, thist, tk = tdev.suffix_array_device(to_torch(x), n)
    assert_same(sa, tsa, "sa")
    assert_same(isa, tisa, "isa")
    assert_same(hist, thist, "history")
    assert int(k_star) == tk


def test_psv_nsv_match_jax():
    x = _text(500, True, seed=3)
    j = jdev.build_device_index(x)
    rng = np.random.default_rng(9)
    i = rng.integers(0, j.n, size=200).astype(np.int32)
    ub = rng.integers(0, 12, size=200).astype(np.int32)
    t = tdev.build_device_index(x, "cpu")
    assert_same(jdev.psv_device(j.jump, i, ub, j.n),
                tdev.psv_device(t.jump, to_torch(i), to_torch(ub), t.n), "psv")
    assert_same(jdev.nsv_device(j.jump, i, ub, j.n),
                tdev.nsv_device(t.jump, to_torch(i), to_torch(ub), t.n), "nsv")


def test_index_from_numpy_round_trips_jax_fields():
    x = _text(300, True, seed=5)
    j = jdev.build_device_index(x)
    arrays = {f: np.asarray(getattr(j, f)) for f in tdev.FIELDS}
    t = tdev.index_from_numpy(arrays, "cpu")
    assert t.n == j.n
    for f in tdev.FIELDS:
        assert_same(arrays[f], getattr(t, f), f)
