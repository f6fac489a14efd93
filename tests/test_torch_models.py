"""The port's model API (cmsbwt_tpu_torch/models/cms_bwt.py, ``CMSBWT``)
against the JAX package's: the twins of tests/test_models.py's three tests
on the CPU; every backend's bytes (plain and run-length) equal to those of
the JAX package's CMSBWT on the same reference and collection; each index
built once over several transforms; the sharded merge after the jump and
dense scans; the package exports CMSBWT lazily, as the JAX package does. Inputs are made with numpy from seeds. Tolerance:
exact bytes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import brute_multidoc_bwt, make_fasta, mutate, random_dna
from cmsbwt_tpu.models.cms_bwt import CMSBWT as JaxCMSBWT
from cmsbwt_tpu_torch import CMSBWT
from cmsbwt_tpu_torch.config import Config
from cmsbwt_tpu_torch.io import fasta

torch.set_num_threads(1)


def test_model_transform_matches_oracle(tmp_path):
    rng = np.random.default_rng(0)
    ref = random_dna(rng, 300)
    docs = [mutate(rng, ref, 0.02) for _ in range(3)]
    coll_path = tmp_path / "c.fa"
    coll_path.write_bytes(make_fasta(docs))
    model = CMSBWT(ref, device="cpu")
    res = model.transform(str(coll_path))
    coll = fasta.parse_collection(str(coll_path), 1 << 60)
    assert res.bwt == brute_multidoc_bwt(coll.sx)
    # reuse the same index for a second collection
    docs2 = [mutate(rng, ref, 0.01)]
    p2 = tmp_path / "c2.fa"
    p2.write_bytes(make_fasta(docs2))
    res2 = model.transform(str(p2), rle=True)
    assert res2.rle is not None and res2.bwt is None
    assert res2.rle == JaxCMSBWT(ref).transform(str(p2), rle=True).rle


def test_model_dense_backend(tmp_path):
    rng = np.random.default_rng(1)
    ref = random_dna(rng, 250)
    docs = [mutate(rng, ref, 0.02) for _ in range(2)]
    coll_path = tmp_path / "c.fa"
    coll_path.write_bytes(make_fasta(docs))
    model = CMSBWT(ref, device="cpu")
    a = model.transform(str(coll_path), backend="host")
    b = model.transform(str(coll_path), backend="dense")
    assert a.bwt == b.bwt


def test_model_jump_backend(tmp_path):
    """CMSBWT.transform honors backend='jump' (head-jumping scan into the
    shared merge engine); bytes match the host backend."""
    rng = np.random.default_rng(21)
    ref = random_dna(rng, 600)
    docs = [mutate(rng, ref, 0.01) for _ in range(3)]
    coll_path = tmp_path / "coll.fa"
    with open(coll_path, "wb") as f:
        for i, d in enumerate(docs):
            f.write(b">d%d\n" % i + d + b"\n")
    model = CMSBWT(ref, device="cpu")
    base = model.transform(str(coll_path), backend="host").bwt
    assert model.transform(str(coll_path), backend="jump").bwt == base


# the JAX jump scan on the CPU at its 4096-lane default takes ~15 s here;
# the bytes do not depend on the lanes (both models read only attributes
# of the config)
LANES8 = Config(lanes=8, skip_window=16)


def _collection(tmp_path, seed, dup=False):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, 700)
    docs = [mutate(rng, ref, 0.004) for _ in range(5)]
    if dup:
        docs[2] = docs[1]
    coll_path = tmp_path / f"c{seed}.fa"
    coll_path.write_bytes(make_fasta(docs))
    return ref, str(coll_path)


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("backend", [None, "host", "native", "jump", "dense",
                                     "device"])
def test_transform_matches_jax(tmp_path, backend, rle):
    """Each backend (None: the config's auto) against the JAX package's
    CMSBWT.transform with the same backend: the same bytes, sn and head
    count."""
    ref, coll = _collection(tmp_path, 5, dup=True)
    want = JaxCMSBWT(ref, LANES8).transform(coll, rle=rle, backend=backend)
    got = CMSBWT(ref, LANES8, device="cpu").transform(coll, rle=rle,
                                                     backend=backend)
    assert (got.bwt, got.rle, got.sn, got.heads) == \
        (want.bwt, want.rle, want.sn, want.heads)


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("backend", ["jump", "dense"])
def test_transform_sharded_merge_matches_jax(tmp_path, backend, rle):
    """merge_backend='sharded' in the config: the jump and dense
    transforms merge on the sharded merge's ranks (one on the CPU) and
    give the JAX package's CMSBWT bytes (which always merges on the
    host)."""
    ref, coll = _collection(tmp_path, 5, dup=True)
    cfg = Config(lanes=8, skip_window=16, merge_backend="sharded")
    want = JaxCMSBWT(ref, LANES8).transform(coll, rle=rle, backend=backend)
    got = CMSBWT(ref, cfg, device="cpu").transform(coll, rle=rle,
                                                  backend=backend)
    assert (got.bwt, got.rle, got.sn, got.heads) == \
        (want.bwt, want.rle, want.sn, want.heads)
    assert "merge_sharded" in got.timer.report()


@pytest.mark.parametrize("backends,index", [
    (("jump", "device", "jump"), "device"), (("native", "host"), "host")])
def test_index_built_once(tmp_path, monkeypatch, backends, index):
    """The device index (jump, device) and the host index (native, host)
    are built once and kept across transforms of two collections."""
    from cmsbwt_tpu_torch.engine import pipeline as tpl
    from cmsbwt_tpu_torch.index import device as idev
    ref, c1 = _collection(tmp_path, 5)
    _, c2 = _collection(tmp_path, 6)
    builds = []
    mod, name = ((idev, "build_device_index") if index == "device"
                 else (tpl, "_build_host_index_fast"))
    orig = getattr(mod, name)

    def spy(*a, **kw):
        builds.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(mod, name, spy)
    model = CMSBWT(ref, LANES8, device="cpu")
    jax_model = JaxCMSBWT(ref, LANES8)
    for be in backends:
        for coll in (c1, c2):
            assert model.transform(coll, backend=be).bwt == \
                jax_model.transform(coll, backend=be).bwt
    assert builds == [1]


def test_cmsbwt_is_exported_lazily():
    import cmsbwt_tpu_torch
    from cmsbwt_tpu_torch.models.cms_bwt import CMSBWT as direct
    assert cmsbwt_tpu_torch.CMSBWT is direct
    with pytest.raises(AttributeError):
        cmsbwt_tpu_torch.NoSuchName


def test_cuda_model_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CMSBWT(b"ACGTACGT")
