"""The port's sharded reference index (cmsbwt_tpu_torch/parallel/
sharded_index.py) at R = 1, 2 and 4 gloo ranks: SA, ISA, LCP, PLCP and BWT
against the JAX package's sharded build over R virtual devices and
against index/host.build_reference_index, on random, repetitive and
one-letter references; and the giant-reference route under
CMSBWT_GIANT_THRESHOLD=500 through the port's CLI on R ranks, byte-equal
to the normal route in plain and -r, the index cached, and the int32
backends refused. All cases of one R run in one spawn (tests/torch_ranks.
index_cases). Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import make_inputs, mutate, random_dna
from cmsbwt_tpu.config import Config as JaxConfig
from cmsbwt_tpu.engine.pipeline import compute_bwt as jax_compute_bwt
from cmsbwt_tpu.parallel.sharded_index import \
    build_sharded_reference_index as jax_build
from cmsbwt_tpu_torch import cli
from cmsbwt_tpu_torch.config import Config
from cmsbwt_tpu_torch.engine.pipeline import compute_bwt
from cmsbwt_tpu_torch.index.host import build_reference_index
from cmsbwt_tpu_torch.io.fasta import augment_reference
from cmsbwt_tpu_torch.parallel.sharded_index import \
    build_sharded_reference_index
from torch_ranks import index_cases, run

torch.set_num_threads(1)

RS = [1, 2, 4]
REFS = {"random": lambda: random_dna(np.random.default_rng(11), 700),
        "repetitive": lambda: b"ACGTTGCA" * 60 + b"ACG",
        "one_letter": lambda: b"A" * 257}
_GOT: dict = {}


def _x(name: str) -> np.ndarray:
    return np.frombuffer(augment_reference(REFS[name]()), np.uint8)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The CLI's input, its bytes through the port's normal route, and the
    JAX package's giant route (CMSBWT_GIANT_THRESHOLD=500)."""
    tmp = tmp_path_factory.mktemp("giant")
    rng = np.random.default_rng(12)
    ref = random_dna(rng, 900)
    lst, _, _ = make_inputs(tmp, ref, [mutate(rng, ref, 0.02)
                                       for _ in range(4)])
    for tag, fmt in (("normal", []), ("normal_rle", ["-r"])):
        assert cli.main([str(lst), "-o", str(tmp / tag), "--device", "cpu",
                         "--backend", "dense", *fmt]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CMSBWT_GIANT_THRESHOLD", "500")
        for tag, rle in (("jax", False), ("jax_rle", True)):
            jax_compute_bwt(JaxConfig(filename=str(lst), rle=rle,
                                      outname=str(tmp / tag),
                                      index_cache_dir=""))
    return tmp, lst


def _port(R: int, work, monkeypatch):
    if R not in _GOT:
        tmp, lst = work
        monkeypatch.setenv("CMSBWT_GIANT_THRESHOLD", "500")
        monkeypatch.setenv("CMSBWT_INDEX_CACHE", str(tmp / f"cache{R}"))
        argvs = [[str(lst), "-o", str(tmp / f"g{R}_{tag}{k}"), "--device",
                  "cpu", *fmt, *backend]
                 for k in (1, 2)     # twice: the second loads the cache
                 for tag, fmt in (("plain", []), ("rle", ["-r"]))
                 for backend in ([], ["--backend", "host"])
                 if k == 1 or not backend]
        out = run(index_cases, ([_x(n) for n in REFS], argvs), R)
        _GOT[R] = dict(zip(REFS, out))
    return _GOT[R]


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("name", list(REFS))
def test_sharded_index_matches_host_and_jax(work, monkeypatch, R, name):
    x = _x(name)
    (sa, isa), (sa2, isa2, lcp) = _port(R, work, monkeypatch)[name]
    host = build_reference_index(x)
    for got in (sa, sa2):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, host.sa)
    for got in (isa, isa2):
        np.testing.assert_array_equal(got, host.isa)
    np.testing.assert_array_equal(lcp, host.lcp)
    want = jax_build(x, n_devices=R)
    np.testing.assert_array_equal(sa, want.sa)
    np.testing.assert_array_equal(isa, want.isa)
    np.testing.assert_array_equal(lcp, want.lcp)


@pytest.mark.parametrize("name", list(REFS))
def test_build_sharded_reference_index(name):
    """The route's ReferenceIndex on one rank: every field the host
    builder's (PLCP and BWT included), int64 SA and ISA."""
    x = _x(name)
    idx = build_sharded_reference_index(x, device="cpu")
    host = build_reference_index(x)
    assert idx.sa.dtype == np.int64 and idx.isa.dtype == np.int64
    for f in ("sa", "isa", "lcp", "plcp", "bwt"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(host, f), f)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("fmt", ["plain", "rle"])
def test_giant_route_byte_equal(work, monkeypatch, R, fmt):
    """The giant route on R ranks (auto: the native int64 scan; host: the
    spec scan; and auto again from the cached index): the port's normal
    route's bytes and the JAX package's giant route's."""
    tmp, _ = work
    _port(R, work, monkeypatch)
    ext = ".rl_bwt" if fmt == "rle" else ".bwt"
    tag = "_rle" if fmt == "rle" else ""
    want = (tmp / f"normal{tag}{ext}").read_bytes()
    assert want == (tmp / f"jax{tag}{ext}").read_bytes()
    for k in (1, 2):
        assert (tmp / f"g{R}_{fmt}{k}{ext}").read_bytes() == want
    log = (tmp / f"g{R}_{fmt}1.log").read_text()
    assert "build_index" in log and "backend: " in log
    assert len(list((tmp / f"cache{R}").iterdir())) == 1


@pytest.mark.parametrize("backend", ["dense", "jump", "device", "native"])
def test_giant_route_rejects_int32_backends(work, monkeypatch, backend):
    """Every backend but auto and host is refused above the threshold,
    naming int32 (native: the JAX package refuses it too)."""
    tmp, lst = work
    monkeypatch.setenv("CMSBWT_GIANT_THRESHOLD", "500")
    with pytest.raises(ValueError, match="int32"):
        compute_bwt(Config(filename=str(lst), outname=str(tmp / "r"),
                           backend=backend), "cpu")
    assert not (tmp / "r.bwt").exists()
