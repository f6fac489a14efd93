"""The port's ``auto`` dispatch (cmsbwt_tpu_torch/engine/pipeline.py) and
divergence probe (engine/probe.py) against the JAX package's: the probe's
absent fraction exactly, the None cases included; the cpu branch of
auto_backend against JAX's _resolve_backend decision for decision over a
grid of collection sizes with the native library on and off; the cuda
branch against the route table measured on the H100 (PERF.md §5), with
no native library looked up; auto end to end on the CPU, bytes equal to
the JAX package's auto run, with the jump scan's lanes capped at
AUTO_CPU_JUMP_LANES; the resolved backend returned and named in the
.log. Inputs are made with numpy from seeds. Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import make_inputs, mutate, random_dna
from cmsbwt_tpu.config import Config as JaxConfig
from cmsbwt_tpu.engine import pipeline as jpl
from cmsbwt_tpu.engine import probe as jprobe
from cmsbwt_tpu.engine.pipeline import compute_bwt as jax_compute_bwt
from cmsbwt_tpu.io import native as jnative
from cmsbwt_tpu_torch.config import Config
from cmsbwt_tpu_torch.engine import pipeline as tpl
from cmsbwt_tpu_torch.engine import probe as tprobe
from cmsbwt_tpu_torch.engine.pipeline import compute_bwt
from cmsbwt_tpu_torch.io import native as tnative
from torch_cases import CASE_IDS, CASES, case_collection

torch.set_num_threads(1)

ART = ".counterSmallerThanHead_true"


@pytest.mark.parametrize("cid", CASE_IDS)
@pytest.mark.parametrize("k,samples", [(24, 1 << 16), (8, 100), (31, 7)])
def test_probe_matches_jax(cid, k, samples):
    x, sx = case_collection(dict(zip(CASE_IDS, CASES))[cid])
    want = jprobe.kmer_absent_fraction(x, sx, k=k, samples=samples)
    got = tprobe.kmer_absent_fraction(x, sx, k=k, samples=samples)
    assert want is not None and type(got) is float and got == want
    np.testing.assert_array_equal(tprobe._kmer_hashes_sliding(x, k),
                                  jprobe._kmer_hashes_sliding(x, k))


@pytest.mark.parametrize("case", ["short_ref", "short_coll", "over_cap",
                                  "at_cap"])
def test_probe_none_cases_match_jax(case):
    """None where the probe does not apply: a reference or collection
    under 4k chars, a reference over ref_cap."""
    x, sx = case_collection(CASES[0])
    kw = {"short_ref": dict(x=x[:95]), "short_coll": dict(sx=sx[:95]),
          "over_cap": dict(ref_cap=len(x) - 1),
          "at_cap": dict(ref_cap=len(x))}[case]
    args = dict(x_aug=kw.pop("x", x), sx=kw.pop("sx", sx), **kw)
    want = jprobe.kmer_absent_fraction(**args)
    assert tprobe.kmer_absent_fraction(**args) == want
    assert (want is None) == (case != "at_cap")


def test_auto_constants_match_jax():
    assert tpl.AUTO_DENSE_MIN_CHARS == jpl.AUTO_DENSE_MIN_CHARS
    assert tpl.AUTO_CPU_JUMP_LANES == jpl.AUTO_CPU_JUMP_LANES
    assert Config().probe_threshold == JaxConfig().probe_threshold


@pytest.mark.parametrize("native_ok", [True, False], ids=["native", "no_lib"])
@pytest.mark.parametrize("coll_chars", [
    0, 10_000, jpl.AUTO_DENSE_MIN_CHARS - 1, jpl.AUTO_DENSE_MIN_CHARS,
    20_000_011, 500_000_101])
def test_cpu_branch_matches_jax(monkeypatch, coll_chars, native_ok):
    """The cpu branch is the JAX package's rule for a CPU-only process:
    JAX's _resolve_backend (on this process's CPU devices) with its native
    library made present or absent."""
    monkeypatch.setattr(jnative, "get_scan_lib",
                        lambda: object() if native_ok else None)
    want = jpl._resolve_backend("auto", coll_chars)
    assert tpl.auto_backend(coll_chars, "cpu", native_ok) == want


# PERF.md §5's route table: each shape's collection chars as auto reads
# them (the file's size, cut to the -p prefix) and the route that ran the
# CLI fastest there on the H100 (tools/profile_slice.py --routes)
CUDA_TABLE = {
    "small_200Kbp_x8": (1_626_720, "jump"),
    "toy_lowdiv": (10_166_730, "jump"),
    "primary": (20_333_400, "jump"),
    "primary_snp5": (20_333_400, "jump"),
    "sars_stream": (25_000_000, "jump"),
    "sars_full": (80_000_000, "jump"),
    "500M": (508_334_090, "jump"),
}


@pytest.mark.parametrize("native_ok", [True, False], ids=["native", "no_lib"])
@pytest.mark.parametrize("shape", list(CUDA_TABLE))
def test_cuda_branch_holds_the_route_table(shape, native_ok):
    """On the card auto takes the table's fastest route at every shape,
    whether or not the native library is built (it is not looked up)."""
    chars, fastest = CUDA_TABLE[shape]
    assert tpl.auto_backend(chars, "cuda", native_ok) == fastest


def test_cuda_auto_builds_no_native_library(tmp_path, monkeypatch):
    """auto on a card never looks the native library up (nor builds it
    with g++): the rule does not read it."""
    def looked_up():
        raise AssertionError("auto on cuda looked up the native library")
    monkeypatch.setattr(tnative, "get_scan_lib", looked_up)
    lst, _ = _inputs(tmp_path)
    cfg = Config(filename=str(lst))
    assert tpl._resolve_backend(cfg, torch.device("cuda")) == "jump"


@pytest.mark.parametrize("backend", ["jump", "dense", "device", "native",
                                     "host"])
def test_explicit_backend_is_not_resolved(tmp_path, backend):
    lst, _ = _inputs(tmp_path)
    for dev in ("cpu", "cuda"):
        assert tpl._resolve_backend(Config(filename=str(lst),
                                           backend=backend),
                                    torch.device(dev)) == backend


def _inputs(tmp_path, seed=5, ref_len=700, docs=5):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, ref_len)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.004) for _ in range(docs)])
    return lst, ref


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("native_ok", [True, False], ids=["native", "no_lib"])
def test_auto_end_to_end_matches_jax(tmp_path, monkeypatch, native_ok, rle):
    """compute_bwt(Config(backend='auto'), 'cpu'): the JAX package's auto
    choice (native, or the host spec scan without the library, at this
    size), its bytes and debug artifact; the resolved backend is returned
    and named in the .log."""
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", str(tmp_path / "cache"))
    if not native_ok:
        monkeypatch.setattr(jnative, "get_scan_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_scan_lib", lambda: None)
    lst, _ = _inputs(tmp_path)
    want = jax_compute_bwt(JaxConfig(filename=str(lst), rle=rle,
                                     outname=str(tmp_path / "j")))
    got = compute_bwt(Config(filename=str(lst), rle=rle,
                             outname=str(tmp_path / "t")), "cpu")
    assert got["backend"] == want["backend"] == \
        ("native" if native_ok else "host")
    ext = ".rl_bwt" if rle else ".bwt"
    for e in (ext, ART):
        assert (tmp_path / ("t" + e)).read_bytes() == \
            (tmp_path / ("j" + e)).read_bytes(), e
    assert f"backend: {got['backend']}\n" in (tmp_path / "t.log").read_text()


def test_auto_jump_caps_cpu_lanes(tmp_path, monkeypatch):
    """tests/test_round2_aux.py's auto -> jump case (AUTO_DENSE_MIN_CHARS
    lowered to 1, no native library): the port's auto run scans with
    min(lanes, AUTO_CPU_JUMP_LANES) = 1024 lanes (an explicit jump run
    keeps its lanes), and its bytes equal the JAX package's auto run."""
    from cmsbwt_tpu_torch.ops import ms_jump
    for mod in (jpl, tpl):
        monkeypatch.setattr(mod, "AUTO_DENSE_MIN_CHARS", 1)
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "get_scan_lib", lambda: None)
    lanes = []
    orig = ms_jump.ms_jump_heads

    def spy(*a, **kw):
        lanes.append(kw["lanes"])
        return orig(*a, **kw)
    monkeypatch.setattr(ms_jump, "ms_jump_heads", spy)
    lst, _ = _inputs(tmp_path, seed=21, ref_len=600, docs=3)
    want = jax_compute_bwt(JaxConfig(filename=str(lst),
                                     outname=str(tmp_path / "j")))
    got = compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t")),
                      "cpu")
    compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "e"),
                       backend="jump"), "cpu")
    assert got["backend"] == want["backend"] == "jump"
    assert lanes == [1024, Config().lanes]
    assert (tmp_path / "t.bwt").read_bytes() == \
        (tmp_path / "j.bwt").read_bytes() == \
        (tmp_path / "e.bwt").read_bytes()
