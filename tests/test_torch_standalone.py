"""The port stands alone: with ``jax``, ``jaxlib`` and the JAX package
``cmsbwt_tpu`` refused by a meta-path finder, a fresh interpreter imports
every module of cmsbwt_tpu_torch (the auto probe, the model API, the
--parallel loop and the mesh modules among them) and runs ``python -m cmsbwt_tpu_torch --device
cpu`` on the jump and dense backends and the default (auto) in both
formats, the dense backend blocked with per-block checkpoints and with
--parallel, jump and dense with --merge-backend sharded, and the routes
of the host
merge (the host, native and device backends, --merge-backend host after
jump and dense); the bytes equal the JAX package's outputs on the same
input. The port's Config keeps the JAX Config's fields and defaults.
Tolerance: exact bytes."""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import make_inputs, mutate, random_dna
from cmsbwt_tpu import cli as jax_cli
from cmsbwt_tpu.config import Config as JaxConfig
from cmsbwt_tpu_torch.config import Config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

REFUSE = '''
import importlib.abc, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cmsbwt_tpu"):
            raise ImportError(f"{name}: refused (the port stands alone)")
        return None
sys.meta_path.insert(0, _Refuse())
'''


def _run(code: str, cwd, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", REFUSE + code, *args],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r


def test_every_module_imports_without_jax(tmp_path):
    r = _run('''
import pkgutil
import cmsbwt_tpu_torch
names = ["cmsbwt_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(cmsbwt_tpu_torch.__path__,
                                          "cmsbwt_tpu_torch.")
    if not m.name.endswith(".__main__")]   # runs the CLI: see below
for name in names:
    __import__(name)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "cmsbwt_tpu")]
print("IMPORTED", len(names), " ".join(names))
''', tmp_path)
    assert "IMPORTED" in r.stdout
    for name in ("engine.probe", "models.cms_bwt", "parallel.blocked",
                 "parallel.distributed", "parallel.dist", "parallel.mesh",
                 "parallel.sharded_merge", "parallel.sharded_index"):
        assert f" cmsbwt_tpu_torch.{name}" in r.stdout, name
    n = int(r.stdout.split("IMPORTED")[1].split()[0])
    sources = [f for f in (ROOT / "cmsbwt_tpu_torch").rglob("*.py")
               if f.name != "__main__.py"]
    assert n == len(sources)   # every module of the package


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("backend", ["jump", "dense", "dense_blocked",
                                     "auto", "dense_parallel",
                                     "jump_sharded", "dense_sharded"])
def test_cli_without_jax_matches_jax_cli(tmp_path, backend, rle):
    rng = np.random.default_rng(11)
    ref = random_dna(rng, 500)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.01) for _ in range(4)])
    fmt = ["-r"] if rle else []
    ext = ".rl_bwt" if rle else ".bwt"
    # the blocked scan with per-block checkpoints (utils/checkpoint.py)
    blocked = lambda who: ["--block-chars", "700", "--checkpoint-dir",
                           str(tmp_path / f"ck_{who}")]
    port_flags, jax_flags = fmt, fmt
    if backend == "dense_blocked":
        backend = "dense"
        port_flags, jax_flags = fmt + blocked("port"), fmt + blocked("jax")
    elif backend == "dense_parallel":
        backend = "dense"
        port_flags = jax_flags = fmt + ["--parallel", "--block-chars", "700"]
    elif backend.endswith("_sharded"):
        # the port's sharded merge on one rank; JAX's device merge, whose
        # bytes its tests hold equal to its sharded merge's
        backend = backend.split("_")[0]
        port_flags = fmt + ["--merge-backend", "sharded"]
        jax_flags = fmt + ["--merge-backend", "device"]
    backend_flags = [] if backend == "auto" else ["--backend", backend]
    _run('''
import runpy
sys.argv = ["cmsbwt_tpu_torch", *sys.argv[1:]]
try:
    runpy.run_module("cmsbwt_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), e.code
''', tmp_path, str(lst), "-o", str(tmp_path / "port"), "--device", "cpu",
         *backend_flags, "--lanes", "8", *port_flags)
    assert jax_cli.main([str(lst), "-o", str(tmp_path / "jax"),
                         *backend_flags, "--lanes", "8", *jax_flags]) == 0
    port = (tmp_path / ("port" + ext)).read_bytes()
    assert len(port) > 0
    assert port == (tmp_path / ("jax" + ext)).read_bytes()


@pytest.mark.parametrize("backend,merge_backend", [
    ("host", "auto"), ("native", "auto"), ("device", "auto"),
    ("jump", "host"), ("dense", "host")],
    ids=["host", "native", "device", "jump-host", "dense-host"])
def test_host_merge_routes_without_jax(tmp_path, monkeypatch, backend,
                                       merge_backend):
    from cmsbwt_tpu.engine.pipeline import compute_bwt as jax_compute_bwt
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", str(tmp_path / "cache"))
    rng = np.random.default_rng(12)
    ref = random_dna(rng, 500)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.01) for _ in range(4)])
    _run('''
from cmsbwt_tpu_torch.cli import main
assert main(sys.argv[1:]) == 0
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "cmsbwt_tpu")]
''', tmp_path, str(lst), "-o", str(tmp_path / "port"), "--device", "cpu",
         "--backend", backend, "--merge-backend", merge_backend, "--lanes",
         "8")
    jax_compute_bwt(JaxConfig(filename=str(lst), outname=str(tmp_path / "jax"),
                              backend=backend, merge_backend=merge_backend,
                              lanes=8, index_cache_dir=""))
    port = (tmp_path / "port.bwt").read_bytes()
    assert len(port) > 0
    assert port == (tmp_path / "jax.bwt").read_bytes()


def test_port_builds_only_its_own_sources():
    """Every C++ and CUDA source the port compiles lies under
    cmsbwt_tpu_torch/: io/native.py's two native runtimes (its own copies
    of the JAX package's native/ files) and kernels/__init__.py's SOURCES
    with the headers they share; no module of the port names a directory
    ``native`` as a path."""
    import re
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.io import native
    port = (ROOT / "cmsbwt_tpu_torch").resolve()
    built = [native._SRC, native._SCAN_SRC] + [
        kernels.CSRC / s for s in kernels.SOURCES] + sorted(
            kernels.CSRC.glob("*.cuh"))
    assert len(built) == len(kernels.SOURCES) + 3
    for src in built:
        src = pathlib.Path(src).resolve()
        assert src.is_file(), src
        assert src.is_relative_to(port), src
    for f in port.rglob("*.py"):
        assert not re.search(r"[\"']native[\"']\s*/", f.read_text()), f


def test_config_matches_jax_config():
    """Same field names, in the same order, with the same defaults."""
    ours = [(f.name, f.default) for f in dataclasses.fields(Config)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
    assert Config(filename="in").resolved_outname() == \
        JaxConfig(filename="in").resolved_outname()
