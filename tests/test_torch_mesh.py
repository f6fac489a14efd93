"""The port's mesh scan (cmsbwt_tpu_torch/parallel/mesh.py) at R = 1, 2
and 4 gloo ranks: ms_dense_heads_mesh field for field against the JAX
package's ms_dense_heads_mesh over R virtual devices (the irreducible
count where JAX's waves did not fall back to its sequential scan, whose
count sums other tries) and against the port's sequential blocked loop,
on tests/torch_cases.CASES in blocks of a seventh of the collection, with
the JAX default context and with a 4-char context that cuts matches and
forces retries; block files the mesh saved, resumed by the sequential
loop without a scan; and ``--parallel`` through the port's CLI on R
ranks, bytes equal to the JAX CLI's. All cases of one R run in one spawn
(tests/torch_ranks.mesh_cases). Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import make_inputs, mutate, random_dna
from cmsbwt_tpu import cli as jax_cli
from cmsbwt_tpu.ops import ms_dense as JMD
from cmsbwt_tpu.parallel.mesh import make_mesh
from cmsbwt_tpu.parallel.mesh import ms_dense_heads_mesh as jax_mesh
from cmsbwt_tpu_torch.ops import ms_dense as md
from torch_cases import CASE_IDS, CASES, assert_same, case_collection
from torch_ranks import mesh_cases, run

torch.set_num_threads(1)

RS = [1, 2, 4]
LAYOUTS = ["default", "retry"]
FIELDS = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
          "ref_sa", "ref_isa", "ref_bwt")
_GOT: dict = {}


def _geometry(cid: str, layout: str):
    x, sx = case_collection(dict(zip(CASE_IDS, CASES))[cid])
    block = max(len(sx) // 7, 16) + (3 if layout == "retry" else 0)
    return x, sx, block, (4 if layout == "retry" else None)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The CLI's input and the JAX CLI's --parallel outputs (its mesh
    program over 8 devices), plain and -r."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    ref = random_dna(rng, 600)
    lst, _, _ = make_inputs(tmp, ref, [mutate(rng, ref, 0.01)
                                       for _ in range(4)])
    for tag, fmt in (("j", []), ("j_rle", ["-r"])):
        assert jax_cli.main([str(lst), "-o", str(tmp / tag), "--backend",
                             "dense", "--parallel", "--block-chars", "700",
                             *fmt]) == 0
    return tmp, lst


def _port(R: int, work):
    if R not in _GOT:
        tmp, lst = work
        keys = [(cid, lay) for cid in CASE_IDS for lay in LAYOUTS]
        cases = [_geometry(*k) + ((str(tmp / f"ck{R}_{k[0]}_{k[1]}"))
                                  if k[1] == "default" else None,)
                 for k in keys]
        argvs = [[str(lst), "-o", str(tmp / f"t{R}{tag}"), "--device", "cpu",
                  "--backend", "dense", "--parallel", "--block-chars", "700",
                  *fmt] for tag, fmt in (("", []), ("_rle", ["-r"]))]
        _GOT[R] = dict(zip(keys, run(mesh_cases, (cases, argvs), R)))
    return _GOT[R]


def _assert_fields(want, got, irreducible=True):
    for f in FIELDS:
        assert_same(getattr(want, f), getattr(got, f), f)
    assert want.h == got.h and want.sn == got.sn
    if irreducible:
        assert want.irreducible == got.irreducible


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cid", CASE_IDS)
def test_mesh_matches_sequential_loop(work, R, cid, layout):
    """Heads, reference index and irreducible count of the port's
    sequential blocked loop in the same blocks and context."""
    x, sx, block, ctx = _geometry(cid, layout)
    seq = md.ms_dense_heads_blocked_on_device(x, sx, "cpu", block, ctx,
                                              to_host=True)
    _assert_fields(seq, _port(R, work)[(cid, layout)])


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cid", ["snp2", "dupdocs", "sepdense"])
def test_mesh_matches_jax_mesh(work, monkeypatch, R, cid, layout):
    """Field for field the JAX mesh program over R devices; irreducible
    too unless a wave fell back to JAX's sequential scan. (Three of the
    cases: each JAX program takes seconds to build on the CPU; every case
    is held to the sequential loop above.)"""
    x, sx, block, ctx = _geometry(cid, layout)
    fell_back = []
    seq = JMD.ms_dense_heads_blocked

    def spy(*a, **k):
        fell_back.append(1)
        return seq(*a, **k)
    monkeypatch.setattr(JMD, "ms_dense_heads_blocked", spy)
    want = jax_mesh(x, sx, block_chars=block, ctx_chars=ctx,
                    mesh=make_mesh(R))
    _assert_fields(want, _port(R, work)[(cid, layout)],
                   irreducible=not fell_back)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("cid", CASE_IDS)
def test_mesh_block_files_resume_sequentially(work, monkeypatch, R, cid):
    """The blocks each rank saved (before the chain, as the JAX parallel
    loop saves them) load into the sequential loop, which scans nothing
    and chains them: the mesh's result."""
    tmp, _ = work
    x, sx, block, ctx = _geometry(cid, "default")
    got = _port(R, work)[(cid, "default")]

    def scanned(*a, **k):
        raise AssertionError("the resuming run scanned")
    monkeypatch.setattr(md, "_scan_block", scanned)
    ck = md.BlockCheckpoints(str(tmp / f"ck{R}_{cid}_default"), "", block)
    again = md.ms_dense_heads_blocked_on_device(x, sx, "cpu", block, ctx, ck,
                                                to_host=True)
    _assert_fields(got, again)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
def test_parallel_cli_matches_jax_cli(work, R, rle):
    """--parallel through the port's CLI on R ranks (the mesh scan for R >
    1, the blocked loop for 1) and through the JAX CLI's mesh program:
    equal bytes and debug artifact."""
    tmp, _ = work
    _port(R, work)
    tag = "_rle" if rle else ""
    for ext in (".rl_bwt" if rle else ".bwt", ".counterSmallerThanHead_true"):
        got = (tmp / f"t{R}{tag}{ext}").read_bytes()
        assert len(got) > 0
        assert got == (tmp / f"j{tag}{ext}").read_bytes(), ext
    assert "backend: dense" in (tmp / f"t{R}{tag}.log").read_text()
