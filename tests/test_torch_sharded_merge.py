"""The port's sharded merge (cmsbwt_tpu_torch/parallel/sharded_merge.py) at
R = 1, 2 and 4 gloo ranks: merge_heads_sharded on tests/torch_cases.CASES
(duplicate documents, the counterBad path, among them) and a single
document, with and without the RLE quirk, from host arrays and from
tensors, against the port's device merge and against the JAX package's
merge_heads_sharded; and ``--merge-backend sharded`` after the jump and
the dense scans through the port's CLI on R ranks, bytes equal to the JAX
CLI's. All cases of one R run in one spawn (tests/torch_ranks.
merge_cases). Tolerance: exact bytes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import make_inputs, mutate, random_dna
from cmsbwt_tpu import cli as jax_cli
from cmsbwt_tpu.parallel.sharded_merge import \
    merge_heads_sharded as jax_merge_sharded
from cmsbwt_tpu_torch import cli
from cmsbwt_tpu_torch.engine.device_merge import download_runs, \
    merge_heads_device_resident
from cmsbwt_tpu_torch.engine.pipeline import download_heads_result
from cmsbwt_tpu_torch.ops.ms_dense import ms_dense_heads_on_device
from torch_cases import CASE_IDS, CASES, collection
from torch_ranks import merge_cases, run

torch.set_num_threads(1)

RS = [1, 2, 4]
SINGLE = (7, 500, 1, 0.02, {})
IDS = CASE_IDS + ["single"]
FIELDS = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
          "ref_sa", "ref_isa", "ref_bwt")
_CASES: dict = {}
_GOT: dict = {}


def _case(cid: str):
    """(x_aug, sx, d, the dense scan's device result) of one case."""
    if cid not in _CASES:
        seed, ref_len, n_docs, snp, kw = \
            dict(zip(IDS, CASES + [SINGLE]))[cid]
        x, sx = collection(seed, ref_len, n_docs, snp, **kw)
        _CASES[cid] = (x, sx, int((sx == 2).sum()),
                       ms_dense_heads_on_device(x, sx, "cpu"))
    return _CASES[cid]


def _inputs(cid: str, rq: bool):
    """One merge case as rank 0 passes it: tensors (padded, as the device
    routes hold them) with the quirk, host arrays without."""
    x, sx, d, res = _case(cid)
    src = res if rq else download_heads_result(res, len(x))
    return ([getattr(src, f) for f in FIELDS],
            (res.h, len(x), len(sx), d, rq))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The CLI's input and the JAX CLI's outputs with its sharded merge
    over 8 devices: dense, jump and dense -r (the first builds the
    merge's programs, ~50 s on the CPU; the others reuse them)."""
    tmp = tmp_path_factory.mktemp("shm")
    rng = np.random.default_rng(21)
    ref = random_dna(rng, 600)
    lst, _, _ = make_inputs(tmp, ref, [mutate(rng, ref, 0.02)
                                       for _ in range(5)])
    for tag, flags in (("dense", ["--backend", "dense"]),
                       ("jump", ["--backend", "jump", "--lanes", "8"]),
                       ("rle", ["--backend", "dense", "-r"])):
        assert jax_cli.main([str(lst), "-o", str(tmp / f"j_{tag}"), *flags,
                             "--merge-backend", "sharded"]) == 0
        # the port's own device merge on the same input
        assert cli.main([str(lst), "-o", str(tmp / f"d_{tag}"), "--device",
                         "cpu", *flags, "--merge-backend", "device"]) == 0
    return tmp, lst


def _port(R: int, work):
    if R not in _GOT:
        tmp, lst = work
        cases = [_inputs(cid, rq) for cid in IDS for rq in (False, True)]
        argvs = [[str(lst), "-o", str(tmp / f"t{R}_{tag}"), "--device", "cpu",
                  *flags, "--merge-backend", "sharded"]
                 for tag, flags in (
                     ("dense", ["--backend", "dense"]),
                     ("jump", ["--backend", "jump", "--lanes", "8"]),
                     ("rle", ["--backend", "dense", "-r"]))]
        out = run(merge_cases, (cases, argvs), R)
        _GOT[R] = dict(zip([(cid, rq) for cid in IDS for rq in (False, True)],
                           out))
    return _GOT[R]


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("rq", [False, True], ids=["plain", "quirk"])
@pytest.mark.parametrize("cid", IDS)
def test_sharded_matches_device_merge(work, R, cid, rq):
    x, sx, d, res = _case(cid)
    rl0, rc0 = download_runs(*merge_heads_device_resident(res, d, rq)[:2])
    rl, rc = _port(R, work)[(cid, rq)]
    assert rl.dtype == np.int64 and rc.dtype == np.uint8
    np.testing.assert_array_equal(rl, rl0)
    np.testing.assert_array_equal(rc, rc0)


@pytest.mark.parametrize("cid,rq", [("dupdocs", True)])
def test_sharded_matches_jax_sharded(work, cid, rq):
    """The JAX package's merge_heads_sharded on one device, the counterBad
    path with the quirk (its R = 2 and 4 programs take ~30 s each to build
    on the CPU; the port's R = 2 and 4 are held to the device merge above,
    and to the JAX CLI's 8-device sharded merge below)."""
    arrays, meta = _inputs(cid, False)
    rl, rc = jax_merge_sharded(*arrays, *meta[:4], rq, n_devices=1)
    for R in RS:
        got = _port(R, work)[(cid, rq)]
        np.testing.assert_array_equal(got[0], rl)
        np.testing.assert_array_equal(got[1], rc)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("backend", ["dense", "jump", "rle"])
def test_cli_sharded_matches_jax_cli(work, R, backend):
    """--merge-backend sharded after the dense and the jump scans (and
    dense -r), the port's CLI on R ranks: bytes equal to the JAX CLI's
    with its sharded merge and to the port's CLI with the device merge.
    No counter artifact: the sharded merge has none."""
    tmp, _ = work
    _port(R, work)
    ext = ".rl_bwt" if backend == "rle" else ".bwt"
    got = (tmp / f"t{R}_{backend}{ext}").read_bytes()
    assert len(got) > 0
    assert got == (tmp / f"j_{backend}{ext}").read_bytes()
    assert got == (tmp / f"d_{backend}{ext}").read_bytes()
    assert not (tmp / f"t{R}_{backend}.counterSmallerThanHead_true").exists()
    assert "merge_sharded" in (tmp / f"t{R}_{backend}.log").read_text()
