"""Two actual processes through the CMSBWT_* variables (the twin of
tests/test_distributed_2proc.py): each runs the port as one gloo rank, the
mesh scan and the sharded merge cross the process boundary, and the runs
equal the JAX package's single-process engine; the same two processes run
the port's CLI (--parallel with the sharded merge), bytes equal to the
JAX CLI's; a cache that one rank finds and another does not. Also: the
launcher's variables (the JAX package's and torchrun's), the rank count of each device, and the refusals (a mesh
route on cuda without a card; a group whose backend is not the device's).
Tolerance: exact bytes."""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import make_fasta, make_inputs, mutate, random_dna
from cmsbwt_tpu import cli as jax_cli
from cmsbwt_tpu.engine import device_merge as DM
from cmsbwt_tpu.io import fasta
from cmsbwt_tpu.io.fasta import augment_reference
from cmsbwt_tpu.ops.ms_dense import ms_dense_heads
from cmsbwt_tpu_torch.parallel import distributed
from cmsbwt_tpu_torch.parallel.sharded_merge import merge_heads_sharded

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

WORKER = '''
import sys, pathlib
import numpy as np
from cmsbwt_tpu_torch.parallel import distributed
from cmsbwt_tpu_torch.io import fasta
from cmsbwt_tpu_torch.io.fasta import augment_reference
from cmsbwt_tpu_torch.parallel.mesh import ms_dense_heads_mesh
from cmsbwt_tpu_torch.parallel.sharded_merge import merge_heads_sharded
from cmsbwt_tpu_torch import cli
from helpers import make_fasta, mutate, random_dna
out = pathlib.Path(sys.argv[1])
assert distributed.maybe_initialize(device="cpu")
pid = distributed.process_index()
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
rng = np.random.default_rng(7)
ref = random_dna(rng, 600)
docs = [mutate(rng, ref, 0.03) for _ in range(4)]
x_aug = augment_reference(ref)
cp = out / f"coll_{pid}.fa"
cp.write_bytes(make_fasta(docs))
coll = fasta.parse_collection(str(cp), 2**64 - 1)
dres = ms_dense_heads_mesh(x_aug, coll.sx, block_chars=400, device="cpu")
assert (dres is None) == (pid != 0)
if pid:
    rl = merge_heads_sharded(*[None] * 8, 0, 0, 0, 0, False, device="cpu")
else:
    rl = merge_heads_sharded(
        dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
        dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt, dres.h,
        len(x_aug), dres.sn, coll.d, False, device="cpu")
    np.savez(out / "result.npz", rl=rl[0], rc=rl[1], h=np.int64(dres.h),
             rho=np.int64(dres.irreducible))
assert cli.main([str(out / "input.txt"), "-o", str(out / "cli"), "--device",
                 "cpu", "--backend", "dense", "--parallel", "--block-chars",
                 "500", "--merge-backend", "sharded", "-r"]) == 0
print("rank", pid, "done", flush=True)
'''


def test_two_process_mesh_scan_sharded_merge_and_cli(tmp_path):
    rng = np.random.default_rng(5)
    ref = random_dna(rng, 600)
    lst, _, _ = make_inputs(tmp_path, ref, [mutate(rng, ref, 0.02)
                                            for _ in range(4)])
    env = dict(os.environ, OMP_NUM_THREADS="1", CMSBWT_NUM_PROCESSES="2",
               CMSBWT_COORDINATOR=f"file://{tmp_path}/rendezvous",
               CMSBWT_DIST_TIMEOUT="120",
               PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}")
    workers = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path)],
        env=dict(env, CMSBWT_PROCESS_ID=str(i)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for w in workers:
            outs.append(w.communicate(timeout=120)[0])
    finally:
        for w in workers:
            w.kill()
    for i, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    assert not (tmp_path / "cli_1.rl_bwt").exists()

    got = np.load(tmp_path / "result.npz")
    # the JAX package's single-process engine on the same inputs
    rng = np.random.default_rng(7)
    ref = random_dna(rng, 600)
    docs = [mutate(rng, ref, 0.03) for _ in range(4)]
    x_aug = augment_reference(ref)
    cp = tmp_path / "coll_oracle.fa"
    cp.write_bytes(make_fasta(docs))
    coll = fasta.parse_collection(str(cp), 2**64 - 1)
    dres = ms_dense_heads(x_aug, coll.sx)
    rl0, rc0, _ = DM.merge_heads_numpy(
        dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
        dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
        dres.h, len(x_aug), dres.sn, coll.d, rle_quirk=False)
    assert int(got["h"]) == dres.h
    np.testing.assert_array_equal(got["rl"], rl0)
    np.testing.assert_array_equal(got["rc"], rc0)

    assert jax_cli.main([str(lst), "-o", str(tmp_path / "j"), "--backend",
                         "dense", "-r"]) == 0
    assert (tmp_path / "cli.rl_bwt").read_bytes() == \
        (tmp_path / "j.rl_bwt").read_bytes()


def _two_ranks(tmp_path, tag, argv, envs):
    """The port's CLI as two gloo ranks through the CMSBWT_* variables,
    ``envs[i]`` added to rank i's environment."""
    base = dict(os.environ, OMP_NUM_THREADS="1", CMSBWT_NUM_PROCESSES="2",
                CMSBWT_COORDINATOR=f"file://{tmp_path}/rdv_{tag}",
                CMSBWT_DIST_TIMEOUT="60", PYTHONPATH=str(ROOT))
    ranks = [subprocess.Popen(
        [sys.executable, "-m", "cmsbwt_tpu_torch", *argv],
        env=dict(base, CMSBWT_PROCESS_ID=str(i), **envs[i]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for r in ranks:
            outs.append(r.communicate(timeout=120)[0])
    finally:
        for r in ranks:
            r.kill()
    for i, (r, out) in enumerate(zip(ranks, outs)):
        assert r.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"


def test_cache_hit_is_rank0s(tmp_path, monkeypatch):
    """Whether the giant route's index is cached is rank 0's answer on
    every rank: a rank that finds the cache where rank 0 does not builds
    with it, and one that misses the cache rank 0 found goes no further
    (rank 0 may save it while another rank looks), so the collectives
    never part ways; bytes equal to the normal route's."""
    from cmsbwt_tpu_torch import cli
    rng = np.random.default_rng(9)
    ref = random_dna(rng, 400)
    lst, _, _ = make_inputs(tmp_path, ref, [mutate(rng, ref, 0.02)
                                            for _ in range(3)])
    full, empty = tmp_path / "full", tmp_path / "empty"
    monkeypatch.setenv("CMSBWT_GIANT_THRESHOLD", "100")
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", str(full))
    assert cli.main([str(lst), "-o", str(tmp_path / "one"), "--device",
                     "cpu"]) == 0
    assert len(list(full.iterdir())) == 1
    for tag, dirs in (("r0_misses", (empty, full)),
                      ("r0_hits", (full, empty))):
        out = tmp_path / tag
        _two_ranks(tmp_path, tag, [str(lst), "-o", str(out), "--device",
                                   "cpu"],
                   [{"CMSBWT_INDEX_CACHE": str(d)} for d in dirs])
        assert out.with_suffix(".bwt").read_bytes() == \
            (tmp_path / "one.bwt").read_bytes()
    assert len(list(empty.iterdir())) == 1     # rank 0 saved its build


def test_launcher_variables(monkeypatch):
    """No launcher: no group. torchrun's variables and the JAX package's
    are read (init stubbed here); an incomplete set is an error."""
    for k in ("CMSBWT_COORDINATOR", "CMSBWT_NUM_PROCESSES",
              "CMSBWT_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize() is False
    assert distributed.process_index() == 0 and distributed.is_primary()
    seen = []
    monkeypatch.setattr(distributed, "_init",
                        lambda *a: seen.append(a))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.maybe_initialize(device="cpu")
    assert seen[-1] == ("tcp://localhost:29511", 4, 2, "cpu", 2)
    monkeypatch.setenv("CMSBWT_COORDINATOR", "file:///tmp/x")
    monkeypatch.setenv("CMSBWT_NUM_PROCESSES", "2")
    monkeypatch.setenv("CMSBWT_PROCESS_ID", "1")
    assert distributed.maybe_initialize(device="cpu")
    assert seen[-1][:4] == ("file:///tmp/x", 2, 1, "cpu")
    monkeypatch.delenv("CMSBWT_PROCESS_ID")
    with pytest.raises(ValueError, match="CMSBWT_PROCESS_ID"):
        distributed.maybe_initialize(device="cpu")


def test_launcher_defaults_to_cuda(monkeypatch):
    """Asked for no device, a launcher's process joins on cuda (NCCL), as
    compute_bwt, CMSBWT and the CLI default to (init stubbed here)."""
    for k in ("CMSBWT_COORDINATOR", "CMSBWT_NUM_PROCESSES",
              "CMSBWT_PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    seen = []
    monkeypatch.setattr(distributed, "_init", lambda *a: seen.append(a))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29512")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert distributed.maybe_initialize()
    assert seen == [("tcp://localhost:29512", 2, 1, "cuda", None)]


def test_rank_counts(monkeypatch):
    """R on cpu is n_devices (default 1); on cuda the visible cards."""
    assert distributed.n_ranks("cpu") == 1
    assert distributed.n_ranks("cpu", 4) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert distributed.n_ranks("cuda") == 3
    assert distributed.n_ranks("cuda", 2) == 2


def test_mesh_route_on_cuda_without_card_raises(monkeypatch):
    """No fallback: the sharded merge asked for on cuda without a card
    raises before any group exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        merge_heads_sharded(*[np.zeros(4, np.int64)] * 8, 2, 2, 4, 1, False,
                            device="cuda")


def test_backend_is_the_devices(monkeypatch):
    """NCCL only on cuda and gloo only on cpu: a gloo group does not run
    a cuda route."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.current("cuda")
    assert distributed._backend("cpu") == "gloo"
    assert distributed._backend("cuda") == "nccl"
