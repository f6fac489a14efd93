"""Rank bodies of the port's mesh tests (tests/test_torch_dist.py,
test_torch_sharded_merge.py, test_torch_mesh.py,
test_torch_sharded_index.py): ``run(body, inputs, R)`` runs one body on R
gloo ranks through cmsbwt_tpu_torch.parallel.distributed.run (this
process is rank 0; the others are spawned and rendezvous through a
``file://`` store in a fresh temporary directory), all cases of one
(module, R) in one spawn, each collective bounded by a 120 s timeout.
This module imports torch and the port only, so the spawned ranks never
load JAX."""
from __future__ import annotations

import os

import numpy as np
import torch

from cmsbwt_tpu_torch import cli
from cmsbwt_tpu_torch.ops.ms_dense import BlockCheckpoints
from cmsbwt_tpu_torch.parallel import dist as D
from cmsbwt_tpu_torch.parallel import distributed
from cmsbwt_tpu_torch.parallel.mesh import ms_dense_heads_mesh
from cmsbwt_tpu_torch.parallel.sharded_index import (
    sharded_suffix_array, sharded_suffix_array_with_lcp)
from cmsbwt_tpu_torch.parallel.sharded_merge import merge_heads_sharded

TIMEOUT_S = "120"
LOCAL = 64
KMAX = 1 << 62
SHIFTS = (0, 1, -1, 5, -7, 63, 64, 65, -64, 300, -300, "G-1", "-(G-1)")


def run(body, inputs, R: int):
    """body(ranks, inputs) on R CPU ranks; rank 0's return value."""
    old = os.environ.get("CMSBWT_DIST_TIMEOUT")
    os.environ["CMSBWT_DIST_TIMEOUT"] = TIMEOUT_S
    try:
        return distributed.run(body, inputs, "cpu", R)
    finally:
        if old is None:
            os.environ.pop("CMSBWT_DIST_TIMEOUT")
        else:
            os.environ["CMSBWT_DIST_TIMEOUT"] = old


def shift_of(w, G: int) -> int:
    return {"G-1": G - 1, "-(G-1)": -(G - 1)}.get(w, w)


def dist_inputs(R: int) -> dict:
    """The global inputs of the primitive cases (regular layout, LOCAL rows
    per rank), from fixed seeds: every rank makes the same."""
    G = R * LOCAL
    rng = np.random.default_rng(R)
    i = lambda lo, hi, k=G: rng.integers(lo, hi, k).astype(np.int64)
    perm = rng.permutation(G + 20).astype(np.int64)[:G] - 10
    k0 = i(0, 9)
    k0[rng.random(G) < 0.2] = KMAX
    return dict(sum=i(-5, 9), ext=i(-100, 100), rows=i(-50, 50, 3 * G),
                vals=i(0, 1000), q=i(-10, G + 10), qs=i(-10, G + 10),
                sidx=perm, aidx=i(-10, G + 10), sval=i(-20, 20),
                k0=k0, k1=i(0, 4), p=np.arange(G, dtype=np.int64) * 7 + 3)


def dist_cases(g, _inputs):
    """Every primitive of parallel/dist.py on this rank's slice; the global
    results on rank 0, keyed by case."""
    a = {k: torch.from_numpy(v) for k, v in dist_inputs(g.size).items()}
    lo, hi = g.rank * LOCAL, (g.rank + 1) * LOCAL
    G = g.size * LOCAL
    mine = {k: v[lo:hi].clone() for k, v in a.items() if k != "rows"}
    rows = a["rows"].reshape(3, G)[:, lo:hi].contiguous()
    out = {"gidx": g.gidx(LOCAL),
           "shard": D.shard(g, a["vals"].numpy() if g.rank == 0 else None,
                            LOCAL, -4, G - 3),
           "cumsum": D.dcumsum(g, mine["sum"]),
           "cumsum_rev": D.dcumsum_rev(g, mine["sum"]),
           "cummax": D.dcummax(g, mine["ext"]),
           "cummin_rev": D.dcummin_rev(g, mine["ext"]),
           "cummax_rev": D.dcummax_rev(g, mine["ext"]),
           "cummax_rows": D.dcummax_rows(g, rows).t(),
           "gather": D.dgather(g, mine["vals"], mine["q"], -1),
           "gather2": D.dgather(g, torch.stack([mine["vals"], mine["sum"]], 1),
                                mine["qs"], -2)}
    for w in SHIFTS:
        out[f"shift{w}"] = D.dshift(g, mine["vals"], shift_of(w, G), -9)
    base = mine["ext"]
    out["scatter_set"] = D.dscatter(g, base.clone(), mine["sidx"],
                                    mine["sval"], "set")
    for mode in ("add", "max"):
        out[f"scatter_{mode}"] = D.dscatter(g, base.clone(), mine["aidx"],
                                            mine["sval"], mode)
    vals2 = torch.stack([mine["sval"], -mine["sval"] * 3])
    base2 = torch.stack([base, base + 1])
    for mode in ("set", "add", "max"):
        idx = mine["sidx"] if mode == "set" else mine["aidx"]
        out[f"scatter_rows_{mode}"] = D.dscatter_rows(
            g, base2.clone(), idx, vals2, mode).t()
    (s0, s1), (sp,) = D.dsort(g, [mine["k0"], mine["k1"]], [mine["p"]], KMAX)
    out["sort2"] = torch.stack([s0, s1, sp], 1)
    (t0,), (tp, tq) = D.dsort(g, [mine["k0"]], [mine["p"], mine["k1"]], KMAX)
    out["sort1"] = torch.stack([t0, tp, tq], 1)
    res = {k: D.gather_rows(g, v.contiguous(), LOCAL) for k, v in out.items()}
    return ({k: v.numpy() for k, v in res.items()} if g.rank == 0
            else None)


def _cli_runs(g, argvs):
    """Each argv through the port's CLI on every rank (rank 0 writes)."""
    for argv in D.bcast_object(g, argvs):
        assert cli.main(argv) == 0


def merge_cases(g, inputs):
    """merge_heads_sharded on each case of rank 0's ``(cases, argvs)``
    (cases: (arrays, (h, n, sn, d, rle_quirk))), then each CLI argv."""
    cases, argvs = inputs if g.rank == 0 else (None, None)
    k = D.bcast_object(g, len(cases) if g.rank == 0 else None)
    out = []
    for i in range(k):
        arrays, meta = cases[i] if g.rank == 0 else ([None] * 8,
                                                     (0, 0, 0, 0, False))
        out.append(merge_heads_sharded(*arrays, *meta, device="cpu"))
    _cli_runs(g, argvs)
    return out


def mesh_cases(g, inputs):
    """ms_dense_heads_mesh on each (x_aug, sx, block, ctx, checkpoint
    directory or None) case of rank 0's ``(cases, argvs)``, then each CLI
    argv."""
    cases, argvs = inputs if g.rank == 0 else (None, None)
    k = D.bcast_object(g, len(cases) if g.rank == 0 else None)
    out = []
    for i in range(k):
        x, sx, block, ctx, ck = cases[i] if g.rank == 0 else (None,) * 5
        ckpt = (BlockCheckpoints(ck, "", block) if ck else None)
        out.append(ms_dense_heads_mesh(x, sx, block, ctx, device="cpu",
                                       checkpoint=ckpt))
    _cli_runs(g, argvs)
    return out


def index_cases(g, inputs):
    """(sa, isa) and (sa, isa, lcp) of each reference of rank 0's
    ``(refs, argvs)``, then each CLI argv."""
    refs, argvs = inputs if g.rank == 0 else (None, None)
    k = D.bcast_object(g, len(refs) if g.rank == 0 else None)
    out = []
    for i in range(k):
        x = refs[i] if g.rank == 0 else None
        out.append((sharded_suffix_array(x, device="cpu"),
                    sharded_suffix_array_with_lcp(x, device="cpu")))
    _cli_runs(g, argvs)
    return out
