"""The port's distributed primitives (cmsbwt_tpu_torch/parallel/dist.py) at
R = 1, 2 and 4 gloo ranks against numpy and against the JAX package's
(cmsbwt_tpu/parallel/dist.py, shard_map over R of the 8 virtual CPU
devices): the scans, dshift, dgather, dscatter and dscatter_rows in every
mode, dsort with one and two keys, shard and gather_rows. All cases of one
R run in one spawn (tests/torch_ranks.dist_cases). Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cmsbwt_tpu.parallel import dist as JD
from torch_ranks import KMAX, LOCAL, SHIFTS, dist_cases, dist_inputs, run, \
    shift_of

torch.set_num_threads(1)

RS = [1, 2, 4]
_GOT: dict = {}


def _port(R: int) -> dict:
    if R not in _GOT:
        _GOT[R] = run(dist_cases, None, R)
    return _GOT[R]


def _jax(R: int, fn, *arrs, specs=None):
    """shard_map a local-view JAX function over R virtual devices."""
    mesh = JD.make_mesh(R)
    specs = specs or tuple(P(JD.AXIS) for _ in arrs)
    with jax.enable_x64(True):
        put = [jax.device_put(jnp.asarray(a),
                              jax.sharding.NamedSharding(mesh, s))
               for a, s in zip(arrs, specs)]
        out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=specs,
                                    out_specs=P(JD.AXIS)))(*put)
        return np.asarray(out)


def _check(R, name, numpy_want, jax_want=None):
    got = _port(R)[name]
    np.testing.assert_array_equal(got, numpy_want, err_msg=name)
    if jax_want is not None:
        np.testing.assert_array_equal(got, jax_want, err_msg=name)


def _rev(op, v):
    return op.accumulate(v[::-1])[::-1]


@pytest.mark.parametrize("R", RS)
def test_gidx_and_shard(R):
    G = R * LOCAL
    a = dist_inputs(R)
    _check(R, "gidx", np.arange(G))
    want = np.full(G, -4, np.int64)
    want[:G - 3] = a["vals"][:G - 3]
    _check(R, "shard", want)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("name", ["cumsum", "cumsum_rev", "cummax",
                                  "cummin_rev", "cummax_rev"])
def test_scans(R, name):
    a = dist_inputs(R)
    v = a["sum"] if name.startswith("cumsum") else a["ext"]
    want = {"cumsum": np.cumsum(v), "cumsum_rev": np.cumsum(v[::-1])[::-1],
            "cummax": np.maximum.accumulate(v),
            "cummin_rev": _rev(np.minimum, v),
            "cummax_rev": _rev(np.maximum, v)}[name]
    jfn = {"cumsum": JD.dcumsum, "cumsum_rev": JD.dcumsum_rev,
           "cummax": JD.dcummax, "cummin_rev": JD.dcummin_rev,
           "cummax_rev": JD.dcummax_rev}[name]
    _check(R, name, want, _jax(R, lambda x: jfn(x, R), v))


@pytest.mark.parametrize("R", RS)
def test_cummax_rows(R):
    G = R * LOCAL
    rows = dist_inputs(R)["rows"].reshape(3, G)
    jax_out = _jax(R, lambda x: JD.dcummax_rows(x, R).T, rows,
                   specs=(P(None, JD.AXIS),))
    _check(R, "cummax_rows", np.maximum.accumulate(rows, 1).T, jax_out)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("w", SHIFTS)
def test_dshift(R, w):
    G = R * LOCAL
    v = dist_inputs(R)["vals"]
    s = shift_of(w, G)
    idx = np.arange(G) + s
    want = np.where((idx >= 0) & (idx < G), v[np.clip(idx, 0, G - 1)], -9)
    jax_out = _jax(R, lambda x: JD.dshift(x, jnp.int64(s), jnp.int64(-9),
                                          LOCAL, R), v)
    _check(R, f"shift{w}", want, jax_out)


@pytest.mark.parametrize("R", RS)
def test_dgather(R):
    G = R * LOCAL
    a = dist_inputs(R)
    q = a["q"]
    want = np.where((q >= 0) & (q < G), a["vals"][np.clip(q, 0, G - 1)], -1)
    jax_out = _jax(R, lambda x, y: JD.dgather(x, y, jnp.int64(-1), LOCAL, R),
                   a["vals"], q)
    _check(R, "gather", want, jax_out)
    qs = a["qs"]
    inr = ((qs >= 0) & (qs < G))[:, None]
    two = np.stack([a["vals"], a["sum"]], 1)[np.clip(qs, 0, G - 1)]
    _check(R, "gather2", np.where(inr, two, -2))


def _np_scatter(base, idx, vals, mode):
    out = base.copy()
    live = (idx >= 0) & (idx < out.shape[-1])
    at, v = idx[live], vals[..., live]
    if mode == "set":
        out[..., at] = v
    elif mode == "add":
        for c in range(out.shape[0]) if out.ndim == 2 else [None]:
            np.add.at(out[c] if c is not None else out, at,
                      v[c] if c is not None else v)
    else:
        for c in range(out.shape[0]) if out.ndim == 2 else [None]:
            np.maximum.at(out[c] if c is not None else out, at,
                          v[c] if c is not None else v)
    return out


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("mode", ["set", "add", "max"])
def test_dscatter(R, mode):
    """Every mode named: the JAX dscatter defaults to 'set' and
    dscatter_rows to 'max'."""
    a = dist_inputs(R)
    idx = a["sidx"] if mode == "set" else a["aidx"]
    want = _np_scatter(a["ext"], idx, a["sval"], mode)
    jax_out = _jax(R, lambda b, i, v: JD.dscatter(b, i, v, LOCAL, R,
                                                  mode=mode),
                   a["ext"], idx, a["sval"])
    _check(R, f"scatter_{mode}", want, jax_out)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("mode", ["set", "add", "max"])
def test_dscatter_rows(R, mode):
    a = dist_inputs(R)
    idx = a["sidx"] if mode == "set" else a["aidx"]
    base2 = np.stack([a["ext"], a["ext"] + 1])
    vals2 = np.stack([a["sval"], -a["sval"] * 3])
    want = _np_scatter(base2, idx, vals2, mode).T
    jax_out = _jax(R, lambda b, i, v: JD.dscatter_rows(
        b, i, v, LOCAL, R, mode=mode).T, base2, idx, vals2,
        specs=(P(None, JD.AXIS), P(JD.AXIS), P(None, JD.AXIS)))
    _check(R, f"scatter_rows_{mode}", want, jax_out)


def _np_sort(keys, pays):
    """Stable sort of the live rows (keys[0] < KMAX), pads as fills."""
    live = keys[0] < KMAX
    order = np.lexsort(tuple(k[live] for k in reversed(keys)))
    G = len(keys[0])
    cols = [np.full(G, KMAX, np.int64) for _ in keys] + \
        [np.zeros(G, np.int64) for _ in pays]
    for c, src in zip(cols, list(keys) + list(pays)):
        c[:live.sum()] = src[live][order]
    return np.stack(cols, 1)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("nkeys", [1, 2])
def test_dsort(R, nkeys):
    """Global stable sort with pads and duplicate keys."""
    a = dist_inputs(R)
    if nkeys == 2:
        want = _np_sort([a["k0"], a["k1"]], [a["p"]])

        def jfn(k0, k1, p):
            (s0, s1), (sp,) = JD.dsort([k0, k1], [p], LOCAL, R, KMAX)
            return jnp.stack([s0, s1, sp], 1)
        jax_out = _jax(R, jfn, a["k0"], a["k1"], a["p"])
    else:
        want = _np_sort([a["k0"]], [a["p"], a["k1"]])

        def jfn(k0, p, k1):
            (s0,), (sp, sq) = JD.dsort([k0], [p, k1], LOCAL, R, KMAX)
            return jnp.stack([s0, sp, sq], 1)
        jax_out = _jax(R, jfn, a["k0"], a["p"], a["k1"])
    _check(R, f"sort{nkeys}", want, jax_out)
