"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py):
the collections of tests/test_ms_jump.py, the joint strings of
tests/test_joint_sa.py, and carriers that move JAX results into the
port's types as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

from helpers import mutate, random_dna
from cmsbwt_tpu.io.fasta import SEPARATOR, augment_reference
from cmsbwt_tpu.utils.jaxcache import bucket_size

# (seed, ref_len, n_docs, snp, kwargs) — tests/test_ms_jump.py:39-46
CASES = [
    (0, 1500, 5, 0.02, {}),
    (1, 900, 4, 0.001, {}),              # low divergence
    (2, 1200, 6, 0.05, {"dup_pairs": 2}),  # duplicate documents
    (3, 400, 2, 0.0, {}),                # identical copies
    (4, 300, 20, 0.03, {"doc_len": 7}),  # separator-dense
    (5, 2000, 3, 0.01, {}),
]
CASE_IDS = ["snp2", "lowdiv", "dupdocs", "identical", "sepdense", "snp1"]


def collection(seed, ref_len, n_docs, snp, dup_pairs=0, doc_len=None):
    """(x_aug, sx) exactly as tests/test_ms_jump.py builds them."""
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, ref_len)
    docs = [np.frombuffer(mutate(rng, ref, snp), np.uint8)[:doc_len]
            for _ in range(n_docs)]
    for k in range(dup_pairs):
        if 2 * k + 1 < n_docs:
            docs[2 * k + 1] = docs[2 * k].copy()
    sep = np.full(1, SEPARATOR, np.uint8)
    sx = np.concatenate([sep] + [np.concatenate([dc, sep]) for dc in docs])
    x_aug = np.frombuffer(augment_reference(ref), np.uint8)
    return x_aug, sx


def case_collection(case):
    seed, ref_len, n_docs, snp, kw = case
    return collection(seed, ref_len, n_docs, snp, **kw)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def carry_heads(jres):
    """A JAX DeviceHeadsResult as the port's DeviceHeadsResult (CPU)."""
    from cmsbwt_tpu_torch.ops.ms_dense import DeviceHeadsResult
    f = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
         "ref_sa", "ref_isa", "ref_bwt")
    return DeviceHeadsResult(h=jres.h, n=jres.n, sn=jres.sn,
                             irreducible=jres.irreducible,
                             **{k: to_torch(getattr(jres, k)) for k in f})


def assert_same(jax_value, torch_value, name=""):
    """Exact equality of values, shape and dtype."""
    a = np.asarray(jax_value)
    b = torch_value.numpy() if isinstance(torch_value, torch.Tensor) \
        else np.asarray(torch_value)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=name)


def jax_joint_string(x_aug, sx, sep_base=0) -> dict:
    """The JAX package's joint string of (x_aug, sx) as _dense_core pads
    it (bucketed): the padded raw bytes and geometry the port's
    _build_joint_core takes, and JAX's (b, sp) as numpy."""
    import jax.numpy as jnp
    from cmsbwt_tpu.ops import ms_dense as MD
    n, sn = len(x_aug), len(sx)
    n_pad, sn_pad = bucket_size(n), bucket_size(sn)
    if sn_pad == sn and (sn == 0 or sx[-1] != SEPARATOR):
        sn_pad = bucket_size(sn + 1)
    x_u8 = np.zeros(n_pad, np.uint8)
    x_u8[:n] = x_aug
    sx_u8 = np.zeros(sn_pad, np.uint8)
    sx_u8[:sn] = sx
    b, sp = MD._build_joint_device(
        jnp.asarray(x_u8), jnp.asarray(sx_u8), jnp.int32(n), jnp.int32(sn),
        jnp.int32(sep_base), n_pad, sn_pad)
    return dict(x_u8=x_u8, sx_u8=sx_u8, n=n, sn=sn, n_pad=n_pad,
                sn_pad=sn_pad, sep_base=sep_base, m=n_pad + sn_pad,
                b=np.asarray(b), sp=np.asarray(sp))


def joint_inputs(ref_len, docs, seed, doc_len=None, snp=0.05, sep_base=0,
                 trunc=None) -> dict:
    """jax_joint_string of the collection tests/test_joint_sa.py::_joint
    makes."""
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, ref_len)
    ds = [np.frombuffer(mutate(rng, ref, snp), np.uint8)[:doc_len]
          for _ in range(docs)]
    sep = np.full(1, SEPARATOR, np.uint8)
    sx = np.concatenate([sep] + [np.concatenate([d, sep]) for d in ds])
    if trunc:
        sx = sx[:trunc]
    x_aug = np.frombuffer(augment_reference(ref), np.uint8)
    return jax_joint_string(x_aug, sx, sep_base)


JOINT_NAMES = ("sa", "isa", "hist", "packs", "k_star", "split_lv")


def carry_joint(jax_out) -> dict:
    """The JAX joint_suffix_array result (sa, isa, hist, packs, k_star,
    split_lv) as the port's CPU tensors, by name."""
    return {k: to_torch(v) for k, v in zip(JOINT_NAMES, jax_out)}
