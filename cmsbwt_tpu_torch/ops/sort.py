"""The port's stable sorts: a stable argsort by up to four keys of known
widths, and a stable compaction — the counterparts of the
``jax.lax.sort`` calls of the JAX package's device merge
(cmsbwt_tpu/engine/device_merge.py), device index
(cmsbwt_tpu/index/device.py) and jump scan (cmsbwt_tpu/ops/ms_jump.py).

Each has two forms with one contract:

* the plain versions ``_stable_argsort_reference`` (stable ``torch.sort``
  passes, least significant key first) and ``_compact_reference`` (a
  stable ``torch.sort`` of ``where(flag, idx, INT_MAX)``). They are what
  the port runs on the CPU; on the card only tests and chip_smoke.py
  call them.
* the CUDA kernels ``kernels/csrc/radix_sort.cu`` (an onesweep LSD radix
  sort of the keys' significant bits, u32 row ids) and
  ``kernels/csrc/compact.cu`` (one single-pass scan of the flag counts).

``stable_argsort`` and ``compact`` pick between them by the device of
their tensors: a CUDA tensor goes to the kernel (or raises), a CPU tensor
to the plain version.

Widths. Every call site states each key's width from a bound it already
knows (n, sn, h_pad, ...) through ``key_bits``, with no device max and
no synchronisation. A key's pad (``PADS``: INT_MAX for int32, 2^62 for
int64) maps to the all-ones pattern of its width; every other key must
lie in [0, min(2^bits - 1, pad)). A key outside that range sets bit k (k:
its place in the call) of its device's fault word, and a compaction told
the wrong count of set flags sets ``COUNT_FAULT``; both forms set the same
bits. ``check_faults`` reads the word (a stage calls it at its next
synchronisation) and raises, so a wrong width never gives a wrong order
quietly.
"""
from __future__ import annotations

import torch

INT_MAX = 2**31 - 1
I64_BIG = 1 << 62
PADS = {torch.int32: INT_MAX, torch.int64: I64_BIG}
MAX_KEYS = 4
COUNT_FAULT = 1 << MAX_KEYS

# calls of the plain versions (the CUDA wrappers keep their own launch
# counts)
REFERENCE_CALLS = {"_stable_argsort_reference": 0, "_compact_reference": 0}

_faults: dict = {}


def key_bits(bound: int) -> int:
    """The width of keys below ``bound``: the fewest bits whose all-ones
    pattern (the pad's) lies above every such key."""
    return max(1, int(bound).bit_length())


def fault_word(device) -> torch.Tensor:
    """The int32[1] word the sorts on ``device`` OR their faults into."""
    device = torch.device(device)
    if device not in _faults:
        _faults[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _faults[device]


def check_faults(device) -> None:
    """Read the fault word of ``device`` (a synchronisation: call it where
    the stage synchronises anyway), clear it and raise if any sort since
    the last check was given a key outside its width, or a compaction the
    wrong count."""
    word = _faults.get(torch.device(device))
    if word is not None:
        raise_faults(device, int(word[0]))


def raise_faults(device, f: int) -> None:
    """Clear the fault word of ``device`` and raise if ``f``, the word as
    read (by check_faults, or in one copy with other words), holds a
    fault."""
    if not f:
        return
    _faults[torch.device(device)].zero_()
    keys = [k for k in range(MAX_KEYS) if f >> k & 1]
    if keys:
        raise RuntimeError(
            f"stable_argsort: key {keys} held a value outside its stated "
            "width (negative, or at or above min(2^bits - 1, pad)); the "
            "sort's order would be wrong")
    raise RuntimeError("compact: the count of set flags was wrong")


def _validate(keys, bits) -> None:
    if not 1 <= len(keys) <= MAX_KEYS or len(keys) != len(bits):
        raise ValueError(f"stable_argsort: {len(keys)} keys and {len(bits)} "
                         f"widths (1 .. {MAX_KEYS} keys, a width each)")
    n = keys[0].shape
    for q, (k, b) in enumerate(zip(keys, bits)):
        if k.dim() != 1 or k.shape != n or k.device != keys[0].device:
            raise ValueError("stable_argsort: keys must be 1-D, of one "
                             "length, on one device")
        if k.dtype not in PADS:
            raise ValueError(f"stable_argsort: key {q} is {k.dtype}, not "
                             "int32 or int64")
        top = 31 if k.dtype == torch.int32 else 63
        if not 1 <= b <= top:
            raise ValueError(f"stable_argsort: key {q} ({k.dtype}) is {b} "
                             f"bits wide (1 .. {top})")


def stable_argsort(keys, bits, values: bool = False):
    """The stable permutation (int32[n]) sorting rows by ``keys`` (1-D
    int32 or int64 tensors, most significant first; ties keep input order,
    as ``jax.lax.sort`` with num_keys=len(keys) and a stable ``torch.sort``
    do), each key ``bits`` wide; with ``values``, also the first key's
    sorted values. On the device of the keys: the CUDA kernel for CUDA
    tensors, ``_stable_argsort_reference`` for CPU tensors."""
    keys, bits = tuple(keys), tuple(int(b) for b in bits)
    _validate(keys, bits)
    dev = keys[0].device
    if dev.type == "cuda":
        from ..kernels import radix_sort_cuda
        return radix_sort_cuda(keys, bits, fault_word(dev), values)
    if dev.type == "cpu":
        return _stable_argsort_reference(keys, bits, values)
    raise ValueError(f"stable_argsort: unsupported device {dev.type!r}")


def width_faults(keys, bits) -> torch.Tensor:
    """The fault bits of these keys (int32[1], on their device): bit k
    where key k holds a value other than its pad outside [0, min(2^bits -
    1, pad))."""
    word = torch.zeros(1, dtype=torch.int32, device=keys[0].device)
    for q, (k, b) in enumerate(zip(keys, bits)):
        pad = PADS[k.dtype]
        limit = min((1 << b) - 1, pad)
        bad = (k != pad) & ((k < 0) | (k >= limit))
        word |= bad.any().to(torch.int32) << q
    return word


def _stable_argsort_reference(keys, bits, values: bool = False):
    """Stable ``torch.sort`` passes, least significant key first; the
    keys' width faults ORed into the fault word. Plain torch, on any
    device."""
    REFERENCE_CALLS["_stable_argsort_reference"] += 1
    keys = tuple(keys)
    fault_word(keys[0].device).bitwise_or_(width_faults(keys, bits))
    order = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        order = order[torch.sort(k[order], stable=True).indices]
    perm = order.to(torch.int32)
    return (perm, keys[0][order]) if values else perm


def compact(flag: torch.Tensor, count: int) -> torch.Tensor:
    """The rows whose ``flag`` (1-D bool) is set, in order, then the
    others, in order (int32[n]); ``count`` is the number of set flags,
    which every caller knows. On the device of ``flag``: the CUDA kernel
    for a CUDA tensor, ``_compact_reference`` for a CPU tensor."""
    if flag.dim() != 1 or flag.dtype != torch.bool:
        raise ValueError(f"compact: expected a 1-D bool tensor, got "
                         f"{flag.dtype} of shape {tuple(flag.shape)}")
    if not 0 <= count <= flag.shape[0]:
        raise ValueError(f"compact: {count} set of {flag.shape[0]} rows")
    dev = flag.device
    if dev.type == "cuda":
        from ..kernels import compact_cuda
        return compact_cuda(flag, int(count), fault_word(dev))
    if dev.type == "cpu":
        return _compact_reference(flag, int(count))
    raise ValueError(f"compact: unsupported device {dev.type!r}")


def _compact_reference(flag: torch.Tensor, count: int) -> torch.Tensor:
    """A stable ``torch.sort`` of ``where(flag, idx, INT_MAX)``;
    COUNT_FAULT ORed into the fault word when ``count`` is not the set
    flags'. Plain torch, on any device."""
    REFERENCE_CALLS["_compact_reference"] += 1
    n = flag.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=flag.device)
    fault_word(flag.device).bitwise_or_(
        (flag.sum() != count).to(torch.int32) * COUNT_FAULT)
    key = torch.where(flag, idx, INT_MAX)
    return torch.sort(key, stable=True).indices.to(torch.int32)
