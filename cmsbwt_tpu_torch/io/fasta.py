"""Reference / collection loading with byte-faithful reference semantics —
the port's copy of cmsbwt_tpu/io/fasta.py (same functions, same results).

The parsing rules replicate the reference exactly:

* Reference loader: FASTA-or-raw autodetect on the first byte being ``>``;
  FASTA sequence lines are concatenated, headers dropped
  (ref ``CMS-BWT-functions.cpp:154-204``). A single trailing ``\\n``/``\\r``/NUL
  is stripped, then a single trailing ``$`` (ref ``:208-213``).
* Alphabet augmentation: every byte in [3, 128) absent from the reference is
  appended once, then the sentinels ``\\x01\\x00`` (ref ``:231-237``).
* Collection streaming: ``std::getline`` line semantics — lines split on
  ``\\n`` only, and a final unterminated line is dropped (``.good()`` is false
  once eofbit is set). Every empty line or line starting with ``>`` flushes
  the current document and contributes one SEPARATOR char. The ``-p`` prefix
  cut happens mid-line once ``charactersRead >= sn-1``
  (ref ``CMS-BWT-functions.cpp:344-355,464-481,1138-1147,1257-1274``).

The concatenated collection string SX therefore looks like::

    [sep][doc1][sep][doc2][sep]...[docK][sep]

where the leading separator comes from the first ``>`` header line creating an
empty document (exactly as the reference does).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import (ALPHABET_AUGMENT_HI, ALPHABET_AUGMENT_LO, PRE_TERMINATOR,
                      SEPARATOR, TERMINATOR)


def read_input_list(path: str) -> tuple[str, str]:
    """Parse the 2-line input-list file (ref main.cpp:90-115)."""
    with open(path, "r") as f:
        ref_line = f.readline().rstrip("\n")
        coll_line = f.readline().rstrip("\n")
    if not ref_line:
        raise ValueError(f"first line of {path} is empty")
    coll_line = coll_line.rstrip(" \n\r\t")
    if not coll_line:
        raise ValueError(f"second line of {path} is empty")
    return ref_line, coll_line


def load_reference_bytes(path: str) -> bytes:
    """FASTA-or-raw reference load (ref CMS-BWT-functions.cpp:154-213)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) == 0:
        raise ValueError("Reference file is empty!")
    if data[:1] == b">":
        # FASTA: concatenate all lines that are non-empty and not headers.
        out = bytearray()
        for line in data.split(b"\n"):
            if line and not line.startswith(b">"):
                out += line
        data = bytes(out)
    # strip one trailing newline/CR/NUL, then one trailing '$'
    if data and data[-1] in (0x0A, 0x0D, 0x00):
        data = data[:-1]
    if data and data[-1:] == b"$":
        data = data[:-1]
    return data


def augment_reference(ref: bytes) -> np.ndarray:
    """Append missing [3,128) bytes + sentinels; return uint8 array.

    Ref CMS-BWT-functions.cpp:231-237.
    """
    present = np.zeros(256, dtype=bool)
    arr = np.frombuffer(ref, dtype=np.uint8)
    present[np.unique(arr)] = True
    if present[:ALPHABET_AUGMENT_LO].any():
        bad = int(np.argmax(present[:ALPHABET_AUGMENT_LO]))
        raise ValueError(
            f"reference contains reserved byte {bad} (< 3); bytes 0-2 are "
            "the terminator/pre-terminator/separator and the reference tool "
            "has undefined behavior for such inputs")
    extra = [c for c in range(ALPHABET_AUGMENT_LO, ALPHABET_AUGMENT_HI)
             if not present[c]]
    out = np.concatenate([
        arr,
        np.asarray(extra, dtype=np.uint8),
        np.asarray([PRE_TERMINATOR, TERMINATOR], dtype=np.uint8),
    ])
    return out


@dataclass
class Collection:
    """Parsed collection: concatenated docs with separators."""

    sx: np.ndarray        # uint8, length sn; separator-terminated docs
    sn: int               # == len(sx)
    n_separators: int     # == D - 1 in reference terms (D starts at 1)
    doc_starts: np.ndarray  # int64 start offset of every document (incl. empty ones)
    sep_positions: np.ndarray  # int64 position of each separator in sx

    @property
    def d(self) -> int:  # reference's D
        return self.n_separators + 1


def _getline_lines(data: bytes) -> list[bytes]:
    """std::getline(...).good() loop semantics: final unterminated line dropped."""
    return data.split(b"\n")[:-1]


def parse_collection(path: str, sn_limit: int,
                     use_native: bool = True) -> Collection:
    """Stream the collection file into SX (ref :344-559 parsing skeleton).

    ``sn_limit`` is the reference's ``_sn`` = min(file size, prefixLength)
    (ref :220-226). Truncation and the EOF tail block follow the reference.
    Uses the native C++ parser when available (io/native.py).
    """
    if use_native:
        from .native import parse_collection_native
        res = parse_collection_native(path, sn_limit)
        if res is not None:
            sx, n_seps = res
            sep_positions = np.nonzero(sx == SEPARATOR)[0].astype(np.int64)
            doc_starts = np.concatenate(
                [np.zeros(1, np.int64), sep_positions[:-1] + 1]) \
                if n_seps else np.zeros(0, np.int64)
            return Collection(sx=sx, sn=len(sx), n_separators=n_seps,
                              doc_starts=doc_starts,
                              sep_positions=sep_positions)
    with open(path, "rb") as f:
        data = f.read()
    return _parse_collection_impl(_getline_lines(data), sn_limit)


def _parse_collection_impl(lines: list[bytes], sn_limit: int) -> Collection:
    sx = bytearray()
    cur_doc_len = 0
    characters_read = 0
    sep_positions: list[int] = []
    doc_starts: list[int] = []

    def flush_doc():
        nonlocal cur_doc_len
        doc_starts.append(len(sx) - cur_doc_len)
        sx.append(SEPARATOR)
        sep_positions.append(len(sx) - 1)
        cur_doc_len = 0

    for line in lines:
        if len(line) == 0 or line[:1] == b">":
            characters_read += 1
            flush_doc()
        else:
            characters_read += len(line)
            # sn_limit <= 0: the reference's uint64 `charactersRead >= _sn-1`
            # wraps and never truncates — treat as no limit (the native
            # parser does the same)
            if sn_limit > 0 and characters_read >= sn_limit - 1:
                take = min(max(len(line) - (characters_read - sn_limit) - 1,
                               0), len(line))
                sx += line[:take]
                cur_doc_len += take
                break
            else:
                sx += line
                cur_doc_len += len(line)

    # EOF tail block (ref :476-482): only if unfinished content remains.
    if cur_doc_len != 0:
        characters_read += 1
        flush_doc()

    arr = np.frombuffer(bytes(sx), dtype=np.uint8)
    return Collection(
        sx=arr,
        sn=len(arr),
        n_separators=len(sep_positions),
        doc_starts=np.asarray(doc_starts, dtype=np.int64),
        sep_positions=np.asarray(sep_positions, dtype=np.int64),
    )


def collection_sn_limit(path: str, prefix_length: int) -> int:
    """_sn = min(collection file byte size, prefixLength) (ref :220-226)."""
    return min(os.path.getsize(path), prefix_length)


def validate_collection(coll: Collection) -> None:
    """The reference requires every collection byte (except separators) to be
    in [3, 128): bytes outside occur nowhere in the augmented reference and
    trigger undefined reference behavior (uint32 len underflow at
    CMS-BWT-functions.cpp:532 when a length-0 factor is returned)."""
    sx = coll.sx
    bad = (sx < ALPHABET_AUGMENT_LO) | (sx >= ALPHABET_AUGMENT_HI)
    bad &= sx != SEPARATOR
    if np.any(bad):
        pos = int(np.argmax(bad))
        raise ValueError(
            f"collection byte {int(sx[pos])} at offset {pos} outside [3,128); "
            "the reference tool has undefined behavior for such inputs")
