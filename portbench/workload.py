"""The benchmark's input generator, frozen: FASTA files made from a seed.

``write_workload`` is a copy of the generator of the repository's chip
smoke (``chip_smoke.write_workload``, itself ``bench.make_workload`` plus
N runs and a line width), kept here so that later changes to the program's
own tools cannot move the benchmark's inputs. It adds one parameter,
``docs_per_file``: the documents go into consecutive collection files of
that many each, drawn from one random stream. With every document in one
file the bytes are those of the copied generator.

A configuration file (``configs/<name>.json``) gives the sizes under
``generator``; ``make_inputs`` writes its files into a directory.

``Rewriter`` makes every job's input new: before each job it writes a
few substitutions, drawn from the seed, in place into the files the job
reads, so that no job reads what an earlier one read. It keeps each
patch's old bytes, so that the check can take the files back to the
version any job read.
"""
from __future__ import annotations

import os
import pathlib

import numpy as np

ACGT = b"ACGT"


def _wrap(b: bytes, width: int = 60) -> bytes:
    return b"\n".join(b[i:i + width] for i in range(0, len(b), width))


def seed_of(seed: int) -> int:
    """The generator's seed for a run's ``--seed``: any whole number, a
    negative one taken modulo 2**64 (numpy takes no negative seed)."""
    return seed % (1 << 64)


def write_workload(d: pathlib.Path, seed: int, ref_len: int, n_docs: int,
                   snp: float, doc_len: int | None = None,
                   n_run: int = 0, width: int = 60,
                   docs_per_file: int | None = None) -> list[pathlib.Path]:
    """Write ``ref.fa`` and the collection files into ``d``; returns the
    collection files' paths. Uniform ACGT reference; each document a copy
    with max(1, ref_len * snp) random substitution draws (a draw may keep
    the base), none when snp is 0. ``n_run`` > 0 overwrites a run of that
    many N bytes at a random place in each document. The collection's
    lines hold ``width`` bytes; 0 writes each document on one line. With
    ``docs_per_file`` the documents fill ``coll0.fa``, ``coll1.fa``, ...
    in order; without it they all go into ``coll.fa``."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(ACGT, np.uint8)
    ref = rng.choice(acgt, size=ref_len)
    (d / "ref.fa").write_bytes(b">ref\n" + _wrap(ref.tobytes()) + b"\n")
    per = docs_per_file or n_docs
    paths, f = [], None
    try:
        for i in range(n_docs):
            if i % per == 0:
                if f is not None:
                    f.close()
                name = "coll.fa" if docs_per_file is None \
                    else f"coll{i // per}.fa"
                paths.append(d / name)
                f = open(paths[-1], "wb")
            arr = ref.copy()
            k = max(1, int(ref_len * snp)) if snp else 0
            idx = rng.choice(ref_len, k, replace=False)
            arr[idx] = rng.choice(acgt, size=k)
            if n_run:
                at = int(rng.integers(0, ref_len - n_run))
                arr[at:at + n_run] = ord("N")
            body = arr[:doc_len].tobytes()
            f.write(b">doc%d\n" % i + (_wrap(body, width) if width else body)
                    + b"\n")
    finally:
        if f is not None:
            f.close()
    return paths


def make_inputs(config: dict, seed: int, d: pathlib.Path
                ) -> tuple[pathlib.Path, list[pathlib.Path]]:
    """The reference and collection files of a configuration for a seed:
    (ref.fa, [collection files in order])."""
    g = config["generator"]
    paths = write_workload(
        d, seed_of(seed), g["reference_bp"], g["documents"],
        g["substitution_rate"], n_run=g.get("n_run", 0),
        width=g.get("line_width", 60),
        docs_per_file=g.get("documents_per_file"))
    return d / "ref.fa", paths


def doc_bytes(ref_len: int, width: int) -> int:
    """Bytes of one document's sequence lines in a collection file."""
    if width == 0:
        return ref_len + 1
    return ref_len + -(-ref_len // width)


def expected_files(config: dict) -> list[tuple[int, int]]:
    """(sn, file bytes) of each collection file a configuration makes,
    worked out from its sizes: a '>docI' header line a document, its
    wrapped lines, and the parse's separators (one a header and one at
    the end of the file)."""
    g = config["generator"]
    n, per = g["documents"], g.get("documents_per_file") or g["documents"]
    body = doc_bytes(g["reference_bp"], g.get("line_width", 60))
    out = []
    for lo in range(0, n, per):
        ids = range(lo, min(lo + per, n))
        size = sum(len(b">doc%d\n" % i) + body for i in ids)
        out.append((len(ids) * g["reference_bp"] + len(ids) + 1, size))
    return out


class Rewriter:
    """Versions of a run's input files: version 0 as written, version v
    the files after the v-th call of ``next``. Each call substitutes
    ``bases`` bases (each by another of ACGT) at random places in a span
    of ``span`` bytes at a random offset of each given file, drawn from
    the seed; bytes other than ACGT (headers, newlines) are never
    touched, so the files keep their lines, their sizes and SX's
    length."""

    def __init__(self, seed: int, bases: int = 16, span: int = 4096):
        self.rng = np.random.default_rng([seed_of(seed), 2])
        self.bases, self.span = bases, span
        self.patches: list = []   # per version: [(path, offset, old, new)]

    @property
    def version(self) -> int:
        return len(self.patches)

    def _patch(self, path) -> tuple:
        acgt = np.frombuffer(ACGT, np.uint8)
        size = os.path.getsize(path)
        span = min(self.span, size)
        with open(path, "rb") as f:
            for _ in range(64):
                off = int(self.rng.integers(0, size - span + 1))
                f.seek(off)
                old = np.frombuffer(f.read(span), np.uint8)
                code = np.searchsorted(acgt, old)
                at = np.flatnonzero((code < 4) & (acgt[code % 4] == old))
                if at.size:
                    break
            else:
                raise ValueError(f"{path}: no ACGT bytes to rewrite")
        at = self.rng.choice(at, min(self.bases, at.size), replace=False)
        new = old.copy()
        new[at] = acgt[(code[at] + self.rng.integers(1, 4, at.size)) % 4]
        return (str(path), off, old.tobytes(), new.tobytes())

    @staticmethod
    def _write(path: str, off: int, data: bytes) -> None:
        fd = os.open(path, os.O_WRONLY)
        try:
            os.pwrite(fd, data, off)
        finally:
            os.close(fd)

    def next(self, paths) -> int:
        """Rewrite ``paths``; returns the new version."""
        version = [self._patch(p) for p in paths]
        for path, off, _, new in version:
            self._write(path, off, new)
        self.patches.append(version)
        return self.version

    def rewind(self, version: int) -> None:
        """Take the files back to ``version`` (at most the present one),
        forgetting the later versions."""
        while self.version > version:
            for path, off, old, _ in reversed(self.patches.pop()):
                self._write(path, off, old)
