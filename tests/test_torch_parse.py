"""The collection parse on the port's device (cmsbwt_tpu_torch/io/parse.py)
against the JAX package's parse on the CPU.

``parse_collection_reference`` (the plain torch version of the CUDA
``fasta_parse`` kernel) and ``load_inputs(..., device="cpu")`` through it
are held to ``cmsbwt_tpu.io.fasta.parse_collection``: SX, sn,
n_separators, sep_positions and doc_starts exactly, against the default
path (the native parser), and against the Python path wherever the two
JAX paths agree; validate_collection's error (the same byte and offset,
or none). Cases: every case of tests/test_fasta.py and
tests/test_native_io.py, a '\\r' in a line, a separator byte (2) inside a
sequence line (the JAX paths' sep_positions differ there: the port
follows the default path), an empty file, headers only, no '\\n', an
unterminated last line, every cut from -1 to past the file on a file
with headers among its lines (a cut among the headers, at a line's end
+- 1, take = 0 right after a flush), lines of 1 and of 100 000 bytes,
bytes 0, 1, 128 and 255 inside a line (and in a header, which is
dropped); a hypothesis test over random line mixes and cuts. A numpy
model of the kernel's passes (newline positions, the line scan's
offsets and cut, the one-thread finish, the warps' copy by binary search
at tiny warp ranges) is held to the plain version on the same cases, and
the jump scan on the CPU gives the same heads from a Collection parsed on
the device as from a numpy SX, with no upload. Tolerance: exact."""
from __future__ import annotations

import tempfile
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers import make_fasta, make_inputs, mutate, random_dna
from cmsbwt_tpu.io import fasta as jfasta
from cmsbwt_tpu_torch.engine.pipeline import load_inputs
from cmsbwt_tpu_torch.io import fasta, parse
from cmsbwt_tpu_torch.ops import ms_jump as mj

torch.set_num_threads(1)

WINDOW = 16
BIG = 1 << 60

CASES = {
    # tests/test_fasta.py
    "leading_header": (b">a\nACGT\n>b\nGGTT\n", (BIG,)),
    "unterminated_final": (b">a\nACGT\nGGG", (BIG,)),
    "no_header": (b"ACGT\nGGTT\n", (BIG,)),
    "empty_line_flush": (b"AC\n\nGT\n", (BIG,)),
    "prefix_midline": (b">a\nAAAA\nCCCC\nGGGG\n", (8, 6, 300)),
    "prefix_exact": (b">a\nAAAA\nCCCC\n", (6,)),
    "make_fasta_w5": (make_fasta([b"ACGTACGTACGT", b"GG"], width=5),
                      (BIG,)),
    # tests/test_native_io.py
    "long_line_200": (b">x\n" + b"A" * 200 + b"\n", (BIG,)),
    # this file's
    "carriage_return": (b">a\r\nAC\rGT\r\n>b\nTT\r\n", (BIG, 5)),
    "separator_in_line": (b">a\nAC\x02GT\n>b\nTTA\n", (BIG,)),
    "empty_file": (b"", (BIG, 0, 1)),
    "headers_only": (b">a\n>b\n>c\n", (BIG, 1, 2)),
    "no_newline": (b"ACGTACGT", (BIG, 3)),
    "unterminated_last": (b">a\nACGT\n>b\nGG", (BIG, 7)),
    "one_byte_lines": (b">a\n" + b"A\n" * 50 + b">b\n" + b"C\n" * 3,
                       (BIG, 20, 54)),
    "line_100000": (b">a\n" + b"C" * 100_000 + b"\n>b\nAC\n",
                    (BIG, 50_000, 100_002)),
    "byte_0": (b">a\nAC\x00GT\n", (BIG,)),
    "byte_1": (b">a\nACGT\nA\x01\n", (BIG,)),
    "byte_128": (b">a\nAC\x80GT\n", (BIG, 3)),
    "byte_255": (b">a\nACGT\n>b\nTT\xffT\n", (BIG, 9)),
    "bad_in_header": (b">\xff\x00\nACGT\n", (BIG,)),
    "bad_after_cut": (b">a\nACGT\nA\x00\n", (5,)),
    "empty_lines_only": (b"\n\n\n", (BIG, 2)),
}
# a file with headers among its lines: charactersRead per line 1, 5, 9,
# 10, 14, 16; every cut from -1 to past the file
CUT_FILE = b">a\nAAAA\nCCCC\n>b\nGGGG\nTT\n"
CUTS = tuple(range(-1, 20)) + (1000, BIG)


def _cases():
    for name, (data, lims) in CASES.items():
        for lim in lims:
            yield pytest.param(data, lim, id=f"{name}-{lim}")
    for lim in CUTS:
        yield pytest.param(CUT_FILE, lim, id=f"cuts-{lim}")


def _raw(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def _jax(path, lim: int, use_native: bool):
    """The JAX package's parse and validate_collection's message (or
    None)."""
    coll = jfasta.parse_collection(str(path), lim, use_native=use_native)
    try:
        jfasta.validate_collection(coll)
        err = None
    except ValueError as e:
        err = str(e)
    return coll, err


def _port(path, lim: int):
    """The port's load_collection on the CPU, and its error (or None)."""
    try:
        return parse.load_collection(str(path), lim, "cpu", WINDOW), None
    except ValueError as e:
        return None, str(e)


def _check(data: bytes, lim: int, tmp: pathlib.Path) -> None:
    path = tmp / "c.fa"
    path.write_bytes(data)
    want, want_err = _jax(path, lim, True)
    py, _ = _jax(path, lim, False)
    p = parse.parse_collection_reference(_raw(data), lim, WINDOW)
    assert p.sx_padded.dtype == torch.uint8
    assert p.sx_padded.shape == (want.sn + WINDOW,)
    assert bytes(p.sx_padded[:p.sn].numpy()) == bytes(want.sx)
    assert not p.sx_padded[p.sn:].any()
    assert (p.sn, p.n_separators) == (want.sn, want.n_separators)
    assert (p.sn, p.n_separators) == (py.sn, py.n_separators)
    assert bytes(want.sx) == bytes(py.sx)
    got, err = _port(path, lim)
    assert err == want_err
    if want_err is None:
        assert p.bad == -1
        coll = fasta.Collection(sn=p.sn, n_separators=p.n_separators,
                                sx_dev=p.sx_padded, window=WINDOW)
        for c in (coll, got):
            assert bytes(c.sx) == bytes(want.sx)
            assert (c.sn, c.n_separators, c.d) == (want.sn,
                                                   want.n_separators, want.d)
            np.testing.assert_array_equal(c.sep_positions,
                                          want.sep_positions)
            np.testing.assert_array_equal(c.doc_starts, want.doc_starts)
            if np.array_equal(py.sep_positions, want.sep_positions):
                np.testing.assert_array_equal(c.doc_starts, py.doc_starts)
            assert c.sep_positions.dtype == c.doc_starts.dtype == np.int64
    else:
        pos = int(want_err.split(" at offset ")[1].split()[0])
        assert p.bad == pos
    _check_model(data, lim, p)


# --- a numpy model of fasta_parse.cu's passes --------------------------

NONE = -1


def kernel_model(data: bytes, sn_limit: int, window: int,
                 warp_bytes: int = 8):
    """fasta_parse's passes in numpy, step for step: the '\\n' positions
    (newline_kernel), each line's exclusive charactersRead, flag and the
    first sequence line that reaches the cut (line_kernel), the total and
    the EOF separator from the last kept line or two (finish_kernel), then
    each warp's output range [o0, o0 + warp_bytes): the binary search for
    its first line and the 32-record batches (copy_kernel). Returns
    (out, sn, separators, first bad offset or -1)."""
    raw = np.frombuffer(data, np.uint8)
    F = len(raw)
    S = min(sn_limit, 2**64 - 1) if sn_limit > 0 else 0
    nl = np.nonzero(raw == 10)[0].astype(np.int64)
    L = len(nl)
    off = np.zeros(L + 1, np.int64)
    flags = np.zeros(L, np.uint8)
    cut = NONE
    run = 0
    for i in range(L):
        start = nl[i - 1] + 1 if i else 0
        ln = nl[i] - start
        fl = ln == 0 or raw[start] == ord(">")
        off[i] = run
        flags[i] = fl
        run += 1 if fl else ln
        if not fl and S > 0 and cut == NONE and run >= S - 1:
            cut = i
    off[L] = run
    total, eof = 0, False
    if L and cut != NONE:
        c = cut
        start = nl[c - 1] + 1 if c else 0
        ln = int(nl[c] - start)
        over = int(off[c]) + ln - S
        take = min(max(ln - over - 1, 0), ln)
        total = int(off[c]) + take
        eof = take > 0 or (c > 0 and not flags[c - 1])
    elif L:
        total = int(off[L])
        eof = not flags[L - 1]
    sn, seps = total + eof, int(eof)
    cap = F + window
    out = np.full(max(cap, 1), 0xEE, np.uint8)   # torch.empty's garbage
    bad = NONE
    lim = min(sn + window, cap)
    for o0 in range(0, cap, warp_bytes):
        if o0 >= lim:
            break
        o1 = min(o0 + warp_bytes, lim)
        hi = min(o1, total)
        if o0 < hi:
            lo, up = 0, L - 1
            while lo < up:
                mid = (lo + up + 1) >> 1
                if off[mid] <= o0:
                    lo = mid
                else:
                    up = mid - 1
            i, pos = lo, o0
            while pos < hi:
                recs = []
                for lane in range(32):
                    li = i + lane
                    if li < L:
                        recs.append((int(off[li]), min(int(off[li + 1]),
                                                       total),
                                     int(nl[li - 1] + 1) if li else 0,
                                     int(flags[li])))
                    else:
                        recs.append((total, total, 0, 1))
                for a, e, src, f in recs:
                    if pos >= hi:
                        break
                    b = min(e, hi)
                    if f:
                        if pos <= a < b:
                            out[a] = 2
                            seps += 1
                    else:
                        for o in range(max(a, pos), b):
                            v = raw[src + o - a]
                            out[o] = v
                            if ((v < 3 or v >= 128) and v != 2
                                    and (bad == NONE or o < bad)):
                                bad = o
                    pos = max(pos, b)
                i += 32
        for o in range(max(o0, total), o1):
            out[o] = 2 if (o == total and sn > total) else 0
    return out[:sn + window], sn, seps, bad


def _check_model(data: bytes, lim: int, p) -> None:
    for wb in (1, 8, 64):
        out, sn, seps, bad = kernel_model(data, lim, WINDOW, wb)
        assert (sn, seps, bad) == (p.sn, p.n_separators, p.bad), wb
        assert bytes(out) == bytes(p.sx_padded.numpy()), wb


@pytest.mark.parametrize("data,lim", list(_cases()))
def test_parse_matches_jax(data, lim, tmp_path):
    _check(data, lim, tmp_path)


def test_separator_in_line_pinned_to_the_default_path(tmp_path):
    """A 2 inside a sequence line: both JAX paths give the same SX and 3
    separators, the default path 4 sep_positions and the Python path 3;
    the port gives the default path's."""
    data = CASES["separator_in_line"][0]
    path = tmp_path / "c.fa"
    path.write_bytes(data)
    coll, err = _port(path, BIG)
    assert err is None
    assert bytes(coll.sx) == b"\x02AC\x02GT\x02TTA\x02"
    assert coll.n_separators == 3
    np.testing.assert_array_equal(coll.sep_positions, [0, 3, 6, 10])
    np.testing.assert_array_equal(coll.doc_starts, [0, 1, 4, 7])
    np.testing.assert_array_equal(
        jfasta.parse_collection(str(path), BIG, use_native=False)
        .sep_positions, [0, 6, 10])


_LINE = st.one_of(
    st.binary(max_size=12).map(lambda b: b">" + b.replace(b"\n", b"")),
    st.just(b""),
    st.lists(st.sampled_from(b"ACGT"), min_size=1, max_size=70)
    .map(bytes),
    st.lists(st.sampled_from(b"ACGT\x02\r\x00\xff"), min_size=1,
             max_size=9).map(bytes),
)


@settings(max_examples=150, deadline=None)
@given(lines=st.lists(_LINE, max_size=24), tail=st.binary(max_size=5),
       cut=st.integers(-2, 1200))
def test_parse_hypothesis(lines, tail, cut):
    data = b"".join(line + b"\n" for line in lines) + tail.replace(
        b"\n", b"A")
    with tempfile.TemporaryDirectory() as d:
        _check(data, cut if cut < 1100 else BIG, pathlib.Path(d))


def test_load_inputs_on_the_cpu(tmp_path):
    """load_inputs(device="cpu") parses through the plain version: the
    reference and the collection equal the JAX package's, SX left on the
    CPU with the window's zero bytes; a bad byte raises the JAX package's
    error before any scan, and no host parse runs."""
    from cmsbwt_tpu.engine import pipeline as jpl  # noqa: F401
    rng = np.random.default_rng(5)
    ref = random_dna(rng, 400)
    docs = [mutate(rng, ref, 0.02) for _ in range(3)]
    lst, ref_path, coll_path = make_inputs(tmp_path, ref, docs, width=7)
    host0 = fasta.HOST_PARSES[0]
    calls0 = parse.REFERENCE_CALLS["parse_collection_reference"]
    for prefix in (2**64 - 1, 500):
        x_aug, coll = load_inputs(str(lst), prefix, device="cpu",
                                  window=WINDOW)
        want = jfasta.parse_collection(
            str(coll_path), jfasta.collection_sn_limit(str(coll_path),
                                                       prefix))
        np.testing.assert_array_equal(x_aug, jfasta.augment_reference(
            jfasta.load_reference_bytes(str(ref_path))))
        assert coll.sx_dev.device.type == "cpu"
        assert coll.sx_dev.shape == (want.sn + WINDOW,)
        assert bytes(coll.sx) == bytes(want.sx)
        assert coll.d == want.d
        np.testing.assert_array_equal(coll.sep_positions, want.sep_positions)
        np.testing.assert_array_equal(coll.doc_starts, want.doc_starts)
    assert fasta.HOST_PARSES[0] == host0
    assert parse.REFERENCE_CALLS["parse_collection_reference"] == calls0 + 2
    coll_path.write_bytes(make_fasta([docs[0], docs[1][:50] + b"\x80"]))
    want = jfasta.parse_collection(str(coll_path), BIG)
    with pytest.raises(ValueError) as jerr:
        jfasta.validate_collection(want)
    with pytest.raises(ValueError) as err:
        load_inputs(str(lst), device="cpu")
    assert str(err.value) == str(jerr.value)


def test_jump_heads_from_a_device_parsed_collection(tmp_path):
    """The jump scan on the CPU: the same heads from the Collection
    load_inputs parsed on the device (its SX read as it lies, no upload)
    as from the numpy SX."""
    rng = np.random.default_rng(8)
    ref = random_dna(rng, 600)
    docs = [mutate(rng, ref, 0.01) for _ in range(4)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    x_aug, coll = load_inputs(str(lst), device="cpu", window=WINDOW)
    ups = mj.SX_UPLOADS[0]
    a = mj.ms_jump_heads(x_aug, coll, "cpu", lanes=8, window=WINDOW)
    assert mj.SX_UPLOADS[0] == ups
    b = mj.ms_jump_heads(x_aug, coll.sx, "cpu", lanes=8, window=WINDOW)
    assert mj.SX_UPLOADS[0] == ups + 1
    assert a.h == b.h and a.sn == b.sn == coll.sn
    for k in ("head_t", "head_pos", "head_len", "head_smaller",
              "head_char"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
