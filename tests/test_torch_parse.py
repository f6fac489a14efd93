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
dropped), and the tiled kernel's edges (an unwrapped document over 100
tiles, headers across tiles, a '\\n' as a tile's last byte, tiles with
no '\\n', bad bytes past the cut and in the unterminated tail, 2s at
tile edges, flushing lines carrying charactersRead past the limit
before the cut line, cuts past the file, '\\r\\n' lines); a hypothesis
test over random line mixes and cuts. A numpy model of the kernel's
passes (kernel_model: each chunk's masks, the warp-rounds' ballot scans,
the tiles' functions and their fold, the packing into the shared
buffer, the tiles' records settled in a random order, the one-block
finish) is held to the plain version on the same cases at tiles of 1,
4, 16 and 64 bytes, and at the kernel's own tile on files that reach its
counts' budgets; the kernel's 32-bit word helpers are emulated
operation by operation. The jump scan on the CPU gives the same heads from a
Collection parsed on the device as from a numpy SX, with no upload.
Tolerance: exact."""
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
    # the tiled kernel's edges (the model's tiles: 1, 4, 16, 64 bytes)
    "unwrapped_over_100_tiles": (
        b">d0\n" + b"ACGT" * 1700 + b"\n>d1\n" + b"TTGCA" * 1400 + b"\n",
        (BIG, 3000, 6805, 6806, 6807, 13_000)),
    "header_over_tiles": (b">" + b"h" * 700 + b"\nACGT\n>" + b"x" * 300
                          + b"\nGG\n", (BIG, 2, 3, 6, 7)),
    "newline_at_tile_end": ((b">" + b"h" * 14 + b"\n") * 2
                            + (b"C" * 15 + b"\n") * 9 + b"\n" * 16
                            + b"A" * 15 + b"\n", (BIG, 18, 33, 47)),
    "tiles_without_newline": (b"A" * 300 + b"\n" + b"C" * 129, (BIG, 200)),
    "bad_past_cut_and_in_tail": (b">a\nACGT\nAC\x00GT\n>b\nGG\xffA",
                                 (4, 6, 7, BIG)),
    "separator_at_tile_edges": (b">a\n" + b"A" * 12 + b"\x02" + b"C" * 15
                                + b"\x02\x02" + b"G" * 30 + b"\n>b\n\x02"
                                + b"T" * 14 + b"\n", (BIG, 17, 40)),
    "flushes_past_the_limit": (b"AC\n>h\n\n>i\n\nGGTT\n>j\nTT\n",
                               tuple(range(1, 14))),
    "cut_past_the_file": (b">a\nACGT\n>b\nGG\n", (11, 12, 13, 14, 40)),
    "crlf_lines_over_tiles": (b">a\r\n" + b"ACGTTGCA\r\n" * 20,
                              (BIG, 50)),
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


# --- a numpy model of fasta_parse.cu's passes --------------------------

NONE = -1
CU = (pathlib.Path(__file__).resolve().parents[1] / "cmsbwt_tpu_torch"
      / "kernels" / "csrc" / "fasta_parse.cu")


def kernel_tile() -> int:
    """fasta_parse.cu's tile: THREADS x ROUNDS x 16 bytes."""
    import re
    src = CU.read_text()
    get = lambda k: int(re.search(rf"constexpr int {k} = (\d+);", src)
                        .group(1))
    return get("THREADS") * get("ROUNDS") * 16


MODEL_TILES = (1, 4, 16, 64)
FN_BITS = 31                # a count's field in each word of Fn
KIND = 1 << FN_BITS
FN_ID = (0, KIND)           # the identity function: (s, f) words of Fn
HALF = 16                   # a warp-round's counts: 16-bit halves


def _branch(f: tuple, k: int) -> int:
    return f[1] if k else f[0]


def _fn_combine(x: tuple, y: tuple) -> tuple:
    """FnOp::combine: x then y, each word (count, kind left) of one
    incoming kind; every count must fit its 31 bits."""
    out = []
    for h in x:
        yh = _branch(y, h >> FN_BITS)
        c = (h & (KIND - 1)) + (yh & (KIND - 1))
        assert c < KIND, "a tile's count overflows Fn's field"
        out.append(c | (yh & KIND))
    return tuple(out)


def _fn64(f: tuple) -> tuple:
    """Fn widened to Fn64: (sequence count, kind, flushing count, kind)."""
    return (f[0] & (KIND - 1), f[0] >> FN_BITS, f[1] & (KIND - 1),
            f[1] >> FN_BITS)


def _fn64_combine(x: tuple, y: tuple) -> tuple:
    def at(f, k):
        return (f[0], f[1]) if k == 0 else (f[2], f[3])
    cs, ks = at(y, x[1])
    cf, kf = at(y, x[3])
    return (x[0] + cs, ks, x[2] + cf, kf)


def _kept_masks(nl, gt, vm, st, width: int):
    """kept_masks over every chunk at once (uint32 arrays): the kept
    bytes for an incoming sequence line and for an incoming flushing
    one."""
    full = np.uint32((1 << width) - 1)
    sm = ((nl << np.uint32(1)) | st) & full
    v, p = sm & (nl | gt), ~sm & full
    for d in (1, 2, 4, 8):
        v |= (v << np.uint32(d)) & p
        p &= p << np.uint32(d)
    pre = np.where(sm != 0, (sm & (~sm + np.uint32(1))) - np.uint32(1),
                   full).astype(np.uint32)
    return ~(v ^ nl) & vm, ~((v | pre) ^ nl) & vm


def _bits(mask: np.ndarray, width: int) -> np.ndarray:
    """bool[n, width]: bit i of each mask."""
    return ((mask[:, None] >> np.arange(width, dtype=np.uint32)) & 1) \
        .astype(bool)


def kernel_model(data: bytes, sn_limit: int, window: int, tile: int,
                 chunk: int | None = None, lanes: int | None = None,
                 seed: int = 0):
    """fasta_parse's passes in numpy, step for step, at a tile of ``tile``
    raw bytes in chunks of ``chunk`` (the kernel's 16-byte loads; at most
    16), ``lanes`` chunks a warp-round. parse_tile_kernel: each chunk's
    kept masks (the flushing starts filled forward, the open line's bytes
    by the incoming kind), each warp-round's ballot scan (a lane's
    incoming kind from the nearest earlier lane where a line starts, its
    counts summed under both of the warp's incoming kinds) giving the
    warp-round's function (Fn, a word a kind, counts checked), warp 0's
    scan of a tile's warp-rounds and the tile's aggregate, the tiles'
    prefixes through Fn64 (the look-back's fold), then each chunk's kept
    bytes ('\\n' as 2) ORed into the tile's zeroed shared buffer at (O_t
    & 15) + its offset, packed by dropping bytes where at most 2 are
    dropped, else byte by byte, and the buffer stored at O_t - (O_t &
    15); per tile its '\\n' and flushing counts, the offset after its
    last '\\n' with that line's kind, its first cut candidate (2 total +
    1 without an EOF separator) and first bad byte. The tiles then settle
    the cut's and the bad byte's keys in a seeded random order (the
    read-skip: a tile whose candidate lies after the held one records
    nothing), the winner recording the flushing lines before its
    candidate. parse_finish_kernel: the last tile with a '\\n' (cr_L and
    its kind), the cut when its candidate lies below cr_L, the
    separators, the EOF separator and the window's zero bytes. Returns
    (out, sn, separators, first bad offset or -1)."""
    raw = np.frombuffer(data, np.uint8)
    F = len(raw)
    W = chunk or min(16, tile)
    assert tile % W == 0 and W <= 16
    per = tile // W                        # chunks a tile
    lanes = lanes or min(per, 32 if per >= 32 else 2 if per % 2 == 0
                         else 1)
    assert per % lanes == 0
    T = -(-F // tile)
    C = T * per
    cut_q = None if sn_limit <= 0 or sn_limit - 1 > F else sn_limit - 2
    pad = np.zeros(C * W, np.uint8)
    pad[:F] = raw
    byt = pad.reshape(C, W)
    weight = np.uint32(1) << np.arange(W, dtype=np.uint32)
    mask = lambda b: (b.astype(np.uint32) * weight).sum(1).astype(np.uint32)
    pos0 = np.arange(C, dtype=np.int64) * W
    vm = mask(pos0[:, None] + np.arange(W) < F)
    nl = mask(byt == 10) & vm
    gt = mask(byt == ord(">")) & vm
    prev = np.zeros(C, np.uint8)
    prev[1:] = byt[:-1, W - 1]
    st = ((pos0 == 0) | (prev == 10)).astype(np.uint32)
    ks, kf = _kept_masks(nl, gt, vm, st, W)
    full = np.uint32((1 << W) - 1)
    starts = (((nl << np.uint32(1)) | st) & full) != 0
    # the kind of the last byte's line, fixed where a line starts
    kout = ((~(ks ^ nl) >> np.uint32(W - 1)) & 1).astype(np.int64)
    cnt_s = np.bitwise_count(ks).astype(np.int64)
    cnt_f = np.bitwise_count(kf).astype(np.int64)
    # each warp-round (``lanes`` consecutive chunks) scanned by ballot: a
    # lane's incoming kind is the nearest earlier start lane's, or the
    # warp's; its counts summed under both of the warp's incoming kinds
    exc = np.zeros((C, 2), np.int64)
    prior = np.zeros(C, bool)
    kin = np.zeros(C, np.int64)
    groups = []
    for g0 in range(0, C, lanes):
        run = [0, 0]
        near = None
        for c in range(g0, g0 + lanes):
            exc[c] = run
            if near is not None:
                prior[c], kin[c] = True, kout[near]
                n = cnt_f[c] if kin[c] else cnt_s[c]
                mine = (n, n)
            else:
                mine = (cnt_s[c], cnt_f[c])
            run = [run[0] + mine[0], run[1] + mine[1]]
            assert max(run) < 1 << HALF, "a warp-round's count overflows"
            if starts[c]:
                near = c
        kw = (int(kout[near]), int(kout[near])) if near is not None \
            else (0, 1)
        groups.append((run[0] | (kw[0] << FN_BITS),
                       run[1] | (kw[1] << FN_BITS)))
    # warp 0's scan of each tile's warp-rounds, the tile's aggregate
    gpt = per // lanes
    gex = [FN_ID] * len(groups)
    agg = []
    for t in range(T):
        acc = FN_ID
        for g in range(t * gpt, (t + 1) * gpt):
            gex[g] = acc
            acc = _fn_combine(acc, groups[g])
        agg.append(acc)
    # the look-back: each tile's prefix, the fold of the aggregates before
    ot = np.zeros(T, np.int64)
    kt = np.zeros(T, np.int64)
    pre = (0, 0, 0, 1)
    for t in range(T):
        ot[t], kt[t] = pre[0], pre[1]
        pre = _fn64_combine(pre, _fn64(agg[t]))
    # each chunk's offset in its tile and incoming kind
    tile_of = np.arange(C) // per
    loc = np.zeros(C, np.int64)
    x = np.zeros(C, np.int64)
    for c in range(C):
        e = _branch(gex[c // lanes], int(kt[tile_of[c]]))
        xw = e >> FN_BITS
        loc[c] = (e & (KIND - 1)) + exc[c, xw]
        x[c] = kin[c] if prior[c] else xw
    K = np.where(x == 1, kf, ks).astype(np.uint32)
    o = ot[tile_of] + loc
    # each chunk's kept bytes ('\n' as 2) ORed into its tile's zeroed
    # shared buffer at (O_t & 15) + its offset: packed by dropping its
    # dropped bytes, the highest first, where at most 2 are dropped, else
    # byte by byte
    out = np.full(max(F + window, 1), 0xEE, np.uint8)   # torch.empty's
    for t in range(T):
        a = int(ot[t]) & 15
        sbuf = np.zeros(tile + 32, np.uint8)
        for c in range(t * per, (t + 1) * per):
            k, n = int(K[c]), int(nl[c])
            v = byt[c].copy()
            v[_bits(np.array([k & n], np.uint32), W)[0]] ^= 8   # 10 -> 2
            sb = a + int(loc[c])
            dropped = ~k & ((1 << W) - 1)
            if bin(dropped).count("1") <= 2:
                packed = int.from_bytes(v.tobytes(), "little")
                for i in sorted((i for i in range(W) if dropped >> i & 1),
                                reverse=True):
                    low = packed & ((1 << 8 * i) - 1)
                    packed = low | ((packed >> 8 * (i + 1)) << 8 * i)
                sbuf[sb:sb + W] |= np.frombuffer(
                    packed.to_bytes(W, "little"), np.uint8)
            else:
                for j in range(W):
                    if k >> j & 1:
                        sbuf[sb + bin(k & ((1 << j) - 1)).count("1")] |= v[j]
        kept_t = _branch(agg[t], int(kt[t])) & (KIND - 1)
        base = int(ot[t]) - a
        out[base + a:base + a + kept_t] = sbuf[a:a + kept_t]
    # per tile: counts, the last '\n', the first cut candidate, bad byte
    lines = int(np.bitwise_count(nl).sum())
    fl_c = np.bitwise_count(K & nl).astype(np.int64)
    fl_t = fl_c.reshape(T, per).sum(1) if T else np.zeros(0, np.int64)
    last = np.full(T, -1, np.int64)
    for c in np.nonzero(nl)[0]:
        i = int(nl[c]).bit_length() - 1
        k = int(K[c])
        last[tile_of[c]] = 2 * (int(o[c]) + bin(k & ((2 << i) - 1))
                                .count("1")) + ((k >> i) & 1)
    below = lambda k, i: bin(k & ((1 << i) - 1)).count("1")
    cand = {}
    bad_t = {}
    badm = mask(((byt < 3) | (byt >= 128)) & (byt != 2)) & K & ~nl
    for c in range(C):
        t, k = int(tile_of[c]), int(K[c])
        if cut_q is not None and t not in cand:
            need = cut_q - int(o[c])
            ge = k if need < W else 0
            for _ in range(max(need, 0) if ge else 0):
                ge &= ge - 1
            sb = ge & ~int(nl[c])
            if sb:
                i = (sb & -sb).bit_length() - 1
                p = int(o[c]) + below(k, i)
                enc = 2 * (p + 1) if p == cut_q else 2 * p + 1
                cand[t] = (enc, (c - t * per) * W + i)
        if badm[c] and t not in bad_t:
            i = (int(badm[c]) & -int(badm[c])).bit_length() - 1
            bad_t[t] = int(o[c]) + below(k, i)
    cut_key, bad_key = None, None
    record = {}
    for t in np.random.default_rng(seed).permutation(T):
        t = int(t)
        if t in bad_t and (bad_key is None or bad_t[t] < bad_key):
            bad_key = bad_t[t]
        if t in cand:
            enc, craw = cand[t]
            if cut_key is None or t * tile + craw < cut_key:
                cc, ci = divmod(craw, W)
                f = K[t * per:t * per + per] & nl[t * per:t * per + per]
                fb = int(np.bitwise_count(f[:cc]).sum()) + below(int(f[cc]),
                                                                  ci)
                record[t] = (enc, fb)
                cut_key = t * tile + craw
    # the finish
    lt = np.nonzero(last >= 0)[0]
    lastv = int(last[lt[-1]]) if lt.size else -1
    crl = lastv >> 1 if lastv >= 0 else 0
    total, eof, limit, fb = crl, lastv >= 0 and not lastv & 1, T, 0
    if cut_key is not None:
        enc, fbc = record[cut_key // tile]
        if enc >> 1 < crl:
            total, eof, limit, fb = enc >> 1, not enc & 1, \
                cut_key // tile, fbc
    seps = int(fl_t[:limit].sum()) + fb + eof
    sn = total + eof
    for p in range(total, min(sn + window, F + window)):
        out[p] = 2 if (p == total and eof) else 0
    bad = bad_key if bad_key is not None and bad_key < total else NONE
    assert lines == data.count(b"\n")
    return out[:sn + window], sn, seps, bad


def _check_model(data: bytes, lim: int, p, tiles=MODEL_TILES) -> None:
    for k, tile in enumerate(tiles):
        out, sn, seps, bad = kernel_model(data, lim, WINDOW, tile, seed=k)
        assert (sn, seps, bad) == (p.sn, p.n_separators, p.bad), tile
        assert bytes(out) == bytes(p.sx_padded.numpy()), tile


@pytest.mark.parametrize("data,lim", list(_cases()))
def test_parse_matches_jax(data, lim, tmp_path):
    _check(data, lim, tmp_path)


@pytest.mark.parametrize("tile", MODEL_TILES)
@pytest.mark.parametrize("data,lim", list(_cases()))
def test_kernel_model_matches_the_plain_version(data, lim, tile):
    """The model of fasta_parse's passes at a tile of 1, 4, 16 and 64
    bytes equals parse_collection_reference exactly (SX with the window's
    zero bytes, sn, separators, first bad offset), every case crossing
    tiles."""
    p = parse.parse_collection_reference(_raw(data), lim, WINDOW)
    _check_model(data, lim, p, (tile,))


def _unwrapped(n_docs: int, length: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return b"".join(b">doc%d\n" % i + rng.choice(acgt, length).tobytes()
                    + b"\n" for i in range(n_docs))


@pytest.mark.parametrize("name", ["unwrapped", "wrapped", "headers_long",
                                  "one_byte_lines"])
def test_kernel_model_at_the_kernel_tile(name):
    """The model at fasta_parse.cu's own tile (16-byte chunks, warp-rounds
    of 32): tiles and warp-rounds whose every byte is kept reach their
    counts' budgets (a tile's under 2^31 in each word of Fn, a
    warp-round's 512 under 2^16 in the ballot scan's halves, both checked
    by the model), and a line or a header spans several tiles."""
    tile = kernel_tile()
    assert tile < 1 << FN_BITS and 32 * 16 < 1 << HALF
    data = {
        "unwrapped": _unwrapped(3, 2 * tile + 777, 1),
        "wrapped": make_fasta([random_dna(np.random.default_rng(2), 3 * tile)
                               ], width=60),
        "headers_long": b">" + b"h" * (2 * tile + 3) + b"\n" + b"A" * tile
        + b"\n>" + b"i" * tile + b"\nCC\n",
        "one_byte_lines": b"A\n" * (tile + 9),
    }[name]
    for lim in (BIG, len(data) // 2, tile + 1):
        p = parse.parse_collection_reference(_raw(data), lim, WINDOW)
        _check_model(data, lim, p, (tile,))


M32 = 0xFFFFFFFF


def _zero_bytes(x: int) -> int:
    """fasta_parse.cu's zero_bytes: 0x80 in each byte of x that is 0."""
    return ~(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x | 0x7F7F7F7F) & M32


def _nib(m: int) -> int:
    return (((m >> 7) * 0x10204080) & M32) >> 28


def _spread8(n: int) -> int:
    return (((n * 0x00204081) & M32) & 0x01010101) << 3


def _odd(x: int) -> bool:
    """chunk_masks' cheap test on one word: a '>', or a byte < 2 or >= 128."""
    y = x ^ 0x3E3E3E3E
    t = (((x - 0x02020202) & M32) & ~x) | (((y - 0x01010101) & M32) & ~y) | x
    return bool(t & 0x80808080)


def _words(b: bytes) -> list:
    return [int.from_bytes(b[4 * k:4 * k + 4], "little") for k in range(4)]


def _funnel_r(lo: int, hi: int, sh: int) -> int:
    return (((hi << 32) | lo) >> (sh & 31)) & M32


def _funnel_l(lo: int, hi: int, sh: int) -> int:
    return ((((hi << 32) | lo) << (sh & 31)) >> 32) & M32


def _drop_byte(x: list, i: int) -> list:
    """fasta_parse.cu's drop_byte on four words."""
    y = [_funnel_r(x[k], x[k + 1], 8) for k in range(3)] + [x[3] >> 8]
    out = []
    for k in range(4):
        sh = min(max(8 * (i - 4 * k), 0), 32)
        low = ((1 << sh) - 1) & M32
        out.append((x[k] & low) | (y[k] & ~low & M32))
    return out


_SPECIAL = [0, 1, 2, 3, 10, 13, 0x3E, 0x41, 0x7F, 0x80, 0x81, 0xFE, 0xFF]


@pytest.mark.parametrize("helper", ["zero_bytes", "nib_spread8", "odd",
                                    "drop_byte", "five_words"])
def test_chunk_word_helpers(helper):
    """fasta_parse.cu's 32-bit word arithmetic, emulated operation by
    operation, against the plain byte-wise meaning on seeded random words
    and every special byte in every position: zero_bytes marks exactly the
    zero bytes (no borrow between bytes), nib and spread8 move a byte mask
    to bits and back, chunk_masks' warp filter says yes exactly when a
    byte is '>' or below 2 or from 128, drop_byte removes one byte of 16
    at every position, and the five words ORed at a byte offset s hold the
    packed bytes at s."""
    rng = np.random.default_rng(11)
    words = [int(v) for v in rng.integers(0, 2**32, 400, dtype=np.uint64)]
    for v in _SPECIAL:
        for k in range(4):
            words.append((v << 8 * k) | 0x41414141 & ~(0xFF << 8 * k))
            words.append((v << 8 * k) | (0x0A0A0A0A & ~(0xFF << 8 * k)))
    for x in words:
        b = x.to_bytes(4, "little")
        if helper == "zero_bytes":
            want = sum(0x80 << 8 * j for j in range(4) if b[j] == 0)
            assert _zero_bytes(x) == want, hex(x)
            assert _nib(_zero_bytes(x)) == sum(1 << j for j in range(4)
                                               if b[j] == 0)
        elif helper == "nib_spread8":
            n = _nib(_zero_bytes(x ^ 0x0A0A0A0A))
            assert n == sum(1 << j for j in range(4) if b[j] == 10)
            assert (x ^ _spread8(n)).to_bytes(4, "little") == bytes(
                2 if c == 10 else c for c in b)
        elif helper == "odd":
            assert _odd(x) == any(c == 0x3E or c < 2 or c >= 128
                                  for c in b), hex(x)
    if helper == "drop_byte":
        for _ in range(200):
            chunk = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for i in range(16):
                got = b"".join(w.to_bytes(4, "little")
                               for w in _drop_byte(_words(chunk), i))
                assert got == chunk[:i] + chunk[i + 1:] + b"\0", i
    if helper == "five_words":
        for _ in range(200):
            c = int(rng.integers(0, 17))
            packed = rng.integers(1, 256, c, dtype=np.uint8).tobytes()
            p = _words(packed + bytes(16 - c))
            for f in range(4):
                sh = 8 * f
                z = [(p[0] << sh) & M32] + [_funnel_l(p[k - 1], p[k], sh)
                                            for k in range(1, 4)]
                z.append(_funnel_l(p[3], 0, sh) if sh else 0)
                got = b"".join(w.to_bytes(4, "little") for w in z)
                assert got[f:f + c] == packed and not any(got[:f]) \
                    and not any(got[f + c:]), (c, f)


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
    lim = cut if cut < 1100 else BIG
    with tempfile.TemporaryDirectory() as d:
        _check(data, lim, pathlib.Path(d))
    _check_model(data, lim, parse.parse_collection_reference(_raw(data), lim,
                                                             WINDOW))


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
