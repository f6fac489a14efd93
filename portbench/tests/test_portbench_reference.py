"""The plain reference: the collection string by the tool's rules, the
suffix order with separators in document order, the records, and
agreement with a brute-force sort and with the port on the CPU."""
import numpy as np
import pytest
import torch

from portbench import reference, workload

SEP = reference.SEPARATOR


def sx_of(data: bytes) -> bytes:
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return bytes(reference.collection_string(raw).numpy())


@pytest.mark.parametrize("data,want", [
    (b">a\nAC\nGT\n>b\nTT\n", b"\x02ACGT\x02TT\x02"),
    (b">a\nAC\nGT\n>b\nTT", b"\x02ACGT\x02"),      # a last line unread
    (b">a\nAC\n\nGG\n", b"\x02AC\x02GG\x02"),           # an empty line
    (b">a\nAC\n>b\n", b"\x02AC\x02"),                   # the last doc empty
    (b"ACGT\n>b\nCC\n", b"ACGT\x02CC\x02"),             # no first header
    (b">a\nACGTACGTAC\n>b\nCCCCCCCC\n>c\nG\n",
     b"\x02ACGTACGTAC\x02CCCCCCCC\x02G\x02"),
])
def test_collection_string(data, want, tmp_path):
    assert sx_of(data) == want
    # the port's host parser, a second witness
    from cmsbwt_tpu_torch.io import fasta
    path = tmp_path / "c.fa"
    path.write_bytes(data)
    coll = fasta.parse_collection(str(path), len(data), use_native=False)
    assert bytes(coll.sx) == want


def test_cut_is_refused():
    with pytest.raises(ValueError, match="cut"):
        sx_of(b"ACGTACGT\n")


def brute_rl(sx: bytes) -> bytes:
    t, d = [], 0
    nseps = sx.count(SEP)
    for c in sx:
        if c == SEP:
            t.append(d)
            d += 1
        else:
            t.append(nseps + c)
    sa = sorted(range(len(t)), key=lambda i: t[i:])
    bwt = bytes(sx[(i - 1) % len(sx)] for i in sa)
    out, i = b"", 0
    while i < len(bwt):
        j = i
        while j < len(bwt) and bwt[j] == bwt[i]:
            j += 1
        out += (j - i).to_bytes(8, "little") + bwt[i:i + 1]
        i = j
    return out


@pytest.mark.parametrize("seed", range(8))
def test_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.choice(np.frombuffer(b"ACGT" if seed % 2 else b"AC",
                                           np.uint8),
                             size=int(rng.integers(0, 40))))
            for _ in range(int(rng.integers(1, 6)))]
    if seed == 0:
        docs = [b"ACACAC", b"ACACAC", b"ACACAC"]     # equal documents
    sx = b"".join(bytes([SEP]) + d for d in docs) + bytes([SEP])
    got = reference.rl_bwt(torch.frombuffer(bytearray(sx),
                                            dtype=torch.uint8))
    assert got == brute_rl(sx)
    plain = reference.bwt(torch.frombuffer(bytearray(sx), dtype=torch.uint8))
    runs = brute_rl(sx)
    assert bytes(plain.numpy()) == b"".join(
        runs[k + 8:k + 9] * int.from_bytes(runs[k:k + 8], "little")
        for k in range(0, len(runs), 9))


def test_mismatch_bytes():
    assert reference.mismatch_bytes(b"abc", b"abc") == 0
    assert reference.mismatch_bytes(b"abc", b"abd") == 1
    assert reference.mismatch_bytes(b"abc", b"ab") == 1
    assert reference.mismatch_bytes(b"", b"xyz") == 3


@pytest.mark.parametrize("seed,docs,per,rate", [
    (2**31 + 1, 6, None, 0.01), (2**32 + 9, 9, 3, 0.002), (5, 4, 2, 0.05)])
def test_agrees_with_the_port_on_the_cpu(tmp_path, seed, docs, per, rate):
    from cmsbwt_tpu_torch.config import Config
    from cmsbwt_tpu_torch.models.cms_bwt import CMSBWT
    files = workload.write_workload(tmp_path, seed, 2500, docs, rate,
                                    docs_per_file=per)
    model = CMSBWT(str(tmp_path / "ref.fa"),
                   Config(replicate_reference_rle_quirk=False), "cpu")
    for f in files:
        r = model.transform(str(f), rle=True)
        assert reference.output_of_file(str(f), "cpu", True) == (r.sn,
                                                                  r.rle)
        assert reference.output_of_file(str(f), "cpu", False) == (
            r.sn, model.transform(str(f), rle=False).bwt)
