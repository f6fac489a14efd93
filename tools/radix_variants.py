"""Where radix_sort.cu spends its time, on one CUDA card.

    python3 tools/radix_variants.py [ROWS]

Builds variants of this tree's radix_sort.cu with the port's nvcc flags,
each the committed source with other -D settings or a text edit, and
times each on keys shaped like the device merge's join at 500 Mchars
(ROWS rows, default 493 043 503: key1 int32 of 23 bits with a fifth of
the rows its pad, key2f int64 of 47 bits; both uniform, made on the card
from seed 12): the whole sort as ops/sort.stable_argsort runs it (with
key1's sorted values; CUDA events, 3 sorts back to back, two rounds), and
each launch of the last sort (an event after every launch): the
wrapper's set-up (its scratch memset, and the host's work while the card
waits), radix_hist, then each pass of kernels.radix_plan (the composite
plan here: the first reads both keys in place, the others the words
before them, u64 or u32). Each variant's permutation is held to the
committed kernel's.

* ``committed`` — the source as it is (8-bit digits; 256 threads x 12
  rows, the launch bound at 3 blocks an SM; lanes grouped by digit with a
  ballot per digit bit; row ids copied in with cp.async as the keys
  load; a digit's look-back reading 8 tiles' words at once);
* ``radix11`` — 11-bit digits (7 passes, not 9; 2048 digits a tile);
* ``batch1`` — the look-back reading one tile's word at a time;
* ``match`` — lanes grouped by digit with __match_any_sync;
* ``no_prefetch`` — the row ids loaded once the ranks are known, not
  copied into shared memory as the keys load;
* ``atomic`` — no look-back: a tile takes its place per digit by an
  atomic add (its output is a permutation, not a stable one): the cost
  of everything but the look-back's waits;
* ``rank_atomic`` — a row's rank among its warp's equal digits by a
  shared atomic add (a permutation, not a stable one): the ballots' cost;
* ``no_stores`` — the write-out stores nothing (its outputs are wrong):
  the stores' cost;
* ``items8_blocks4`` — 8 rows a thread at 4 blocks an SM;
* ``threads512_items6`` — 3072-row tiles over 512 threads, 2 blocks an
  SM.

The committed variant also sorts each key alone and a copy of key2f
made just before, launch by launch.

Prints the card's name and power limit, each variant's registers and
spills (nvcc -Xptxas=-v) and its pass kernel's blocks an SM (CUDA's
occupancy calculator), then one line per variant and round. Works in
_profile_work/ (gitignored) and deletes it."""
from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cmsbwt_tpu_torch import kernels as K  # noqa: E402
from cmsbwt_tpu_torch.ops import sort as S  # noqa: E402

WORK = ROOT / "_profile_work" / "radix_variants"
# text edits: (the committed source's text, the variant's)
MATCH = ("  unsigned peers = __ballot_sync(FULL, valid);",
         "  return __match_any_sync(FULL, valid ? d : (1 << RB) + "
         "int(threadIdx.x & 31));\n  unsigned peers = 0;")
NO_PREFETCH = [
    ("if (s < cnt) copy_async4(inrows + s, a.rows_in + row0 + s);", ""),
    ("srows[off[i]] = a.rows_in ? inrows[s] : unsigned(row0 + s);",
     "srows[off[i]] = a.rows_in ? __ldg(a.rows_in + row0 + s)"
     " : unsigned(row0 + s);")]
# (the counts of pass + 16 are zero and unused: MAX_PASSES is 32)
ATOMIC = ("      unsigned prefix = 0;\n      if (t > 0) {",
          "      unsigned prefix = atomicAdd(const_cast<unsigned*>(ghist) + "
          "16 * BINS + d, cnts[j]);\n      if (false) {")
RANK_ATOMIC = ("    const unsigned peers = peers_of<RB>(d, valid);",
               "    if (true) {\n      off[i] = valid ? atomicAdd(wh + d, 1u)"
               " : 0u;\n      continue;\n    }\n"
               "    const unsigned peers = peers_of<RB>(d, valid);")
NO_STORES = ("    a.rows_out[pos] = srows[s];",
             "    if (pos != 0xffffffffu) break;\n"
             "    a.rows_out[pos] = srows[s];")
VARIANTS = {   # name: (-D flags, text edits)
    "committed": ([], []),
    "radix11": (["-DRS_RADIX_BITS=11"], []),
    "batch1": (["-DRS_LB_BATCH=1"], []),
    "match": ([], [MATCH]),
    "no_prefetch": ([], NO_PREFETCH),
    "atomic": ([], [ATOMIC]),
    "rank_atomic": ([], [RANK_ATOMIC]),
    "no_stores": ([], [NO_STORES]),
    "items8_blocks4": (["-DRS_ITEMS=8", "-DRS_MIN_BLOCKS=4"], []),
    "threads512_items6": (["-DRS_THREADS=512", "-DRS_ITEMS=6",
                           "-DRS_MIN_BLOCKS=2"], []),
}
JOIN_ROWS = 493_043_503


def build() -> dict:
    """Every variant's library, built by parallel nvcc processes; prints
    the pass kernels' registers and spills and their blocks an SM."""
    WORK.mkdir(parents=True, exist_ok=True)
    text = (K.CSRC / "radix_sort.cu").read_text()
    jobs = {}
    for name, (flags, edits) in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{name}: radix_sort.cu no longer holds "
                                 f"{old!r}")
            src = src.replace(old, new)
        path = WORK / f"radix_sort_{name}.cu"
        path.write_text(src)
        jobs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, *flags, f"-I{K.CSRC}", "-o",
             str(WORK / f"lib_{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        entry = ""
        for line in out.splitlines():
            m = re.search(r"radix_(pass|hist)_kernelILi(\d+)E(\w?)", line)
            if "Compiling entry function" in line and m:
                entry = f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
            elif "registers" in line and entry:
                print(f"build {name}: {entry}: {line.strip()}")
        lib = ctypes.CDLL(str(WORK / f"lib_{name}.so"))
        K.bind_radix_sort(lib)
        libs[name] = lib
        print(f"build {name}: pass blocks an SM (u32 / u64 words, "
              "composed u64): " + ", ".join(
                  str(lib.radix_pass_blocks_per_sm(w, c))
                  for w, c in ((0, 0), (1, 0), (1, 1))), flush=True)
    return libs


def join_keys(rows: int):
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    key1 = torch.randint(0, (1 << 23) - 1, (rows,), generator=g,
                         device="cuda", dtype=torch.int32)
    key1[torch.rand(rows, generator=g, device="cuda") < 0.2] = S.INT_MAX
    key2f = torch.randint(0, (1 << 47) - 1, (rows,), generator=g,
                          device="cuda", dtype=torch.int64)
    return (key1, key2f), (23, 47)


def timed_sort(keys, bits, reps: int = 3) -> tuple:
    """(ms per sort over ``reps`` back to back, [(launch, ms)] of the last
    sort, its permutation)."""
    fault = S.fault_word("cuda:0")
    marks = []
    orig = K._launch

    def launch(name, err):
        orig(name, err)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    K.radix_sort_cuda(keys, bits, fault, True)     # warm
    torch.cuda.synchronize()
    # an event just before radix_hist too: its own time, apart from the
    # wrapper's scratch memset and host work before it
    lib = K._libs["radix_sort"]
    hist = lib.radix_hist_launch

    def hist_launch(*a):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(("before radix_hist", ev))
        return hist(*a)
    lib.radix_hist_launch = hist_launch
    K._launch = launch
    try:
        start.record()
        for _ in range(reps):
            marks.clear()
            first = torch.cuda.Event(enable_timing=True)
            first.record()
            perm, _ = K.radix_sort_cuda(keys, bits, fault, True)
        end.record()
        torch.cuda.synchronize()
    finally:
        K._launch = orig
        lib.radix_hist_launch = hist
    steps, prev = [], first
    for name, ev in marks:
        steps.append((name, prev.elapsed_time(ev)))
        prev = ev
    return start.elapsed_time(end) / reps, steps, perm


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else JOIN_ROWS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    K.load()
    libs = build()
    keys, bits = join_keys(rows)

    def labels(lib):
        plan = K.radix_plan(bits, int(lib.radix_sort_radix_bits()), True)
        return ["set-up", "radix_hist"] + [
            f"pass {at} "
            f"({'keys' if ps.keys else 'u64' if ps.in_wide else 'u32'}"
            f"{', gathers' if ps.next is not None else ''})"
            for at, ps in enumerate(plan)]
    want = None
    try:
        for rnd in (1, 2):
            for name, lib in libs.items():
                K._libs["radix_sort"] = lib
                ms, steps, perm = timed_sort(keys, bits)
                if want is None:
                    want = perm.clone()
                same = bool(torch.equal(perm, want))
                del perm
                split = ", ".join(f"{lab} {t:.3f}" for lab, (_, t)
                                  in zip(labels(lib), steps))
                print(f"round {rnd} {name}: {ms:.3f} ms per sort of {rows} "
                      f"rows (equal to committed: {same}); launches ms: "
                      f"{split}", flush=True)
                if rnd == 1 and name == "committed":
                    for what, one, b in (
                            ("key2f", keys[1], 47), ("key1", keys[0], 23),
                            ("a copy of key2f", keys[1].clone(), 47)):
                        ms, steps, perm = timed_sort((one,), (b,))
                        del perm, one
                        print(f"committed, {what} alone: {ms:.3f} ms; "
                              "launches ms: " + ", ".join(
                                  f"{t:.3f}" for _, t in steps), flush=True)
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
