"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):

1. device  — require CUDA; print the card's name and power limit, and the
   host's CPU model (the host merge's times are the host's).
2. build   — build the port's CUDA kernels from cmsbwt_tpu_torch/kernels/csrc.
3. kernel  — the CUDA ms_jump_scan (fed the index's 128-wide block trees)
   against its plain torch version (ms_jump_scan_reference, fed the
   [levels, n] sparse tables) on the card, on the raw scan state (records,
   nrec, viol): 200 Kbp x 8 docs at 1% SNP, the same with 8 record slots
   per lane (lanes overflow: records past the capacity are dropped and
   still counted, and viol is raised), a separator-dense case, an
   identical-copies case, a 4-char reference (augmented to 127 chars: a
   tree with no level above its one block), and the bench's primary shape,
   where the kernel is also timed at 32768 and 131072 lanes. Tolerance:
   exact equality (every value is an integer or a byte).
4. dense kernels — the CUDA lcp_lift and dense_neighbors against their
   plain torch versions (lift_pairs, neighbors_reference) on the card, on
   inputs from the port's own dense stages, on the bench's primary shape
   (wide seed), on 200 Kbp x 8 docs with an N run in each doc (narrow
   seed) and on a separator-dense case. The lift runs on the rho
   irreducible rows with lmax from the stats (the main path's call), on
   the rho_pad rows of the earlier call. dense_neighbors also runs on
   synthetic rows at the edges of its tiles, warps and carry rounds
   (m = 1, 31, 32, 33, a tile +- 1, three tiles +- 1, runs of tiles with
   no reference slot, every or no slot a reference slot, three carry
   chunks). On the primary joint string the joint suffix sort's kernels
   are held to their plain versions on the scan's own calls, as each is
   made (JointTimers): radix_sort at every stable_argsort site of
   ops/joint_sa.py and ops/ms_dense.py (sort_times: beside torch.sort
   passes on the same keys), sa_round on the seed's rank step (its seed
   mode, _seed_ranks_reference; the wide seed) and on every round's, full
   and compacted (_round_ranks_reference), running_fill on the first flag
   fill. Tolerance: exact equality.
5. jump slice — the port's CLI (jump scan + device merge, --device cuda)
   on the bench's primary workload (2 Mbp reference x 10 docs at 1% SNP,
   about 20 Mchars), plain and -r. Outputs must be byte-equal to the C++
   reference tool's (baseline/cms-bwt-ref, run on the same input list),
   the scan's heads equal to those of the native C++ PLCP-skip scan
   (native/cmsbwt_scan.cpp, built here with g++) at 4096 and 32768 lanes,
   and the CUDA kernel must have carried the scan. Then the host merge
   (merge_from_heads: numpy and the native OpenMP runtime) against the
   device merge on the jump scan's heads, twice each in turns:
   (run_len, run_char, counter) equal, the host runs normalised as the
   device merge emits them (empty runs dropped, equal neighbours joined);
   both times and the host merge's stages printed.
6. dense slice — the same CLI with --backend dense --merge-backend device
   on the same workload, plain and -r: bytes equal to the reference
   tool's, the dense scan's heads equal to the native scan's, and the
   dense route's kernels (ROUTE_KERNELS: lcp_lift, dense_neighbors,
   radix_sort, running_fill, sa_round; not their plain versions) must
   have carried it. Prints the .log phases and the dense stage split.
   Then the routes that end in the host merge, plain and -r, bytes equal
   to the reference tool's: --backend device (the jump scan's heads
   expanded to every position), --backend native (its .log must name the
   native engine), --backend jump and dense with --merge-backend host, and
   the int64 route for collections at or above 2^31 chars, forced with
   CMSBWT_SN_BOUND=4000000 (the dense scan in 2 M-char blocks, heads to
   the host with an int64 t, the host merge; both dense kernels held to
   their plain versions on its first block); --backend host (the Python
   spec scan) on 30 Kbp x 8 docs, against the tool run on that input.
7. blocked slice — the same workload through the blocked dense scan: the
   CLI with --block-chars 4194304, plain and -r (bytes equal to the
   reference tool's; each dense kernel launched once per block try and no
   plain version), its heads equal to the native scan's; CMSBWT_HBM_GB=2,
   so that the memory guard chooses the blocks (its choice printed); a
   4-char context on the 200 Kbp workload, so that blocks retry (the
   retries printed; heads and reference index equal to the unblocked
   scan's); --checkpoint-dir run twice (the first saves each block and
   the whole-run dense_heads bundle; the second loads the bundle, scans no
   block and launches no dense kernel; bytes equal). Both dense kernels
   are held to their plain
   versions (exact) on the first 4 Mi-char block as the CLI ran it (its
   window, separator base and pad, from BlockLog).
8. 500 Mchar — the bench's ecoli_rle shape at BENCH_FULL=1 (5 Mbp x 100
   docs at 1% SNP, ~500 Mchars, above what the unblocked scan needs on an
   80 GB card) through the CLI with -r --no-rle-quirk and no
   --block-chars, so the guard chooses the blocks: its heads equal to the
   jump scan's on the card, the .rl_bwt decoding to sn chars with the
   collection's byte histogram (the quirk's extra residual runs would
   make it longer; its bytes against the reference tool are
   tools/profile_slice.py --blocked's check). Prints the blocks, retries,
   per-block stage marks (CMSBWT_PROFILE=1, stderr), phases, peak device
   bytes per block and the wall time. Then both dense kernels against
   their plain versions (exact) on that run's first block (m ~ 252 M,
   narrow seed), with the joint sort's kernels held to their plain
   versions and timed on that block's own calls (radix_sort at every
   site, sa_round on the narrow seed's rank step and on the first full
   round, running_fill on the first flag fill), and the host merge on that run's heads: its .rl_bwt bytes equal
   to the device merge's (the CLI's), its stages printed.
9. auto, model, parallel — at the primary workload: the CLI with no
   --backend (auto), plain and -r, bytes equal to the reference tool's,
   the backend its .log names printed, and that route's kernels
   (ROUTE_KERNELS) must have carried it; the CMSBWT model on cuda,
   transform(backend="jump"), "dense" and "jump" again on the device
   merge, then "jump" and "dense" with merge_backend "host" (no
   merge_device phase, the host merge's kernels counted), each .bwt equal
   to the reference tool's, the device index built once; ms_dense on the
   200 Kbp workload against the jump scan's heads expanded per position
   (ops/ms_device.ms_scan_device): pos, length and is_head equal at every
   position, smaller at the heads; --parallel --block-chars 4194304
   (five blocks), plain and -r, bytes equal to the reference tool's,
   heads equal to the native scan's (and those of
   parallel/blocked.ms_dense_heads_parallel on the card), each dense
   kernel launched once per block try and no plain version.
10. mesh — the mesh modules on R = torch.cuda.device_count() ranks, one
   NCCL rank per card (a one-rank group on one card): the CLI with
   --backend jump and dense and --merge-backend sharded at the primary
   workload, plain and -r, bytes equal to the reference tool's (the .log
   must name merge_sharded); the mesh scan
   (parallel/mesh.ms_dense_heads_mesh) in 4 Mi-char blocks, its heads
   equal to the jump scan's and both dense kernels launched for every
   block on one rank; the giant-reference route
   (CMSBWT_GIANT_THRESHOLD=64: the sharded int64 index, the native int64
   scan, the host merge) on the short reference, plain and -r, bytes
   equal to the normal route's, launching no kernel. Prints each mesh
   run's rank start-up and work seconds and peak device bytes per rank
   (parallel/distributed.LAST_RUN).
11. merge kernels — the device merge's CUDA kernels against their plain
   torch versions on the card (exact): running_fill
   (running_fill_reference: torch.cummax / cummin, flipped for reverse)
   at the edges of its tiles (FILL_SIZES: 1, 3, 64, a tile +- 1 and three
   tiles + 5, in int32 and int64), max and min, forward and reverse, with
   the dtype's extremes and the merge's sentinels, each also on the view
   v[1:] (rows off the 16-byte frame), and at 2^29 + 1 int64 rows
   forward (max) and reverse (min), timed alone and as the wrapper runs
   it beside Tensor.copy_ of the same bytes, one 1-D torch.cummax /
   cummin and the row-blocked form the port used before; bucket_sums
   (_bucket_sums_reference) on built lanes at its tile edges (BS_TILE)
   with short and long rank gaps, its outputs given memory that held
   0x5A bytes (garbage_outputs: a slot it leaves unwritten shows), and on
   a falling bucket_rank and a bid off by one inside a tile, where it
   must set its plain version's fault word; running_fill (the
   merge's largest fill), tail_good_join (_tail_good_join_reference),
   tail_exact_credit (_exact_credit_reference), bucket_sums (timed beside
   three Tensor.index_add_), run_merge (_run_merge_reference),
   pair_expand (_pair_expand_reference: tail_good's join rows),
   dense_rank (index/device._dense_rank_reference: the head string's
   first round's full rank step, every output: the group-start ranks,
   the slice of unresolved rows and its key 1; and the reference index's
   round 0 in the dense mode, captured from the jump scan's index build
   (IndexRankCapture): the dense ranks and the next key) and
   dense_rank_comp (_comp_rank_reference: the head string's first
   compacted round, sorted per group in shared memory: the ranks and
   places written, the next slice and its key 1; _comp_tail_reference:
   its tail, every round left in one block) on the
   inputs a real device merge gave them (MergeCapture), of the jump
   scan's heads at primary (in phase 5) and of the 500 Mchar run's heads
   (in phase 8, which also holds the peak outside the blocks to the
   merge's ceiling, MERGE_BYTES_PER_CHAR per collection char);
   running_fill and bucket_sums there also alone (CUDA events around the
   launches only), beside Tensor.copy_ of the same bytes and one 1-D
   torch.cummax / cummin of the fill; pair_expand, dense_rank and
   dense_rank_comp also alone and beside Tensor.copy_ of their bound's
   bytes. rank_cases holds dense_rank in both modes and dense_rank_comp
   to their plain versions at the tiles' and the cap's edges
   (rank_sizes(), RANK_KINDS), dense_rank_comp on made slices at its
   counting limit, through its bitonic sort, its large-group path and its
   tail (comp_slices) and the suffix sort on
   the card to the CPU's with and without its history, each compacted
   call held to its plain version (strings at the cap among them). Every
   run
   that merges on the device launches
   running_fill, tail_good_join, bucket_sums, run_merge, pair_expand and
   dense_rank, tail_exact_credit once per merge with exact pairs and
   dense_rank_comp once per compacted head-string call, a round or the
   tail (MERGE_KERNELS;
   a host merge may launch both rank kernels); the
   jump scan's index build launches dense_rank too; the
   sharded merge and the dense scan launch running_fill; no run launches
   a plain version. The device writer's rle_pack and bwt_expand
   (io/output: rle_pack_reference, bwt_expand_reference) on made run
   lists at their tiles' edges (output_cases: R = 0, 1, a record tile and
   a scan tile +- 1, three tiles + 5, 2^22 + 3, sums at an output tile
   +- 1, a leading char-0 run, runs longer than three output tiles, views
   off the 16-byte frame, a tile of T one-byte runs, sn = 3T in one-byte
   runs, one run of 2^22 + 3, runs across every tile start) and on the
   three faults (a length of 0, two neighbours of one char, lengths that
   do not sum to sn, by one and by three tiles: the kernel's fault word
   equal to the plain version's, the dispatch raising), and on the
   primary and 500 Mchar merges' runs (MergeCapture), timed alone, with
   the wrapper, beside Tensor.copy_ of the bound's bytes and, for
   bwt_expand, torch.repeat_interleave and its scan and expansion each
   alone. Every CLI run and model
   transform that merged on the device wrote its output through one
   rle_pack (.rl_bwt) or bwt_expand (.bwt) launch and downloaded no run
   array (engine/device_merge.RUN_DOWNLOADS); phases 5, 8 and 9 print
   each such run's write_output phase with the writer's R, bytes, kernel
   ms and staging copy seconds (io/output.LAST_WRITE).
12. parse — the collection parse's CUDA fasta_parse against its plain
   version (io/parse.parse_collection_reference) on the card, exact (SX
   and the window's zero bytes, sn, the separators, the first bad
   offset): on made files (parse_files: the CPU tests' cases, cuts among
   headers and at lines' ends, a 2 inside a line, bad bytes, and the
   kernel's 32 KB tile edges: a tile +- 1 byte, a header and a line
   across three tiles, tiles with no '\n', a '\n' as each tile's last
   byte, 1-byte lines, SX of a tile's bytes +- 1, an unwrapped line over
   five tiles, a 2 at a tile edge, bad bytes past the cut and in the
   tail, flushing lines over a tile edge before the cut line, cuts at
   tile edges) at windows 64 and 1, and on the primary and 500 Mchar
   collection files and the 500 Mchar collection written one line a
   document (unwrapped), as the pipeline reads them (io/parse.read_raw,
   timed), timed with the wrapper, alone, by part (torch.profiler: the
   scratch head's memset, the tile pass, the finish) and beside
   Tensor.copy_ of the bound's bytes. Every CLI run and every
   CMSBWT.transform of a path (phases 5-10) parsed its collection through
   one fasta_parse launch and no host parse (io/fasta.HOST_PARSES), and
   on the jump route SX went neither up (ops/ms_jump.SX_UPLOADS) nor down
   (io/fasta.SX_DOWNLOADS).

Imports nothing of JAX or of the JAX package (an import hook refuses
``jax``, ``jaxlib`` and ``cmsbwt_tpu``, so the port is shown to stand
alone): its oracles are the two C++ programs above. The reference-index
cache (CMSBWT_INDEX_CACHE) and the native runtimes' builds
(CMSBWT_NATIVE_DIR) live in the work directory, so every run builds its
own.

The kernels line gives, per kernel, its time at the primary shape (CUDA
events around 5 launches back to back; lcp_lift on the rho rows; the
times at the other shapes are on the kernel lines above it), the largest
error over every comparison, its
plain version's, its launches on the main path (every CLI run of its
route, the model's transforms and ms_dense, the counts set to 0 before
each path and read after it; ``launches_by_run`` splits them by path,
with the runs, the block tries and the merge engine of each; the native
and host routes launch none),
and bound_ms: the bytes the function must
move at these inputs (each input read once, each output written once; for
gathers, the entries this run's data touches) over 3.35 TB/s, the H100
SXM's memory rate. The merge kernels' rows give running_fill at 2^29 + 1
int64 rows (forward max), and tail_good_join, tail_exact_credit,
run_merge, pair_expand, dense_rank and dense_rank_comp on the 500
Mchar merge's inputs (the last three also at primary, and alone_ms and
copy_ms). library_ms is
one 1-D torch.cummax for running_fill, three Tensor.index_add_ for
bucket_sums and torch.repeat_interleave for bwt_expand; no single
PyTorch call computes any of the other functions, so theirs is null.
fasta_parse's row gives the 500 Mchar collection file and, under
``primary`` and ``unwrapped``, the primary's and the unwrapped 500 Mchar
file's; its bound counts the file read once and SX written once, and no
PyTorch call parses lines (library_ms null).
rle_pack's and bwt_expand's rows give the 500 Mchar merge's runs and,
under ``primary``, the primary merge's; their bounds count 14 B a run
(rle_pack) and 5 B a run plus sn (bwt_expand), and bwt_expand's its
scan's and its expansion's launches alone (starts_alone_ms,
tiles_alone_ms). running_fill's and
bucket_sums' rows also give alone_ms (the launches alone) and copy_ms
(Tensor.copy_ of the same bytes); running_fill's ``flag_fill`` the
joint sort's first flag fill at both shapes. radix_sort's ``sites`` hold the dense scan's sorts too
(marked "(dense)"). sa_round's row gives the first full round of the 500
Mchar run's first block, then every round at primary (``rounds``), and
the seed mode at both (``seed``); no PyTorch call computes its function,
so its library_ms is null.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import filecmp
import importlib.abc
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch


class _NoJax(importlib.abc.MetaPathFinder):
    """Refuse JAX and the JAX package: the port must run without them."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cmsbwt_tpu"):
            raise ImportError(f"{name}: blocked in chip_smoke.py (the port "
                              "imports neither JAX nor the JAX package)")
        return None


sys.meta_path.insert(0, _NoJax())

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"
REF_BIN = ROOT / "baseline" / "cms-bwt-ref"
NATIVE_SCAN = ROOT / "native" / "cmsbwt_scan.cpp"
TOL = 0  # exact: integer and byte outputs
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
BIG_DOCS = 100              # bench ecoli_rle at BENCH_FULL=1 (bench.py:176)
# the kernels each --backend's scan launches (the jump scan's index build:
# radix_sort and its rank steps' dense_rank, and its candidate compaction
# sort: radix_sort; the dense scan's joint sort: radix_sort, its flag
# fills and PLCP fill: running_fill, its rank steps: sa_round); native and
# host launch none
ROUTE_KERNELS = {"jump": ("ms_jump_scan", "radix_hist", "radix_pass",
                          "dense_rank"),
                 "device": ("ms_jump_scan", "radix_hist", "radix_pass",
                            "dense_rank"),
                 "dense": ("lcp_lift", "dense_neighbors", "running_fill",
                           "radix_hist", "radix_pass", "sa_round"),
                 "native": (), "host": ()}
# the kernels each merge engine launches ("none": a scan alone); the
# device merge launches tail_exact_credit once per merge with exact pairs,
# dense_rank in its head string's suffix sort's first round (and
# dense_rank_comp once a compacted round or tail after it, when it
# reaches one),
# pair_expand in tail_good, and its writer rle_pack once per .rl_bwt and
# bwt_expand once per .bwt (or model transform's bytes)
MERGE_KERNELS = {"device": ("running_fill", "tail_good_join",
                            "tail_exact_credit", "bucket_sums", "run_merge",
                            "radix_hist", "radix_pass", "compact",
                            "dense_rank", "dense_rank_comp", "pair_expand",
                            "rle_pack", "bwt_expand"),
                 "sharded": ("running_fill",), "host": (), "none": ()}
# kernels a route or a merge engine may launch: the native route builds
# its index on the card when the index cache misses, and the host merge
# sorts a long head string on the card (engine/ranking.py; both
# index/device.suffix_array_device)
MAY_LAUNCH = {"native": ("radix_hist", "radix_pass", "dense_rank"),
              "host": ("radix_hist", "radix_pass", "dense_rank",
                       "dense_rank_comp")}
# running_fill's tiles (running_fill.cu: 32 KB) and the sizes at their edges
FILL_TILE = {torch.int32: 8192, torch.int64: 4096}
FILL_SIZES = {dt: (1, 3, 64, T - 1, T, T + 1, 3 * T + 5)
              for dt, T in FILL_TILE.items()}
BIG_FILL = (1 << 29) + 1
BS_TILE = 4096              # bucket_sums' tile (run_merge.cu: BS_TILE)
SORT_TILE = 6144            # radix_sort.cu's TILE
COMPACT_TILE = 4096         # compact.cu's TILE
SORT_SIZES = (1, 2, 3, SORT_TILE - 1, SORT_TILE, SORT_TILE + 1, COMPACT_TILE,
              COMPACT_TILE + 1, 3 * COMPACT_TILE + 5, (1 << 22) + 3)
SORT_WIDTHS = ((1, torch.int32), (8, torch.int32), (23, torch.int32),
               (31, torch.int32), (48, torch.int64), (63, torch.int64))
SORT_KINDS = ("random", "ties", "equal", "descending", "pads", "top",
              "mixed")
SORT_SKEWED = ("pad_runs", "one_digit", "lane_tails")   # skewed_keys
# several keys, most significant first: (bits, dtype, kind)
SORT_MULTI = {
    "join": ((23, torch.int32, "mixed"), (48, torch.int64, "ties")),
    "group": ((23, torch.int32, "ties"), (53, torch.int64, "ties")),
    "three": ((8, torch.int32, "ties"), (1, torch.int32, "mixed"),
              (31, torch.int32, "ties")),
    "four": ((2, torch.int32, "random"), (63, torch.int64, "ties"),
             (9, torch.int32, "descending"), (23, torch.int64, "mixed")),
    "pads_only": ((23, torch.int32, "pads"), (48, torch.int64, "pads")),
}
FILL_BIG = (1 << 62) - 1    # the merge's packed-fill sentinel


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# the CPU's brand string (CPUID leaves 0x80000002-4), for hosts whose
# /proc/cpuinfo reports no model name
CPUID_BRAND_SRC = r"""
#include <cpuid.h>
#include <cstdio>
#include <cstring>
int main() {
  unsigned r[12] = {0};
  for (unsigned i = 0; i < 3; ++i)
    if (!__get_cpuid(0x80000002u + i, &r[4 * i], &r[4 * i + 1],
                     &r[4 * i + 2], &r[4 * i + 3])) return 1;
  char s[49];
  std::memcpy(s, r, 48);
  s[48] = 0;
  std::puts(s);
  return 0;
}
"""


def host_cpu(work: pathlib.Path) -> str:
    """The host's CPU model and the logical CPUs this process may use (the
    host merge and the native scan run there): /proc/cpuinfo's model name,
    else the CPUID brand string (a small program built with g++ in
    ``work``), else the family and model numbers."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    field = lambda k: (re.search(rf"^{k}\s*:\s*(.+)$", text, re.M)
                       or [None, "unknown"])[1].strip()
    name = field("model name")
    if name == "unknown":
        work.mkdir(parents=True, exist_ok=True)
        (work / "cpuid.cpp").write_text(CPUID_BRAND_SRC)
        r = subprocess.run(["g++", "-O2", "-o", str(work / "cpuid"),
                            str(work / "cpuid.cpp")], capture_output=True,
                           timeout=120)
        brand = "" if r.returncode else subprocess.run(
            [str(work / "cpuid")], capture_output=True, text=True,
            timeout=60).stdout.strip()
        name = brand or (f"model name unknown (cpu family "
                         f"{field('cpu family')}, model {field('model')})")
    return (f"{name}, {len(os.sched_getaffinity(0))} of {os.cpu_count()} "
            "logical CPUs")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs launched back to
    back between two CUDA events (so the host's launch overhead overlaps
    the device's work wherever the host keeps ahead)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_ms(fn, reps: int) -> float:
    """cuda_ms of a library call after one call to warm it (its
    allocator's blocks, its workspace), as a caller that sorts again
    finds it."""
    fn()
    return cuda_ms(fn, reps)


def _wrap(b: bytes, width: int = 60) -> bytes:
    return b"\n".join(b[i:i + width] for i in range(0, len(b), width))


def write_workload(d: pathlib.Path, seed: int, ref_len: int, n_docs: int,
                   snp: float, doc_len: int | None = None,
                   n_run: int = 0, width: int = 60) -> pathlib.Path:
    """Reference and collection FASTA files plus their input list, made as
    bench.py's make_workload makes them (uniform ACGT reference; each
    document a copy with max(1, ref_len * snp) random substitutions, none
    when snp is 0), so seed 42 at 2 Mbp x 10 docs x 1% is its primary.
    ``n_run`` > 0 overwrites a run of that many N bytes at a random place
    in each document (the dense scan then takes its narrow seed). The
    collection's lines hold ``width`` bytes; 0 writes each document on one
    line (an unwrapped FASTA)."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, size=ref_len)
    (d / "ref.fa").write_bytes(b">ref\n" + _wrap(ref.tobytes()) + b"\n")
    with open(d / "coll.fa", "wb") as f:
        for i in range(n_docs):
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
    lst = d / "input.txt"
    lst.write_text(f"{d / 'ref.fa'}\n{d / 'coll.fa'}\n")
    return lst


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(moved: int) -> float:
    return moved / HBM_BYTES_PER_S * 1e3


def scan_bytes(ix, trees, split, st, cap: int) -> int:
    """Bytes the scan must move: the padded collection, the text, SA, ISA
    and both trees read once, the lane state read and written, and the
    records this run writes (13 bytes each)."""
    lane_state = nbytes(*(st[k] for k in ("t", "length", "lb", "rb", "pos",
                                          "fin", "done", "nrec", "viol")))
    written = int(torch.clamp(st["nrec"], max=cap).to(torch.int64).sum())
    return (nbytes(split.sx_padded, split.ends_dev, ix.x_padded, ix.sa,
                   ix.isa, trees.lcp, trees.g)
            + 2 * lane_state + 13 * written)


def write_short_reference(d: pathlib.Path, seed: int) -> pathlib.Path:
    """A 4-char reference (127 chars once augmented: the block trees have
    no level above their one block) and 40 random 300-char documents."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    (d / "ref.fa").write_bytes(b">ref\nACGT\n")
    (d / "coll.fa").write_bytes(b"".join(
        b">doc%d\n" % i + _wrap(rng.choice(acgt, 300).tobytes()) + b"\n"
        for i in range(40)))
    lst = d / "input.txt"
    lst.write_text(f"{d / 'ref.fa'}\n{d / 'coll.fa'}\n")
    return lst


def kernel_case(name, lst, lanes=4096, cap=None, expect_viol=None,
                window=64, reps=5, sweep=()):
    """CUDA kernel (block trees) vs plain version (sparse tables) on one
    input list, at the lane split and capacity that ms_jump_heads launches
    (or ``cap`` record slots per lane); then the kernel alone at each lane
    count of ``sweep``. Returns a result dict."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index.device import build_device_index
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    x_aug, coll = load_inputs(str(lst))
    ix = build_device_index(x_aug, "cuda")
    n, sn = ix.n, coll.sn
    gmax = mj.build_gmax_table(ix.plcp, n)
    trees = mj.build_block_trees(ix.lcp, ix.plcp, n)
    split = mj.split_lanes(coll.sx, lanes, window, "cuda")
    cap = split.cap if cap is None else cap
    head = (ix.x_padded, ix.sa, ix.isa)
    kw = dict(n=n, sn=sn, cap=cap, window=window)
    fresh = lambda: split.init_state(n, cap)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_st = mj.ms_jump_scan_reference(*head, ix.jump, gmax,
                                       split.sx_padded, fresh(),
                                       split.ends_dev, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cu_st = kernels.ms_jump_scan_cuda(*head, trees, split.sx_padded, fresh(),
                                      split.ends_dev, **kw)
    torch.cuda.synchronize()
    err = 0
    for k in mj.STATE_FIELDS:
        a, b = ref_st[k], cu_st[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"kernel case {name}: field {k} shape/dtype differs")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()) if a.numel() else 0)

    def timed(sp, c):
        it = iter([sp.init_state(n, c) for _ in range(reps)])
        return cuda_ms(lambda: kernels.ms_jump_scan_cuda(
            *head, trees, sp.sx_padded, next(it), sp.ends_dev, n=n, sn=sn,
            cap=c, window=window), reps)
    ms = timed(split, cap)
    bound = bound_ms(scan_bytes(ix, trees, split, ref_st, cap))
    viol = bool(ref_st["viol"].any())
    log(f"kernel[{name}]: n={n} sn={sn} lanes={split.lanes} cap={cap} "
        f"tree_levels={len(trees.offsets)} "
        f"records={int(ref_st['nrec'].sum())} viol={viol} "
        f"max_abs_err={err} (tolerance {TOL}) cuda_ms={ms:.3f} "
        f"plain_ms={plain_ms:.1f} bound_ms={bound:.4f}")
    if err > TOL:
        fail(f"kernel case {name}: CUDA ms_jump_scan disagrees with "
             "ms_jump_scan_reference")
    if expect_viol is not None and viol != expect_viol:
        fail(f"kernel case {name}: viol={viol}, expected {expect_viol}")
    for more in sweep:
        sp = mj.split_lanes(coll.sx, more, window, "cuda")
        warm = kernels.ms_jump_scan_cuda(
            *head, trees, sp.sx_padded, sp.init_state(n), sp.ends_dev, n=n,
            sn=sn, cap=sp.cap, window=window)
        log(f"kernel[{name}]: lanes={sp.lanes} cap={sp.cap} "
            f"viol={bool(warm['viol'].any())} "
            f"cuda_ms={timed(sp, sp.cap):.3f}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)


def pow2_pad(rho: int, m: int) -> int:
    """The rows the dense scan lifted before it cut the lift to the rho
    irreducible rows: rho rounded up to a power of two (at least 16), at
    most m (the JAX package's compile bucket)."""
    return min(1 << max(4, (max(rho, 1) - 1).bit_length()), m)


def compare(kernel, name, plain, cuda_fn, plain_fn, what, moved, reps=5,
            plain_reps=2):
    """A kernel's outputs against its plain version's on the card (exact),
    then both timed; returns a result dict. ``moved`` is the bytes of the
    bound, or a function of the plain version's outputs giving them.
    ``plain_reps`` 0 times the plain version's one call that gave the
    outputs (for a plain version that takes seconds)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = plain_fn()
    end.record()
    got = cuda_fn()
    torch.cuda.synchronize()
    if any(a.dtype != b.dtype or a.shape != b.shape
           for a, b in zip(want, got)):
        fail(f"{kernel}[{name}]: dtype or shape differs from {plain}")
    err = max((int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0) for a, b in zip(want, got))
    ms = cuda_ms(cuda_fn, reps)
    plain_ms = cuda_ms(plain_fn, plain_reps) if plain_reps else \
        start.elapsed_time(end)
    bound = bound_ms(moved(want) if callable(moved) else moved)
    log(f"kernel {kernel}[{name}]: {what} max_abs_err={err} "
        f"(tolerance {TOL}) cuda_ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bound:.4f}")
    if err > TOL:
        fail(f"{kernel}[{name}]: CUDA kernel disagrees with {plain}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                outputs=want)


def alone_ms(launch, scratch_bytes: int, reps: int = 5) -> float:
    """Mean device time of a kernel's launch alone: ``launch(scratch)``
    ``reps`` times back to back between two CUDA events, each launch
    given its own zeroed scratch made beforehand, so the wrapper's
    allocations and memsets fall outside the events."""
    scratch = [torch.zeros(max(scratch_bytes, 16), dtype=torch.uint8,
                           device="cuda") for _ in range(reps + 1)]
    launch(scratch.pop())   # warm
    it = iter(scratch)
    return cuda_ms(lambda: launch(next(it)), reps)


def copy_ms(nbytes_moved: int, reps: int = 5) -> float:
    """Tensor.copy_ moving ``nbytes_moved`` bytes (half read, half
    written): the rate a single pass over the same bytes can hope for."""
    half = max(nbytes_moved // 2, 1)
    src = torch.empty(half, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return cuda_ms(lambda: dst.copy_(src), reps)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def fill_launch(K, v, op: str, rev: bool):
    """running_fill's C entry point on ``v`` with its output made
    beforehand (``K``: this tree's kernels module or an older checkout's,
    whose C interface is the same); returns (launch(scratch), scratch
    bytes)."""
    lib = K.load()["running_fill"]
    out = torch.empty_like(v)
    m, elem = v.numel(), v.element_size()

    def launch(scratch):
        if lib.running_fill_launch(_p(v), _p(out), m, elem, int(op == "min"),
                                   int(rev), _p(scratch), _stream()):
            fail("running_fill launch failed")
    return launch, int(lib.running_fill_scratch_bytes(m, elem))


def bucket_sums_launch(K, br, bid, m_c, nec: int, n_pad: int):
    """bucket_sums' C entry point on these lanes with its outputs made
    (and zeroed: an older kernel writes only the nonzero slots)
    beforehand; returns (launch(scratch), scratch bytes)."""
    lib = K.load()["run_merge"]
    h_pad = br.numel()
    outs = [torch.zeros(k, dtype=torch.int32, device="cuda")
            for k in (n_pad, n_pad, h_pad)]

    def launch(scratch):
        if lib.bucket_sums_launch(_p(br), _p(bid), _p(m_c), nec, h_pad,
                                  n_pad, *map(_p, outs), _p(scratch),
                                  _stream()):
            fail("bucket_sums launch failed")
    return launch, int(lib.bucket_sums_scratch_bytes(nec))


def dense_rank_launch(K, args, kw):
    """dense_rank's C entry point (sa_round.cu) on one step's arguments
    (index/device.dense_rank's, as MergeCapture keeps them) with its
    outputs and stagings made beforehand; returns (launch(scratch),
    scratch bytes)."""
    from cmsbwt_tpu_torch.ops.sort import fault_word
    lib = K.load()["sa_round"]
    order, s0, key1 = args[:3]
    n = order.numel()
    shift = K.sa_round_bins(n).shift
    m4 = (n + 3) & ~3
    rank = torch.empty(n, dtype=torch.int32, device="cuda")
    st, st2 = (torch.empty(2 * m4, dtype=torch.int32, device="cuda")
               for _ in range(2))
    sl = kw.get("slice_")
    ti, k0, k1 = sl if sl is not None else (None, None, None)
    ptr = lambda t: None if t is None else _p(t)
    nxt = None if kw.get("nxt") is None else torch.empty_like(kw["nxt"])

    def launch(scratch):
        if lib.dense_rank_launch(
                int(sl is not None), _p(order), _p(s0), ptr(key1), _p(rank),
                ptr(nxt), int(kw.get("shift", 0)), ptr(ti), ptr(k0), ptr(k1),
                0 if sl is None else ti.numel(),
                _p(st), _p(st2), n, shift, _p(scratch),
                _p(fault_word(order.device)), _stream()):
            fail("dense_rank launch failed")
    return launch, int(lib.sa_round_scratch_bytes(n, n, shift))


def dense_rank_comp_launch(K, args, reps: int):
    """dense_rank_comp's C entry point (sa_round.cu:
    dense_rank_comp_launch, or dense_rank_comp_tail_launch for a tail) on
    one compacted call's arguments (as CompCapture keeps them; no large
    groups) with its outputs made beforehand and a copy of key 1 and of
    the rank for each of ``reps`` + 1 launches (a round overwrites key 1
    with the next round's, and the tail's rounds read the ranks they
    write); returns (launch(scratch), scratch bytes)."""
    from cmsbwt_tpu_torch.ops.sort import fault_word
    lib = K.load()["sa_round"]
    (ti, k0, k1), u, large, rank, sa, (ti_n, k0_n), shift, rounds = args
    if large:
        fail("dense_rank_comp_launch: a step with large groups is timed "
             "with its wrapper only")
    sa, ti_n, k0_n = (t.clone() for t in (sa, ti_n, k0_n))
    m = rank.numel()
    k1s = iter([k1.clone() for _ in range(reps + 1)])
    ranks = iter([rank.clone() for _ in range(reps + 1)])
    fault = fault_word(rank.device)

    def launch(scratch):
        if rounds:
            err = lib.dense_rank_comp_tail_launch(
                _p(ti), _p(k0), _p(next(ranks)), _p(sa), m, _p(ti_n),
                _p(k0_n), ti_n.numel(), u, int(shift), int(rounds),
                _p(scratch), _p(fault), _stream())
        else:
            err = lib.dense_rank_comp_launch(
                _p(ti), _p(k0), _p(next(k1s)), _p(next(ranks)), _p(sa), m,
                _p(ti_n), _p(k0_n), ti_n.numel(), u, 0, *[None] * 7,
                int(shift), _p(scratch), _p(fault), _stream())
        if err:
            fail("dense_rank_comp launch failed")
    return launch, int(lib.dense_rank_comp_scratch_bytes(m))


def pair_expand_launch(K, args: tuple):
    """pair_expand's C entry point on kernels.pair_expand_cuda's
    arguments with its outputs made beforehand; returns (launch(scratch),
    scratch bytes: none are read)."""
    lib = K.load()["pair_expand"]
    *arrays, nc, total, n, p_pad = args
    h_pad = arrays[0].numel()
    J = h_pad + p_pad
    outs = [torch.empty(J, dtype=dt, device="cuda") for dt in (
        torch.int32, torch.int64, torch.int32, torch.int32)]
    outs.append(torch.empty(p_pad, dtype=torch.int32, device="cuda"))

    def launch(scratch):
        if lib.pair_expand_launch(*map(_p, arrays), h_pad, nc, total, p_pad,
                                  n, *map(_p, outs), _stream()):
            fail("pair_expand launch failed")
    return launch, 16


def fill_times(K, tag: str, r: dict, v, op: str, rev: bool,
               lib_reps: int = 2) -> dict:
    """Beside a running_fill result ``r`` (compare: the wrapper's time):
    the kernel alone, Tensor.copy_ of the same bytes (m rows in, m rows
    out) and the library call, one 1-D torch.cummax (op "max") or
    torch.cummin ("min") of ``v`` (``lib_reps`` calls); the library scans
    forward only, so a reverse fill is timed against the forward call of
    its op."""
    cum = torch.cummax if op == "max" else torch.cummin
    r["alone_ms"] = alone_ms(*fill_launch(K, v, op, rev))
    r["copy_ms"] = copy_ms(2 * nbytes(v))
    r["library_ms"] = cuda_ms(lambda: cum(v, 0), lib_reps)
    log(f"kernel running_fill[{tag}]: alone {r['alone_ms']:.3f} ms, as the "
        f"wrapper runs it {r['ms']:.3f} ms, copy_ of the same bytes "
        f"{r['copy_ms']:.3f} ms, 1-D torch.{cum.__name__} "
        f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
    return r


def dense_inputs(x_aug: np.ndarray, sx: np.ndarray, sep_base: int = 0,
                 pad: int | None = None) -> dict:
    """The dense scan's stages up to the lift on the card, as the main
    path runs them on one joint string: the whole collection ``sx``
    (ms_dense_heads_on_device), or one block's window of it with that
    block's separator base and collection pad ``pad`` (ms_dense.
    _scan_block). Returns the joint sort's outputs, the sorted pair rows
    (ai, bi, lv over all m slots), rho, lmax, rho_pad and the split-level
    histogram of the irreducible rows."""
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    n, sn = len(x_aug), len(sx)
    n_pad, sn_pad, _ = md.joint_geometry(n, sx)
    sn_pad = sn_pad if pad is None else pad
    m = n_pad + sn_pad
    x_u8 = md.upload_bytes(x_aug, n_pad, "cuda")
    sx_u8 = md.upload_bytes(sx, sn_pad, "cuda")
    wide = md.wide_seed_ok(x_u8[:n], sx_u8[:sn], m)
    b, sp = md._build_joint_core(x_u8, sx_u8, n, sn, sep_base, n_pad, sn_pad)
    del x_u8, sx_u8
    sa, isa, hist, packs, _, split_lv = js.joint_suffix_array(b, sp, m, wide)
    stats, ai, bi, lv = md._irreducible_slots(b, sp, sa, isa, split_lv, n,
                                              sn, m, n_pad)
    del b, sp, split_lv
    rho, lmax = md._lift_rows(stats)
    return dict(sa=sa, isa=isa, hist=hist, packs=packs, ai=ai, bi=bi, lv=lv,
                n=n, m=m, wide=wide, rho=rho, lmax=lmax,
                rho_pad=pow2_pad(rho, m),
                levels={k: c for k, c in enumerate(stats[1:].tolist())
                        if c})


def dense_kernel_case(name, x_aug, sx, sep_base=0, pad=None, rho_pad=True,
                      reps=5):
    """The CUDA lcp_lift and dense_neighbors against lift_pairs and
    neighbors_reference on the card, fed the port's own dense stages on
    one joint string (dense_inputs: the whole collection, or one block).
    The lift runs on the rho irreducible rows with lmax from the stats
    (the main path's call), and with ``rho_pad`` also on the rho_pad rows
    of the earlier call (lmax read back by the wrapper). Returns {kernel:
    result dict}; "lcp_lift" is the main path's call."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    d = dense_inputs(x_aug, sx, sep_base, pad)
    sa, isa, hist, packs, ai_all, bi_all, lv_all = (
        d[k] for k in ("sa", "isa", "hist", "packs", "ai", "bi", "lv"))
    n, m, wide, rho, lmax, rows_pad = (
        d[k] for k in ("n", "m", "wide", "rho", "lmax", "rho_pad"))
    seed = "wide" if wide else "narrow"
    log(f"lift rows[{name}]: m={m} seed={seed} rho={rho} "
        f"rho_pad={rows_pad} lmax={lmax} hist_levels={hist.shape[0]} "
        f"irreducible rows by split level {d['levels']}")
    del d
    out = {}

    def lift(rows, tag, **kw):
        ai, bi, lv = ai_all[:rows], bi_all[:rows], lv_all[:rows]
        return compare(
            "lcp_lift", f"{name},{tag}", "lift_pairs",
            lambda: (kernels.lcp_lift_cuda(hist, packs, ai, bi, lv, m,
                                           **kw),),
            lambda: (js.lift_pairs(hist, packs, ai, bi, lv, m),),
            f"m={m} seed={seed} rows={rows}",
            lift_bytes(packs, ai, bi, lv, m), reps)

    out["lcp_lift"] = lift(rho, "rho rows", lmax=lmax)
    if rho_pad:
        out["lcp_lift_rho_pad"] = lift(rows_pad, "rho_pad rows")
    h = out["lcp_lift"].pop("outputs")[0]
    ai = ai_all[:rho]
    ell = md._fill_ell(h, ai, isa, m)
    del hist, packs, ai_all, bi_all, lv_all, isa, h, ai
    torch.cuda.empty_cache()
    out["dense_neighbors"] = compare(
        "dense_neighbors", name, "neighbors_reference",
        lambda: kernels.dense_neighbors_cuda(sa, ell, n, m),
        lambda: md.neighbors_reference(sa, ell, n, m),
        f"m={m} ref_slots={n}", 24 * m, reps)   # sa, ell in; 4 rows out
    for r in out.values():
        r.pop("outputs", None)
    return out


def block_kernel_case(name, x_aug, sx, block: dict) -> dict:
    """dense_kernel_case on one block try of a blocked run, as BlockLog
    recorded it (its window, separator base and pad)."""
    return dense_kernel_case(
        f"{name}, block@{block['b0']} m={block['m']}", x_aug,
        sx[block["b0"]:block["end"]], block["sep_base"], block["bs_pad"],
        rho_pad=False)


NB_TILE = 4096        # dense_neighbors.cu: TILE
NB_CHUNK = 4096       # dense_neighbors.cu: CHUNK (tiles per carry block)


def neighbor_inputs(m: int, seed: int, ref_share: float, dead=None):
    """Synthetic sa/ell rows on the card: a share ``ref_share`` of
    reference slots (sa < n = 1000), none in the tiles [dead[0],
    dead[1])."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1000
    is_ref = torch.rand(m, generator=g, device="cuda") < ref_share
    if dead is not None:
        is_ref[dead[0] * NB_TILE:dead[1] * NB_TILE] = False
    sa = torch.where(is_ref,
                     torch.randint(0, n, (m,), generator=g, device="cuda"),
                     torch.randint(n, 4 * n, (m,), generator=g,
                                   device="cuda")).to(torch.int32)
    ell = torch.randint(0, 50, (m,), generator=g, device="cuda",
                        dtype=torch.int32)
    return sa, ell, n


# (m, share of reference slots, tiles with no reference slot); the sizes
# of tests/test_torch_dense_neighbors_tiles.py, then three carry chunks
NEIGHBOR_CASES = {
    "m1": (1, 0.5, None), "m31": (31, 0.2, None), "m32": (32, 0.2, None),
    "m33": (33, 0.2, None), "tile-1": (NB_TILE - 1, 0.05, None),
    "tile": (NB_TILE, 0.05, None), "tile+1": (NB_TILE + 1, 0.05, None),
    "3tiles-1": (3 * NB_TILE - 1, 0.01, None),
    "3tiles+1": (3 * NB_TILE + 1, 0.01, None),
    "dead_tiles": (6 * NB_TILE + 5, 0.01, (1, 5)),
    "all_ref": (2 * NB_TILE + 7, 1.0, None),
    "no_ref": (2 * NB_TILE + 7, 0.0, None),
    "three_carry_chunks": ((2 * NB_CHUNK + 3) * NB_TILE + 1, 1e-6,
                           (NB_CHUNK - 40, NB_CHUNK + 2)),
}


def neighbor_cases() -> list:
    """dense_neighbors against neighbors_reference on synthetic rows at
    the edge sizes of its tiles, warps and carry chunks (exact)."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops import ms_dense as md
    res = []
    for i, (case, (m, share, dead)) in enumerate(NEIGHBOR_CASES.items()):
        sa, ell, n = neighbor_inputs(m, 100 + i, share, dead)
        if case == "no_ref":
            n = 0
        res.append(compare(
            "dense_neighbors", case, "neighbors_reference",
            lambda: kernels.dense_neighbors_cuda(sa, ell, n, m),
            lambda: md.neighbors_reference(sa, ell, n, m),
            f"m={m} ref_share={share} dead_tiles={dead}", 24 * m, 2))
        res[-1].pop("outputs")
    return res


def lift_bytes(packs, ai, bi, lv, m: int) -> int:
    """Bytes lcp_lift must move: ai, bi, lv read and h written per row;
    per valid row, two 4-byte history entries per lifting level it runs
    (from its own level lv - 2, or the shared top for lv below the seed
    level, down to the seed level) and two seed packs."""
    from cmsbwt_tpu_torch.ops.joint_sa import seed_level_of
    sl = seed_level_of(packs)
    valid = (ai < m) & (bi < m)
    lmax = int(torch.where(valid, lv, 0).max()) if ai.numel() else 0
    top = torch.where(lv >= sl, lv - 2, lmax - 2)
    levels = torch.clamp(top - sl + 1, min=0)
    gathers = int(torch.where(valid, 8 * levels + 16, 0).to(torch.int64)
                  .sum())
    return 16 * int(ai.numel()) + gathers


def reference_outputs(lst: pathlib.Path, tag: str = "ref") -> dict:
    """.bwt and .rl_bwt bytes of the C++ reference tool on ``lst``."""
    if not REF_BIN.exists():
        fail(f"reference tool {REF_BIN.relative_to(ROOT)} is missing")
    out = {}
    for rle in (False, True):
        base = WORK / (tag + ("_rle" if rle else ""))
        t0 = time.perf_counter()
        r = subprocess.run([str(REF_BIN)] + (["-r"] if rle else [])
                           + ["-o", str(base), str(lst)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"reference tool exited {r.returncode}: {r.stderr[-2000:]}")
        out[rle] = base.with_suffix(".rl_bwt" if rle else ".bwt").read_bytes()
        log(f"oracle[{'rle' if rle else 'plain'}]: reference tool "
            f"{time.perf_counter() - t0:.2f} s, {len(out[rle])} bytes")
    return out


def native_heads(x_aug: np.ndarray, coll) -> tuple:
    """Head records (t, pos, len, smaller, char) of the native C++
    PLCP-skip scan, run on the port's reference index."""
    from cmsbwt_tpu_torch.index.device import build_device_index
    so = WORK / "libcmsbwt_scan.so"
    r = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-fopenmp",
                        str(NATIVE_SCAN), "-o", str(so)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"g++ could not build the native scan: {r.stderr[-2000:]}")
    lib = ctypes.CDLL(str(so))
    U8P, I32P, I64P = (ctypes.POINTER(c) for c in
                       (ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64))
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.cms_ms_scan.restype = i64
    lib.cms_ms_scan.argtypes = [U8P, I32P, I32P, I32P, I32P, i32, U8P, i64,
                                I64P, i32, i64, I64P, I64P, I64P, U8P, i32]
    ix = build_device_index(x_aug, "cuda")
    xp, sa, isa, lcp, plcp = (getattr(ix, k).contiguous().cpu().numpy()
                              for k in ("x_padded", "sa", "isa", "lcp",
                                        "plcp"))
    sx = np.ascontiguousarray(coll.sx, np.uint8)
    seps = np.ascontiguousarray(coll.sep_positions, np.int64)
    sn = len(sx)
    cap = max(1024, sn // 8)
    while True:
        t, pos, ln = (np.empty(cap, np.int64) for _ in range(3))
        sml = np.empty(cap, np.uint8)
        h = lib.cms_ms_scan(
            xp.ctypes.data_as(U8P), sa.ctypes.data_as(I32P),
            isa.ctypes.data_as(I32P), lcp.ctypes.data_as(I32P),
            plcp.ctypes.data_as(I32P), ix.n, sx.ctypes.data_as(U8P), sn,
            seps.ctypes.data_as(I64P), len(seps), cap,
            t.ctypes.data_as(I64P), pos.ctypes.data_as(I64P),
            ln.ctypes.data_as(I64P), sml.ctypes.data_as(U8P), 0)
        if h >= 0:
            break
        cap = int(-h) + 16
    t, pos, ln, sml = t[:h], pos[:h], ln[:h], sml[:h] != 0
    return t, pos, ln, sml, sx[(t - 1) % max(sn, 1)]


def fill_input(m: int, dtype, seed: int, trend: int) -> torch.Tensor:
    """m values on the card: a ramp of slope ``trend`` plus noise (so a
    running max or min changes often in one direction and rarely in the
    other), with the dtype's extremes and the merge's sentinels (INT_MAX,
    FILL_BIG in int64, -1) at a few rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    info = torch.iinfo(dtype)
    v = torch.arange(m, dtype=torch.int64, device="cuda") * trend
    v += torch.randint(-(1 << 20), 1 << 20, (m,), generator=g,
                       device="cuda")
    special = [info.min, info.max, -1, 2**31 - 1] + (
        [FILL_BIG] if dtype == torch.int64 else [])
    at = torch.randint(0, m, (len(special),), generator=g, device="cuda")
    v[at] = torch.tensor(special, dtype=torch.int64, device="cuda")
    return v.to(dtype)


def row_blocked_fill(v, op: str, reverse: bool, width: int = 4096):
    """The row-blocked running max / min the port used before running_fill
    (rows of ``width`` scanned by torch, then a carry across the rows; flips
    for reverse), timed beside the kernel."""
    if reverse:
        return torch.flip(row_blocked_fill(torch.flip(v, [0]), op, False,
                                           width), [0])
    m = v.shape[0]
    cum = torch.cummax if op == "max" else torch.cummin
    rows = -(-m // width)
    info = torch.iinfo(v.dtype)
    x = torch.full((rows * width,), info.min if op == "max" else info.max,
                   dtype=v.dtype, device=v.device)
    x[:m] = v
    loc = cum(x.view(rows, width), 1).values
    carry = cum(loc[:, -1], 0).values
    both = torch.maximum if op == "max" else torch.minimum
    loc[1:] = both(loc[1:], carry[:-1, None])
    return loc.reshape(-1)[:m]


def fill_cases() -> list:
    """running_fill against its plain version (exact) on the card: every
    size of FILL_SIZES (its tiles' edges) in int32 and int64, max and min,
    forward and reverse, on a rising and a falling ramp, and on the view
    v[1:] of one row more (its rows start 4 or 8 bytes past a 16-byte
    boundary: element loads at the head and element stores throughout);
    then int64 at BIG_FILL rows, forward max and reverse min, each timed
    alone and as the wrapper runs it, beside Tensor.copy_ of the same
    bytes, the library call (one 1-D torch.cummax / torch.cummin) and the
    row-blocked form. Returns the two timed results."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.kernels import running_fill_cuda
    from cmsbwt_tpu_torch.ops.fill import running_fill_reference
    cases = 0
    for dt, sizes in FILL_SIZES.items():
        for m in sizes:
            for op in ("max", "min"):
                for rev in (False, True):
                    for trend in (3, -3):
                        for view in (False, True):
                            v = fill_input(m + view, dt, m + cases, trend)
                            v = v[1:] if view else v
                            got = running_fill_cuda(v, op, rev)
                            want = running_fill_reference(v, op, rev)
                            if not torch.equal(got, want):
                                fail(f"running_fill[m={m}, {dt}, {op}, "
                                     f"reverse={rev}, view={view}] differs "
                                     "from its plain version")
                            cases += 1
    log(f"kernel running_fill: {cases} cases (m in {FILL_SIZES}, int32 and "
        "int64, max and min, forward and reverse, rising and falling, whole "
        f"and v[1:]) exact (tolerance {TOL})")
    out = []
    for op, rev, trend in (("max", False, 5), ("min", True, 5)):
        v = fill_input(BIG_FILL, torch.int64, 9, trend)
        name = f"int64_{BIG_FILL}_{op}{'_reverse' if rev else ''}"
        r = compare("running_fill", name, "running_fill_reference",
                    lambda: (running_fill_cuda(v, op, rev),),
                    lambda: (running_fill_reference(v, op, rev),),
                    f"m={BIG_FILL} int64 {op}{' reverse' if rev else ''}",
                    2 * nbytes(v))
        fill_times(kernels, name, r, v, op, rev)
        if not torch.equal(row_blocked_fill(v, op, rev), r["outputs"][0]):
            fail(f"running_fill[{name}]: the row-blocked form differs")
        r["row_blocked_ms"] = cuda_ms(lambda: row_blocked_fill(v, op, rev),
                                      2)
        log(f"kernel running_fill[{name}]: row-blocked form "
            f"{r['row_blocked_ms']:.3f} ms, kernel {r['ms']:.3f}")
        del r["outputs"], v
        out.append(r)
        torch.cuda.empty_cache()
    return out


def call_site(frame) -> str:
    """A call site by its file (under the package) and line."""
    path = pathlib.Path(frame.f_code.co_filename)
    return f"{'/'.join(path.parts[-2:])}:{frame.f_lineno}"


class SortCapture:
    """Keeps the keys of the ops/sort.stable_argsort calls made while in
    use by the device merge (engine/device_merge.py), the reference
    index's doubling (index/device.py) and the jump scan's candidate
    compaction (ops/ms_jump.py): one case per call site, named by the
    caller's file (under the package) and line, from the first call
    there, its keys cloned (a caller may reuse them). ``sites`` maps each
    site to (keys, widths, values flag), in call order."""

    MODULES = ("engine.device_merge", "index.device", "ops.ms_jump")

    def __enter__(self):
        import importlib
        self.mods = [importlib.import_module(f"cmsbwt_tpu_torch.{m}")
                     for m in self.MODULES]
        self.orig = [m.stable_argsort for m in self.mods]
        self.sites = {}
        for mod, fn in zip(self.mods, self.orig):
            mod.stable_argsort = self._wrap(fn)
        return self

    def _wrap(self, fn):
        def argsort(keys, bits, values=False):
            keys = tuple(keys)
            site = call_site(sys._getframe(1))
            if site not in self.sites:
                self.sites[site] = (tuple(k.clone() for k in keys),
                                    tuple(int(b) for b in bits), values)
            return fn(keys, bits, values)
        return argsort

    def __exit__(self, *exc):
        for mod, fn in zip(self.mods, self.orig):
            mod.stable_argsort = fn


class MergeCapture:
    """Keeps the inputs of the device merge's kernels from the merges run
    while in use, by wrapping engine/device_merge's running_fill,
    tail_good_join, exact_credit, bucket_sums, run_merge, compact and
    pair_expand and index/device's dense_rank and comp_rank: every
    running_fill input with its op and direction (``fills``, in call
    order; ``fill`` the largest), the last inputs of the next four and of
    pair_expand (``expand``: the classes' and pairs' arrays it reads), the
    largest compaction's (flag, count), the head string's suffix sort's
    first full rank step (``rank``: the dispatch's arguments and keywords
    but its scratch, cloned: later rounds reuse the buffers), its first
    compacted round and its first tail call (``comp``, ``tail``, as
    CompCapture keeps them), and every sort's keys by call site
    (``sorts``, a SortCapture)."""

    EXPAND_CLS = ("n_classes", "pos", "length", "key_k", "isa_next", "size",
                  "smaller")
    EXPAND_PAIRS = ("pair_cnt", "pair_lo", "bucket_pos", "total")

    def __enter__(self):
        from cmsbwt_tpu_torch.engine import device_merge as dm
        from cmsbwt_tpu_torch.index import device as idx
        self.dm, self.fill, self.join, self.runs = dm, None, None, None
        self.exact = self.sums = self.compact = None
        self.expand = self.rank = self.comp = self.tail = None
        self.idx, self.orig_rank = idx, idx.dense_rank
        self.orig_comp = (idx.comp_rank, idx.comp_tail)
        self.orig_expand = dm.pair_expand

        def expand(cls, pairs, slot_base, n, h_pad, p_pad):
            self.expand = ({k: cls[k] for k in self.EXPAND_CLS},
                           {k: pairs[k] for k in self.EXPAND_PAIRS},
                           slot_base, n, h_pad, p_pad)
            return self.orig_expand(cls, pairs, slot_base, n, h_pad, p_pad)

        def rank(order, s0, key1=None, out=None, **kw):
            if self.rank is None and kw.get("slice_") is not None:
                self.rank = rank_step_clone(order, s0, key1, out, kw)
            return self.orig_rank(order, s0, key1, out, **kw)

        def comp(slice_, u, large, rank, sa, nxt_slice, shift, work=None):
            if self.comp is None:
                self.comp = comp_clone(slice_, u, large, rank, sa,
                                       nxt_slice, shift, 0)
            return self.orig_comp[0](slice_, u, large, rank, sa, nxt_slice,
                                     shift, work)

        def tail(slice_, u, rank, sa, nxt_slice, shift, rounds, work=None):
            if self.tail is None:
                self.tail = comp_clone(slice_, u, 0, rank, sa, nxt_slice,
                                       shift, rounds)
            return self.orig_comp[1](slice_, u, rank, sa, nxt_slice, shift,
                                     rounds, work)
        dm.pair_expand, idx.dense_rank = expand, rank
        idx.comp_rank, idx.comp_tail = comp, tail
        self.fills = []
        self.orig = (dm.running_fill, dm.tail_good_join, dm.run_merge,
                     dm.exact_credit, dm.bucket_sums, dm.compact)

        def fill(v, op="max", reverse=False):
            self.fills.append((v, op, reverse))
            if self.fill is None or v.numel() > self.fill[0].numel():
                self.fill = (v, op, reverse)
            return self.orig[0](v, op, reverse)

        def join(*a):
            self.join = a
            return self.orig[1](*a)

        def runs(*a):
            self.runs = a
            self.run_out = self.orig[2](*a)
            return self.run_out

        def exact(*a):
            self.exact = a
            return self.orig[3](*a)

        def sums(*a):
            self.sums = a
            return self.orig[4](*a)

        def compact(flag, count):
            if self.compact is None or \
                    flag.numel() > self.compact[0].numel():
                self.compact = (flag, count)
            return self.orig[5](flag, count)
        (dm.running_fill, dm.tail_good_join, dm.run_merge, dm.exact_credit,
         dm.bucket_sums, dm.compact) = (fill, join, runs, exact, sums,
                                        compact)
        self.sorts = SortCapture().__enter__()
        return self

    def __exit__(self, *exc):
        self.sorts.__exit__(*exc)
        (self.dm.running_fill, self.dm.tail_good_join, self.dm.run_merge,
         self.dm.exact_credit, self.dm.bucket_sums, self.dm.compact) = \
            self.orig
        self.dm.pair_expand = self.orig_expand
        self.idx.dense_rank = self.orig_rank
        self.idx.comp_rank, self.idx.comp_tail = self.orig_comp


def clone(v):
    """A tensor, or a tuple's tensors, cloned; anything else as it is."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    return tuple(map(clone, v)) if isinstance(v, tuple) else v


def comp_clone(slice_, u, large, rank, sa, nxt_slice, shift, rounds):
    """One compacted call's arguments (index/device.comp_rank's, or
    comp_tail's with its ``rounds``; its scratch left out), the slice's
    first u rows and the rest cloned (later rounds reuse the buffers):
    (slice, u, large, rank, sa, next slice, shift, rounds)."""
    return (tuple(v[:u].clone() for v in slice_), u, large, rank.clone(),
            sa.clone(), clone(tuple(nxt_slice)), shift, rounds)


def rank_step_clone(order, s0, key1, out, kw):
    """One full rank step's arguments and keywords but its scratch,
    cloned (later rounds reuse the buffers)."""
    return ([clone(v) for v in (order, s0, key1, out)],
            {k: clone(v) for k, v in kw.items() if k != "work"})


class IndexRankCapture:
    """Keeps the reference index's first two-key full rank step
    (index/device.dense_rank with the rank history: dense ranks and the
    next key; round 0, shift 2) while in use (``step``, as
    rank_step_clone keeps it)."""

    def __enter__(self):
        from cmsbwt_tpu_torch.index import device as idx
        self.idx, self.orig, self.step = idx, idx.dense_rank, None

        def rank(order, s0, key1=None, out=None, **kw):
            if self.step is None and key1 is not None and \
                    kw.get("slice_") is None:
                self.step = rank_step_clone(order, s0, key1, out, kw)
            return self.orig(order, s0, key1, out, **kw)
        idx.dense_rank = rank
        return self

    def __exit__(self, *exc):
        self.idx.dense_rank = self.orig


def sa_round_bytes(perm, keys, lv, comp) -> int:
    """Bytes sa_round must move: perm, the keys and lv read once and the
    three text-order rows and lv written once; a compacted round also
    reads ti, rank and resolved and writes its carried slice."""
    R, m = perm.numel(), lv.numel()
    moved = nbytes(perm, *keys) + 2 * nbytes(lv) + 9 * m
    if comp is not None:
        moved += nbytes(*comp) + 9 * R
    return moved


def sa_round_case(tag: str, perm, keys, lv, k: int, comp) -> dict:
    """sa_round against _round_ranks_reference (exact) on one round's
    inputs, both timed."""
    from cmsbwt_tpu_torch import kernels as K_
    from cmsbwt_tpu_torch.ops import joint_sa as js

    def flat(res):
        mid, full, resolved, lv_out, u, carry = res
        return (mid, full, resolved, lv_out, u) + tuple(carry or ())
    # a tuple: the wrapper empties a list of keys once it has packed it
    keys = tuple(keys)
    kind = "full" if comp is None else "comp"
    r = compare("sa_round", f"{tag} {kind} k={k}", "_round_ranks_reference",
                lambda: flat(K_.sa_round_cuda(perm, keys, lv, k, comp)),
                lambda: flat(js._round_ranks_reference(perm, keys, lv, k,
                                                        comp)),
                f"{kind} round k={k}: R={perm.numel()} rows, m={lv.numel()}",
                sa_round_bytes(perm, keys, lv, comp),
                plain_reps=0 if perm.numel() > 1 << 26 else 2)
    r.pop("outputs")
    r.update(kind=kind, k=k, rows=perm.numel(), m=lv.numel())
    return r


def seed_bytes(order, rows) -> int:
    """Bytes sa_round's seed mode must move: the order and the seed's key
    rows read once, the split levels, the rank and the flags written
    once."""
    return nbytes(order, *rows) + 9 * order.numel()


def seed_case(tag: str, order, rows, sl: int) -> dict:
    """sa_round's seed mode against _seed_ranks_reference (exact) on the
    seed's inputs, both timed."""
    from cmsbwt_tpu_torch import kernels as K_
    from cmsbwt_tpu_torch.ops import joint_sa as js
    rows = tuple(rows)   # the wrapper empties a list once it has packed it
    seed = "narrow" if len(rows) == 2 else "wide"
    r = compare("sa_round", f"{tag} seed ({seed})", "_seed_ranks_reference",
                lambda: K_.sa_round_seed_cuda(order, rows, sl),
                lambda: js._seed_ranks_reference(order, rows, sl),
                f"the {seed} seed's rank step: m={order.numel()}",
                seed_bytes(order, rows),
                plain_reps=0 if order.numel() > 1 << 26 else 2)
    r.pop("outputs")
    r.update(kind="seed", seed=seed, rows=order.numel(), m=order.numel())
    return r


class JointTimers:
    """While in use, holds the joint suffix sort's kernels to their plain
    versions and times them on the live inputs of the dense scan's own
    calls, as each call is made (nothing is cloned: a 500 Mchar block's
    inputs take gigabytes): radix_sort at every stable_argsort call site
    of ops/joint_sa.py and ops/ms_dense.py, the first call at each
    (sort_times; ``sorts`` by site), sa_round on the seed's rank step
    (``seed``) and on every round's (``rounds``; with ``every`` False only
    the first full round's), and running_fill on the first flag fill
    (``fill``)."""

    def __init__(self, tag: str, every: bool = True):
        self.tag, self.every = tag, every
        self.sorts, self.rounds, self.fill, self.seed = {}, [], None, None
        self.seconds = 0.0      # spent holding and timing, not scanning

    def __enter__(self):
        from cmsbwt_tpu_torch import kernels as K_
        from cmsbwt_tpu_torch.ops import joint_sa as js
        from cmsbwt_tpu_torch.ops import ms_dense as md
        from cmsbwt_tpu_torch.ops.fill import running_fill_reference
        self.js, self.md = js, md
        self.orig = (js.stable_argsort, md.stable_argsort, js.round_ranks,
                     js.running_fill, js.seed_ranks)

        def argsort_in(fn):
            def argsort(keys, bits, values=False):
                keys = tuple(keys)
                site = call_site(sys._getframe(1))
                if site not in self.sorts:
                    t0 = time.perf_counter()
                    # a 500 Mchar block's sorts take up to ~0.1 s each
                    r = sort_times(f"{self.tag} {site} (dense)", keys,
                                   tuple(int(b) for b in bits), values,
                                   3 if keys[0].numel() > 1 << 26 else 5)
                    r.pop("outputs", None)
                    self.sorts[site] = r
                    self.seconds += time.perf_counter() - t0
                return fn(keys, bits, values)
            return argsort

        def rounds(perm, keys, lv, k, comp=None):
            if self.every or (comp is None and not self.rounds):
                t0 = time.perf_counter()
                self.rounds.append(sa_round_case(
                    f"{self.tag} round {len(self.rounds)}", perm, keys, lv,
                    k, comp))
                self.seconds += time.perf_counter() - t0
            return self.orig[2](perm, keys, lv, k, comp)

        def seeds(order, rows, sl):
            if self.seed is None:
                t0 = time.perf_counter()
                self.seed = seed_case(self.tag, order, rows, sl)
                self.seconds += time.perf_counter() - t0
            return self.orig[4](order, rows, sl)

        def fill(v, op="max", reverse=False):
            if self.fill is None:
                t0 = time.perf_counter()
                name = f"{self.tag}_flag_fill"
                # torch's 1-D scan takes ~0.7 s on a 500 Mchar block
                big = v.numel() > 1 << 26
                self.fill = fill_times(K_, name, compare(
                    "running_fill", name, "running_fill_reference",
                    lambda: (K_.running_fill_cuda(v, op, reverse),),
                    lambda: (running_fill_reference(v, op, reverse),),
                    f"the joint sort's first flag fill: m={v.numel()} "
                    f"{v.dtype} {op}{' reverse' if reverse else ''}",
                    2 * nbytes(v), plain_reps=0 if big else 2), v, op,
                    reverse, 1 if big else 2)
                self.fill.pop("outputs")
                self.seconds += time.perf_counter() - t0
            return self.orig[3](v, op, reverse)
        js.stable_argsort = argsort_in(self.orig[0])
        md.stable_argsort = argsort_in(self.orig[1])
        js.round_ranks, js.running_fill, js.seed_ranks = rounds, fill, seeds
        return self

    def __exit__(self, *exc):
        (self.js.stable_argsort, self.md.stable_argsort, self.js.round_ranks,
         self.js.running_fill, self.js.seed_ranks) = self.orig


def bucket_sums_bytes(bucket_rank, m_c, nec: int, n_pad: int) -> int:
    """Bytes bucket_sums must move: bucket_rank, bid (each lane's checked)
    and m_c of the nec valid lanes read once, and its three outputs
    (hb_at, ncls_at over n_pad, hb_b over h_pad) written once."""
    return 12 * max(nec, 0) + 4 * (2 * n_pad + bucket_rank.numel())


def bucket_sums_library(bucket_rank, bid, m_c, nec: int, n_pad: int):
    """The three sums as Tensor.index_add_ on the indices and values the
    plain version scatters (pad lanes at index 0): the library call timed
    beside the kernel."""
    h_pad = bucket_rank.numel()
    dev = bucket_rank.device
    valid = torch.arange(h_pad, device=dev) < nec
    br0 = torch.where(valid, bucket_rank, 0).long()
    bidv = torch.clamp(bid, 0, h_pad - 1)[valid].long()

    def run():
        z = lambda k: torch.zeros(k, dtype=torch.int32, device=dev)
        return (z(n_pad).index_add_(0, br0, m_c),
                z(n_pad).index_add_(0, br0, torch.ones_like(m_c)),
                z(h_pad).index_add_(0, bidv, m_c[valid]))
    return run


def bucket_sums_lanes(sizes, n_pad: int, h_pad: int, rank0: bool, seed: int):
    """Class lanes as runs_emit_dev gives them to bucket_sums, on the card:
    buckets of the given sizes in order of rank (the first of rank 0 when
    ``rank0``), then pad lanes up to h_pad (bucket_rank INT_MAX, m_c 0);
    returns (bucket_rank, bid, m_c, nec)."""
    g = np.random.default_rng(seed)
    nec = int(sum(sizes))
    ranks = np.sort(g.choice(np.arange(1, n_pad), len(sizes), replace=False))
    if rank0 and len(sizes):
        ranks[0] = 0
    br = np.full(h_pad, 2**31 - 1, np.int32)
    br[:nec] = np.repeat(ranks, sizes)
    bid = np.full(h_pad, len(sizes) - 1, np.int32)
    bid[:nec] = np.repeat(np.arange(len(sizes)), sizes)
    mc = np.zeros(h_pad, np.int32)
    mc[:nec] = g.integers(0, 9, nec)
    t = lambda a: torch.from_numpy(a).cuda()
    return t(br), t(bid), t(mc), nec


def garbage_outputs(*sizes) -> None:
    """Fill int32 tensors of these sizes with the byte 0x5A and free them:
    the caching allocator hands that memory back to the next allocations
    of the same sizes, so an output slot a kernel leaves unwritten
    shows."""
    junk = [torch.full((k,), 0x5A5A5A5A, dtype=torch.int32, device="cuda")
            for k in sizes]
    torch.cuda.synchronize()
    del junk


def bucket_sums_cases() -> int:
    """bucket_sums against its plain version (exact) on built lanes at the
    kernel's tile edges (BS_TILE lanes), each call's outputs given memory
    that held 0x5A bytes (garbage_outputs): one bucket of every class,
    each class its own bucket, buckets straddling tiles, nec 0 and 1, a
    valid class of rank 0, pad lanes only, rank gaps longer than a tile;
    then a valid lane whose bucket_rank falls and a bid off by one inside
    a tile, where the kernel must set the plain version's fault word and
    bucket_sums_check refuse it. Returns the cases run."""
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.kernels import bucket_sums_cuda
    T = BS_TILE
    built = {
        "one_bucket": ([3 * T + 5], False),
        "own_buckets": ([1] * (3 * T + 5), False),
        f"straddle_{T - 1}": ([T - 1, T - 1, 7, T + 1], False),
        f"straddle_{T}": ([T, T, 1, 2 * T], True),
        f"straddle_{T + 1}": ([T + 1, 5, T + 1, 3], False),
        f"straddle_3x{T}_5": ([5, 3 * T, 1, 2 * T + 7], True),
        "nec_0": ([], False),
        "nec_1": ([1], False),
        "nec_1_rank0": ([1], True),
        "rank0": ([4, 9, T + 3], True),
        "mixed_100k": (list(np.random.default_rng(3).integers(
            1, 40, 5000)), True),
    }
    cases = 0
    for name, (sizes, rank0) in built.items():
        nec = int(sum(sizes))
        for pads in (0, 1, 3 * T + 1):
            for n_pad in (4 * T + 11, 64 * T):   # short and long rank gaps
                h_pad = max(nec + pads, 1)
                a = bucket_sums_lanes(sizes, n_pad, h_pad, rank0, cases)
                want = dm._bucket_sums_reference(*a, n_pad)
                garbage_outputs(n_pad, n_pad, h_pad)
                got = bucket_sums_cuda(*a, n_pad)
                dm.bucket_sums_check(got[3])
                if not all(torch.equal(x, y) for x, y in zip(want, got)):
                    fail(f"bucket_sums[{name}, {pads} pad lanes, n_pad "
                         f"{n_pad}] differs from its plain version")
                cases += 1
    # a falling rank (bits 0 and 2: it splits its bucket) and a bid off
    # by one at a lane inside a tile (bit 2): the plain version and the
    # kernel set the same fault word, and the check raises
    br, bid, mc, nec = bucket_sums_lanes([T, T + 3, 9], 4 * T + 11,
                                         2 * T + 20, False, 99)
    bad_br, bad_bid = br.clone(), bid.clone()
    bad_br[T + 1] = br[0] - 1
    bad_bid[T + T // 2] += 1
    for what, a, bits, msg in (
            ("a falling bucket_rank", (bad_br, bid), 5, "below its"),
            ("a bid off by one inside a tile", (br, bad_bid), 4, "bid is")):
        for fn in (bucket_sums_cuda, dm._bucket_sums_reference):
            fault = fn(*a, mc, nec, 4 * T + 11)[3]
            if int(fault[0]) != bits:
                fail(f"bucket_sums: {fn.__name__} gave fault "
                     f"{int(fault[0])} for {what}, not {bits}")
            try:
                dm.bucket_sums_check(fault)
            except RuntimeError as e:
                if msg not in str(e):
                    raise
            else:
                fail(f"bucket_sums: {fn.__name__} let {what} through")
    log(f"kernel bucket_sums: {cases} built cases exact (tolerance {TOL}); "
        "a falling bucket_rank and a bid off by one inside a tile gave the "
        "kernel and the plain version the same fault word, which the check "
        "refused")
    return cases


def sort_keys(kind: str, n: int, bits: int, dtype, seed: int,
              offset: bool = False) -> torch.Tensor:
    """n keys of ``bits`` width on the card (values in [0, min(2^bits -
    1, pad)) or the dtype's pad) of one pattern; with ``offset`` a view
    that starts one row into its storage (no 16-byte alignment)."""
    from cmsbwt_tpu_torch.ops.sort import PADS
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pad = PADS[dtype]
    top = min((1 << bits) - 1, pad)
    m = n + int(offset)

    def draw(k):
        return torch.randint(0, top, (k,), generator=g, device="cuda",
                             dtype=torch.int64)
    if kind == "random":
        k = draw(m)
    elif kind == "ties":
        k = draw(5)[torch.randint(0, 5, (m,), generator=g, device="cuda")]
    elif kind == "equal":
        k = draw(1).expand(m).clone()
    elif kind == "descending":
        k = torch.sort(draw(m), descending=True).values
    elif kind == "pads":
        k = torch.full((m,), pad, dtype=torch.int64, device="cuda")
    else:
        coin = torch.rand(m, generator=g, device="cuda")
        k = (torch.where(coin < 0.5, top - 1, pad) if kind == "top"
             else torch.where(coin < 0.2, pad, draw(m)))
    k = k.to(dtype)
    return k[1:] if offset else k


def skewed_keys(kind: str, n: int, bits: int, dtype,
                seed: int) -> torch.Tensor:
    """n keys of ``bits`` width on the card in one of the port's skewed
    layouts (SORT_SKEWED): random keys with tiles 1 and 2 of radix_sort
    (SORT_TILE rows) and the last fifth all pads ("pad_runs"); one low
    byte in every row under random high bits ("one_digit"); the jump
    scan's candidates, [lanes, cap] slots with each lane's records rising
    through its own span and the slots past its count pads
    ("lane_tails", 4096 lanes when n allows, nrec up to a quarter of
    cap)."""
    from cmsbwt_tpu_torch.ops.sort import PADS
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pad = PADS[dtype]
    top = min((1 << bits) - 1, pad)
    i64 = torch.int64
    if kind == "pad_runs":
        k = torch.randint(0, top, (n,), generator=g, device="cuda",
                          dtype=i64)
        k[SORT_TILE:3 * SORT_TILE] = pad
        k[n - n // 5:] = pad
    elif kind == "one_digit":
        low = int(torch.randint(0, min(top, 256), (1,), generator=g,
                                device="cuda"))
        k = torch.randint(0, max(top >> 8, 1), (n,), generator=g,
                          device="cuda", dtype=i64) << 8 | low
        k = torch.where(k < top, k, low)
    else:
        lanes = 4096 if n >= 4096 * 64 else 8
        cap = -(-n // lanes)
        span = max(top // lanes, 1)
        nrec = torch.randint(0, cap // 4 + 1, (lanes, 1), generator=g,
                             device="cuda")
        step = torch.randint(0, max(span // cap, 1) + 1, (lanes, cap),
                             generator=g, device="cuda")
        t = (torch.arange(lanes, device="cuda")[:, None] * span
             + torch.cumsum(step, 1) // 2).clamp_(max=top - 1)
        slot = torch.arange(cap, device="cuda")[None, :]
        k = torch.where(slot < nrec, t, pad).reshape(-1)[:n]
    return k.to(dtype)


def sort_case(name: str, keys, bits, garbage=True) -> None:
    """radix_sort against its plain version (exact) on these keys: the
    permutation and the first key's sorted values, the outputs given
    memory that held 0x5A bytes first (garbage_outputs)."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.ops import sort as S
    n = keys[0].numel()
    want = S._stable_argsort_reference(keys, bits, True)
    if garbage:
        garbage_outputs(n, n, n * keys[0].element_size() // 4)
    got = K.radix_sort_cuda(keys, bits, S.fault_word("cuda:0"), True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(want, got)):
        fail(f"radix_sort[{name}]: differs from its plain version")
    S.check_faults("cuda:0")


def sort_cases() -> int:
    """radix_sort and compact against their plain versions (exact) on the
    card: one key of every width and pattern at the tiles' edges (odd
    cases as views one row into their storage), several keys (the
    merge's shapes, pads only; the composite and the per-key plans), the
    port's skewed layouts (whole tiles of pads, one digit in every row,
    the jump scan's lane tails; n of 2, just over a tile and more),
    compactions at
    every share of set flags, aligned and not; then a key over its width
    and a wrong count of set flags, where the kernels must set the plain
    versions' fault words and check_faults refuse them. Returns the
    cases run."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.ops import sort as S
    tile = int(K.load()["radix_sort"].radix_sort_tile())
    if tile != SORT_TILE:
        fail(f"radix_sort.cu's tile is {tile} rows, SORT_TILE {SORT_TILE}")
    cases = 0
    for n in SORT_SIZES:
        for bits, dt in SORT_WIDTHS:
            for kind in SORT_KINDS:
                keys = (sort_keys(kind, n, bits, dt, cases, cases % 2 == 1),)
                sort_case(f"{kind}, {bits} bits {dt}, n={n}", keys, (bits,),
                          garbage=n < 1 << 20)
                cases += 1
    for name, spec in SORT_MULTI.items():
        for n in (3 * SORT_TILE + 5, (1 << 22) + 3):
            for values in (True, False):
                keys = tuple(sort_keys(kind, n, b, dt, cases + i, i == 1)
                             for i, (b, dt, kind) in enumerate(spec))
                bits = tuple(b for b, _, _ in spec)
                if values:
                    sort_case(f"{name}, n={n}", keys, bits)
                else:
                    want = S._stable_argsort_reference(keys, bits)
                    got = K.radix_sort_cuda(keys, bits,
                                            S.fault_word("cuda:0"))
                    if not torch.equal(want, got):
                        fail(f"radix_sort[{name}, n={n}, no values]: "
                             "differs from its plain version")
                    S.check_faults("cuda:0")
                cases += 1
    # the port's skewed layouts, alone and as the join's first key
    for kind in SORT_SKEWED:
        for n in (2, SORT_TILE + 1, 5 * SORT_TILE + 77, (1 << 22) + 3):
            for bits, dt in ((23, torch.int32), (29, torch.int32),
                             (47, torch.int64)):
                sort_case(f"{kind}, {bits} bits {dt}, n={n}",
                          (skewed_keys(kind, n, bits, dt, cases),), (bits,),
                          garbage=n < 1 << 20)
                cases += 1
            keys = (skewed_keys(kind, n, 23, torch.int32, cases),
                    sort_keys("ties", n, 47, torch.int64, cases + 1))
            sort_case(f"{kind} under the join's key2f, n={n}", keys,
                      (23, 47), garbage=n < 1 << 20)
            cases += 1
    for n in SORT_SIZES:
        for share in (0.0, 0.03, 0.5, 1.0):
            for offset in (False, True):
                g = torch.Generator(device="cuda")
                g.manual_seed(cases)
                flag = torch.rand(n + offset, generator=g,
                                  device="cuda") < share
                flag = flag[1:] if offset else flag
                count = int(flag.sum())
                want = S._compact_reference(flag, count)
                garbage_outputs(n)
                got = K.compact_cuda(flag, count, S.fault_word("cuda:0"))
                torch.cuda.synchronize()
                if not torch.equal(want, got):
                    fail(f"compact[n={n}, share {share}, offset {offset}]: "
                         "differs from its plain version")
                S.check_faults("cuda:0")
                cases += 1
    # a key over its width (bit 1: the second key) and a wrong count: the
    # kernel and the plain version set the same fault word, and the
    # check raises
    n = 3 * SORT_TILE + 5
    k = sort_keys("mixed", n, 23, torch.int32, 7)
    k[SORT_TILE + 17] = (1 << 23) - 1
    keys = (sort_keys("ties", n, 48, torch.int64, 8), k)
    flag = torch.rand(n, device="cuda") < 0.3
    count = int(flag.sum()) + 1
    for what, bits, msg, fns in (
            ("a key over its width", 2, "outside its stated width",
             (lambda: K.radix_sort_cuda(keys, (48, 23),
                                        S.fault_word("cuda:0")),
              lambda: S._stable_argsort_reference(keys, (48, 23)))),
            ("a wrong count of set flags", S.COUNT_FAULT, "count of set",
             (lambda: K.compact_cuda(flag, count, S.fault_word("cuda:0")),
              lambda: S._compact_reference(flag, count)))):
        for fn, form in zip(fns, ("kernel", "plain version")):
            S.fault_word("cuda:0").zero_()
            fn()
            if int(S.fault_word("cuda:0")[0]) != bits:
                fail(f"the {form} gave fault "
                     f"{int(S.fault_word('cuda:0')[0])} for {what}, not "
                     f"{bits}")
            try:
                S.check_faults("cuda:0")
            except RuntimeError as e:
                if msg not in str(e):
                    raise
            else:
                fail(f"check_faults let {what} through ({form})")
    log(f"kernel radix_sort / compact: {cases} cases exact (tolerance "
        f"{TOL}); a key over its width and a wrong count gave the kernels "
        "and the plain versions the same fault words, which the check "
        "refused")
    return cases


def torch_lexsort(keys):
    """The library's stable argsort by several keys: torch.sort passes,
    the last key first."""
    order = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def sort_bytes(keys, bits, values: bool, rb: int) -> tuple:
    """(floor, passes): the bytes a stable argsort must move — each key
    read once, the int32 permutation (and the first key's values)
    written once — and the bytes radix_sort's launches move
    (kernels.radix_plan): radix_hist's read of every key, and each
    pass's read of its input (the keys, or the words before it) and row
    ids, and its writes: row ids, words, a gathered next key (read and
    written) and values."""
    from cmsbwt_tpu_torch import kernels as K
    n = keys[0].numel()
    vals = nbytes(keys[0]) if values else 0
    floor = nbytes(*keys) + 4 * n + vals
    moved = nbytes(*keys)
    for at, ps in enumerate(K.radix_plan(bits, rb, values)):
        moved += (nbytes(*(keys[q] for q in ps.keys)) if ps.keys
                  else (8 if ps.in_wide else 4) * n) + (4 * n if at else 0)
        moved += 4 * n + ((8 if ps.stage_wide else 4) * n if ps.write
                          else 0)
        if ps.next is not None:
            moved += nbytes(keys[ps.next]) \
                + (8 if bits[ps.next] > 32 else 4) * n
        if ps.vals:
            moved += vals
    return floor, moved


def sort_times(tag: str, keys, bits, values: bool, reps: int = 5) -> dict:
    """radix_sort against its plain version on a call site's sort, with
    the site's own ``values`` flag (the permutation, and the first key's
    sorted values when it is set), then timed as the site runs it: as the
    wrapper runs it, alone (scratch made beforehand), beside torch.sort
    passes (the library call; the plain version's sorts) and copy_ of the
    floor's bytes; ``reps`` launches each (fewer for the torch.sort
    passes)."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.ops import sort as S
    fault = S.fault_word("cuda:0")
    n = keys[0].numel()
    lib = K.load()["radix_sort"]
    outputs = lambda r: tuple(r) if values else (r,)
    floor, moved = sort_bytes(keys, bits, values,
                              int(lib.radix_sort_radix_bits()))
    r = compare(
        "radix_sort", tag, "_stable_argsort_reference",
        lambda: outputs(K.radix_sort_cuda(keys, bits, fault, values)),
        lambda: outputs(S._stable_argsort_reference(keys, bits, values)),
        f"n={n} rows, keys {[str(k.dtype) for k in keys]} of {bits} bits",
        floor, reps, 2 if reps >= 5 else 1)
    S.check_faults("cuda:0")
    r["alone_ms"] = alone_ms(
        lambda scratch: K.radix_sort_cuda(keys, bits, fault, values,
                                          scratch=scratch),
        int(lib.radix_sort_scratch_bytes(n)), reps)
    r["library_ms"] = library_ms(lambda: torch_lexsort(keys),
                                 2 if reps >= 5 else 1)
    r["copy_ms"] = copy_ms(floor)
    r["passes_bound_ms"] = bound_ms(moved)
    r.update(rows=n, bits=list(bits), values=values, passes=len(
        K.radix_plan(bits, int(lib.radix_sort_radix_bits()), values)))
    S.check_faults("cuda:0")
    log(f"kernel radix_sort[{tag}]: alone {r['alone_ms']:.3f} ms, as the "
        f"wrapper runs it {r['ms']:.3f} ms, torch.sort passes "
        f"{r['library_ms']:.3f} ms, copy_ of the floor's bytes "
        f"{r['copy_ms']:.3f} ms; bounds: floor {r['bound_ms']:.4f} ms, "
        f"passes {r['passes_bound_ms']:.4f} ms")
    return r


def compact_times(tag: str, flag, count: int) -> dict:
    """compact against its plain version on a merge's compaction, then
    timed: as the wrapper runs it, alone, beside one stable torch.sort
    of the inverted flag (the library call) and copy_ of its bytes."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.ops import sort as S
    fault = S.fault_word("cuda:0")
    n = flag.numel()
    r = compare("compact", tag, "_compact_reference",
                lambda: (K.compact_cuda(flag, count, fault),),
                lambda: (S._compact_reference(flag, count),),
                f"n={n} rows, {count} set", 5 * n)
    S.check_faults("cuda:0")
    lib = K.load()["compact"]
    r["alone_ms"] = alone_ms(
        lambda scratch: K.compact_cuda(flag, count, fault, scratch),
        int(lib.compact_scratch_bytes(n)))
    inv = ~flag
    r["library_ms"] = cuda_ms(
        lambda: torch.sort(inv, stable=True).indices, 2)
    if not torch.equal(torch.sort(inv, stable=True).indices.to(torch.int32),
                       r["outputs"][0]):
        fail(f"compact[{tag}]: torch.sort of the inverted flag differs")
    r["copy_ms"] = copy_ms(5 * n)
    log(f"kernel compact[{tag}]: alone {r['alone_ms']:.3f} ms, as the "
        f"wrapper runs it {r['ms']:.3f} ms, torch.sort of the inverted "
        f"flag {r['library_ms']:.3f} ms, copy_ of the same bytes "
        f"{r['copy_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
    S.check_faults("cuda:0")
    return r


def rank_step_bytes(args, kw, top) -> int:
    """Bytes a full rank step must move: order and key 0 read, key 1 where
    a row's key 0 ties a neighbour's (the rows it reads), the rank
    written; the next key (dense), or the slice's rows and their key 1
    (their rank read once: 16 B a slice row)."""
    order, s0, key1 = args[:3]
    n = order.numel()
    tie = torch.zeros(n, dtype=torch.bool, device=s0.device)
    tie[1:] |= s0[1:] == s0[:-1]
    tie[:-1] |= s0[:-1] == s0[1:]
    moved = 12 * n + (4 * int(tie.sum()) if key1 is not None else 0)
    sl = kw.get("slice_")
    if sl is not None:
        moved += 16 * min(int(top[0]), sl[0].numel())
    elif kw.get("nxt") is not None:
        moved += 4 * n
    return moved


def dense_rank_case(tag: str, args, kw, what: str) -> dict:
    """dense_rank (sa_round.cu) against _dense_rank_reference (exact, every
    output: rank_step_run) on one full rank step (``args``, ``kw`` as
    rank_step_clone keeps them; ``what`` names it); timed with its
    wrapper (its RankWork made per call), alone and beside Tensor.copy_
    of the bound's bytes (rank_step_bytes)."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.index import device as idx
    kern, plain, _, _ = _kernel_and_plain(K, idx)
    n, top = args[0].numel(), rank_step_run(plain, args, kw)[1]
    moved = rank_step_bytes(args, kw, top)
    r = compare("dense_rank", tag, "_dense_rank_reference",
                lambda: rank_step_run(kern, args, kw),
                lambda: rank_step_run(plain, args, kw),
                f"{what}: n={n} rows, "
                f"{'two keys' if args[2] is not None else 'one key'}, "
                + (f"{int(top[0])} left unresolved"
                   if kw.get("slice_") is not None
                   else f"largest rank {int(top[0])}"), moved)
    r.pop("outputs")
    r["alone_ms"] = alone_ms(*dense_rank_launch(K, args, kw))
    r["copy_ms"] = copy_ms(moved)
    r["rows"] = n
    r["top"] = int(top[0])
    log(f"kernel dense_rank[{tag}]: alone {r['alone_ms']:.3f} ms, as the "
        f"wrapper runs it {r['ms']:.3f} ms, copy_ of the bound's bytes "
        f"{r['copy_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
    return r


def comp_step_bytes(args, want) -> int:
    """Bytes a compacted round must move: the slice's text positions and
    key 0 read (8 B a row) and its key 1 (the entry gathered for each row:
    4 B); the rank written where it changes and the suffix array where a
    row is resolved this round (4 B each, counted from the plain version's
    outputs ``want``: comp_step_run's); the next slice's rows written (8 B
    a row), and with a shift their key 1 (their rank read once, key 1
    written: 8 B a row)."""
    (ti, _, _), u, _, rank0, _, _, shift, _ = args
    top, rank = want[0], want[1]
    c = int(top[0])
    t = ti.long()
    changed = int((rank[t] != rank0[t]).sum())
    return 12 * u + 4 * changed + 4 * (u - c) + 8 * c + (8 * c if shift
                                                         else 0)


def comp_wrapper_ms(K, args, reps: int = 5) -> float:
    """Mean device time of dense_rank_comp_cuda as the suffix sort calls
    it, on one compacted call's arguments (as CompCapture keeps them):
    ``reps`` calls back to back between two CUDA events, each on its own
    copies of the call's in-place outputs (key 1, the rank, the suffix
    array, the next slice) and its own RankWork, all made beforehand."""
    from cmsbwt_tpu_torch.ops.sort import fault_word
    (ti, k0, k1), u, large, rank, sa, nxt, shift, rounds = args
    fault = fault_word(rank.device)
    sets = [((ti, k0, k1.clone()), rank.clone(), sa.clone(),
             tuple(t.clone() for t in nxt),
             K.RankWork(rank.numel(), 0, rank.device, 1))
            for _ in range(reps + 1)]

    def call(one):
        sl, rk, sa_, nx, work = one
        K.dense_rank_comp_cuda(sl, u, large, rk, sa_, nx, shift, fault,
                               work, tail=rounds)
    call(sets.pop())   # warm
    it = iter(sets)
    return cuda_ms(lambda: call(next(it)), reps)


def dense_rank_comp_case(tag: str, args, what: str) -> dict:
    """dense_rank_comp against its plain version (exact, every output:
    comp_step_run) on one compacted call of a merge's head string, then
    timed with its wrapper (comp_wrapper_ms: its outputs' copies and
    RankWork made beforehand), alone and beside Tensor.copy_ of the
    bound's bytes (a round's: comp_step_bytes)."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.index import device as idx
    _, _, kern, plain = _kernel_and_plain(K, idx)
    u, m, rounds = args[1], args[3].numel(), args[7]
    want = comp_step_run(plain, args)
    top, moved = want[0], comp_step_bytes(args, want)
    r = compare("dense_rank_comp", tag,
                "_comp_tail_reference" if rounds else "_comp_rank_reference",
                lambda: comp_step_run(kern, args),
                lambda: comp_step_run(plain, args),
                f"{what}: u={u} of m={m} rows, {int(top[0])} left "
                f"unresolved after {int(top[3])} rounds", moved)
    r.pop("outputs")
    r["ms"] = comp_wrapper_ms(K, args)
    r["alone_ms"] = alone_ms(*dense_rank_comp_launch(K, args, 5))
    r["copy_ms"] = copy_ms(moved)
    r["rows"], r["m"], r["unresolved"] = u, m, int(top[0])
    r["rounds"] = int(top[3])
    log(f"kernel dense_rank_comp[{tag}]: alone {r['alone_ms']:.3f} ms, as "
        f"the wrapper runs it {r['ms']:.3f} ms, copy_ of the bound's bytes "
        f"{r['copy_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
    return r


def pair_expand_case(tag: str, cls: dict, pairs: dict, slot_base, n: int,
                     h_pad: int, p_pad: int) -> dict:
    """pair_expand against _pair_expand_reference (exact) on the pairs of
    one merge's tail_good, timed with its wrapper (the inclusive sum of
    the pair counts included), alone and beside Tensor.copy_ of the
    bound's bytes: the ten class arrays read once, the join's rows and
    src_cls written once."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.engine import device_merge as dm
    J = h_pad + p_pad
    moved = 37 * h_pad + 20 * J + 4 * p_pad
    big = p_pad > 1 << 26
    r = compare("pair_expand", tag, "_pair_expand_reference",
                lambda: dm.pair_expand(cls, pairs, slot_base, n, h_pad,
                                       p_pad),
                lambda: dm._pair_expand_reference(cls, pairs, slot_base, n,
                                                  h_pad, p_pad),
                f"P={pairs['total']} pairs, p_pad={p_pad}, h_pad={h_pad}, "
                f"J={J} join rows", moved, plain_reps=0 if big else 2)
    r.pop("outputs")
    torch.cuda.empty_cache()
    args = (cls["pos"], cls["length"], cls["key_k"], cls["isa_next"],
            cls["size"], cls["smaller"], pairs["pair_lo"],
            torch.cumsum(pairs["pair_cnt"], 0).to(torch.int32),
            slot_base[:h_pad], pairs["bucket_pos"], int(cls["n_classes"]),
            int(pairs["total"]), n, p_pad)
    r["alone_ms"] = alone_ms(*pair_expand_launch(K, args))
    r["copy_ms"] = copy_ms(moved)
    r["rows"] = J
    log(f"kernel pair_expand[{tag}]: alone {r['alone_ms']:.3f} ms, as the "
        f"wrapper runs it {r['ms']:.3f} ms, copy_ of the bound's bytes "
        f"{r['copy_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
    return r


# run_output.cu's tiles: rle_pack's records a block, bwt_expand's runs a
# scan tile and output bytes a block
OUT_PACK_TILE = 512
OUT_SCAN_TILE = 8192
OUT_EXP_TILE = 16384
OUT_CHARS = np.array([2, 65, 67, 71, 84], np.uint8)   # separator, ACGT


def made_runs(R: int, seed: int, sn: int | None = None, lead0=False,
              long_every: int = 0):
    """A merged run list of R runs on the card (int32 lengths 1-12, uint8
    chars from OUT_CHARS, neighbours different): with ``lead0`` the first
    run's char is 0 (the tool's prevChar start), with ``long_every`` every
    such run is 3 output tiles + 5 long, and with ``sn`` the last run's
    length is set so that the lengths sum to sn (at least 1)."""
    rng = np.random.default_rng(seed)
    ln = rng.integers(1, 13, R).astype(np.int64)
    if long_every:
        ln[::long_every] = 3 * OUT_EXP_TILE + 5
    steps = rng.integers(1, len(OUT_CHARS), R)
    idx = np.cumsum(steps) % len(OUT_CHARS)
    ch = OUT_CHARS[idx]
    if lead0 and R:
        ch[0] = 0
    if sn is not None and R:
        ln[-1] = sn - int(ln[:-1].sum())
        if ln[-1] < 1:
            fail(f"made_runs: sn {sn} below {R} runs' lengths")
    return (torch.from_numpy(ln.astype(np.int32)).cuda(),
            torch.from_numpy(ch).cuda())


def runs_of(lengths, seed: int):
    """A merged run list on the card with the given lengths, its chars
    from OUT_CHARS with neighbours different."""
    rng = np.random.default_rng(seed)
    ch = OUT_CHARS[np.cumsum(rng.integers(1, len(OUT_CHARS), len(lengths)))
                   % len(OUT_CHARS)]
    return (torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            torch.from_numpy(ch).cuda())


def output_pair(K, out_mod, rl, rc, rle: bool, sn: int):
    """The kernel's and the plain version's (output, fault) on one run
    list, synchronised."""
    if rle:
        got = K.rle_pack_cuda(rl, rc)
        want = out_mod.rle_pack_reference(rl, rc)
    else:
        got = K.bwt_expand_cuda(rl, rc, sn)
        want = out_mod.bwt_expand_reference(rl, rc, sn)
    torch.cuda.synchronize()
    return got, want


def output_cases() -> int:
    """rle_pack and bwt_expand against their plain versions on the card
    (exact, bytes and fault word) on made run lists at their tiles'
    edges: R = 0 (rle_pack's single (0, 0) record), 1, a record tile and a
    scan tile +- 1, three tiles + 5, 2^22 + 3; sums at an output tile +-
    1; a leading char-0 run; runs longer than three output tiles; views
    off the 16-byte frame; bwt_expand's tile edges: a tile of T
    one-byte runs (the most runs a tile reads: T + 1), sn = 3T in one-byte
    runs, one run of the whole collection (R = 1, sn = 2^22 + 3), runs
    that cross every tile start; and the faults: a length of 0, two
    neighbours of one char, lengths that do not sum to sn, short by three
    tiles and more (tile starts left unwritten; the dispatch must raise).
    Returns the cases held."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.io import output as out_mod
    t0 = time.perf_counter()
    cases = []
    for R in (1, 2, OUT_PACK_TILE - 1, OUT_PACK_TILE, OUT_PACK_TILE + 1,
              3 * OUT_PACK_TILE + 5, OUT_SCAN_TILE - 1, OUT_SCAN_TILE,
              OUT_SCAN_TILE + 1, 3 * OUT_SCAN_TILE + 5, (1 << 22) + 3):
        cases.append((f"R={R}", made_runs(R, R)))
    for sn in (OUT_EXP_TILE - 1, OUT_EXP_TILE, OUT_EXP_TILE + 1,
               3 * OUT_EXP_TILE + 7):
        cases.append((f"sn={sn}", made_runs(sn // 7, sn, sn=sn)))
    cases.append(("lead0", made_runs(5000, 7, lead0=True)))
    cases.append(("long_runs", made_runs(3000, 8, long_every=97)))
    rl, rc = made_runs(OUT_SCAN_TILE + 3, 9)
    cases.append(("views", (rl[1:], rc[1:])))
    T = OUT_EXP_TILE
    cases.append(("one_byte_tile", runs_of([3] + [1] * (2 * T) + [5], 12)))
    cases.append(("sn=3T_one_byte", runs_of([1] * (3 * T), 13)))
    cases.append(("one_run", runs_of([(1 << 22) + 3], 14)))
    cases.append(("cross_tiles", runs_of([T // 2] + [T] * 6 + [T // 2 + 5],
                                         15)))
    held = 0
    for name, (rl, rc) in cases:
        sn = int(rl.to(torch.int64).sum())
        for rle in (True, False):
            (g, gf), (w, wf) = output_pair(K, out_mod, rl, rc, rle, sn)
            if not (torch.equal(g, w) and int(gf[0]) == int(wf[0]) == 0):
                fail(f"{'rle_pack' if rle else 'bwt_expand'}[{name}]: the "
                     "kernel differs from its plain version (or faults)")
            held += 1
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    (g, gf), (w, wf) = output_pair(K, out_mod, empty, empty.to(torch.uint8),
                                   True, 0)
    if not (torch.equal(g, w) and g.numel() == 9 and not int(g.sum())
            and int(gf[0]) == 0):
        fail("rle_pack[R=0]: not the single (0, 0) record")
    held += 1
    # faults: the kernel's word equal to the plain version's, and the
    # dispatch raising
    rl, rc = made_runs(3 * OUT_SCAN_TILE + 5, 11)
    sn = int(rl.to(torch.int64).sum())
    zero, dup = rl.clone(), rc.clone()
    zero[OUT_SCAN_TILE + 7] = 0
    dup[2 * OUT_PACK_TILE] = dup[2 * OUT_PACK_TILE - 1]
    for name, a, b, rle, n in (
            ("zero_length", zero, rc, True, sn),
            ("zero_length", zero, rc, False, sn - int(rl[OUT_SCAN_TILE + 7])),
            ("same_char", rl, dup, True, sn),
            ("sum_short", rl, rc, False, sn + 1),
            ("sum_short_tiles", rl, rc, False, sn + 3 * OUT_EXP_TILE + 5),
            ("sum_long", rl, rc, False, sn - 1)):
        (g, gf), (w, wf) = output_pair(K, out_mod, a, b, rle, n)
        kname = "rle_pack" if rle else "bwt_expand"
        if int(gf[0]) == 0 or int(gf[0]) != int(wf[0]):
            fail(f"{kname}[{name}]: fault word {int(gf[0])}, plain "
                 f"{int(wf[0])}")
        try:
            (out_mod.rle_pack(a, b) if rle else out_mod.bwt_expand(a, b, n))
        except RuntimeError:
            held += 1
        else:
            fail(f"{kname}[{name}]: the dispatch did not raise")
    log(f"output cases: {held} held (exact) in "
        f"{time.perf_counter() - t0:.1f} s")
    return held


def output_launch(K, rl, rc, rle: bool, sn: int, part: str = "all"):
    """rle_pack's or bwt_expand's C entry point with its outputs made
    beforehand; returns (launch(scratch), scratch bytes). ``part`` times
    one of bwt_expand's kernels alone: "starts" its scan, "tiles" its
    expansion (from the tile starts of one scan made here first)."""
    lib = K.load()["run_output"]
    R = rl.numel()
    if rle:
        out = torch.empty(9 * max(R, 1), dtype=torch.uint8, device="cuda")

        def launch(scratch):
            if lib.rle_pack_launch(_p(rl), _p(rc), R, _p(out), _p(scratch),
                                   _stream()):
                fail("rle_pack launch failed")
        return launch, int(lib.run_output_scratch_bytes(0, 0))
    out = torch.empty(sn, dtype=torch.uint8, device="cuda")
    scratch_bytes = int(lib.run_output_scratch_bytes(R, sn))
    if part == "tiles":
        # one scan's tile starts, read by every launch
        starts = torch.zeros(scratch_bytes, dtype=torch.uint8,
                             device="cuda")
        if lib.bwt_expand_starts_launch(_p(rl), R, sn, _p(starts),
                                        _stream()):
            fail("bwt_expand's scan launch failed")

    def launch(scratch):
        if part == "starts":
            err = lib.bwt_expand_starts_launch(_p(rl), R, sn, _p(scratch),
                                               _stream())
        elif part == "tiles":
            err = lib.bwt_expand_tiles_launch(_p(rl), _p(rc), R, sn, _p(out),
                                              _p(starts), _stream())
        else:
            err = lib.bwt_expand_launch(_p(rl), _p(rc), R, sn, _p(out),
                                        _p(scratch), _stream())
        if err:
            fail(f"bwt_expand ({part}) launch failed")
    return launch, 16 if part == "tiles" else scratch_bytes


def output_case(tag: str, rl, rc, rle: bool) -> dict:
    """rle_pack (``rle``) or bwt_expand against its plain version (exact)
    on a merge's run list, timed with its wrapper (its allocations and
    memsets included), alone, beside Tensor.copy_ of the bound's bytes
    (rle_pack: 5 B a run read, 9 written; bwt_expand: 5 B a run read, sn
    written) and, for bwt_expand, beside torch.repeat_interleave, with its
    scan and its expansion also timed alone."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.io import output as out_mod
    R = rl.numel()
    sn = int(rl.to(torch.int64).sum())
    name = "rle_pack" if rle else "bwt_expand"
    moved = 14 * R if rle else 5 * R + sn
    if rle:
        kern, plain = (lambda: K.rle_pack_cuda(rl, rc),
                       lambda: out_mod.rle_pack_reference(rl, rc))
    else:
        kern, plain = (lambda: K.bwt_expand_cuda(rl, rc, sn),
                       lambda: out_mod.bwt_expand_reference(rl, rc, sn))
    r = compare(name, tag, name + "_reference", kern, plain,
                f"R={R} runs, sn={sn}", moved)
    want = r.pop("outputs")
    if int(want[1][0]):
        fail(f"{name}[{tag}]: the merge's run list breaks the record rule")
    r["alone_ms"] = alone_ms(*output_launch(K, rl, rc, rle, sn))
    r["copy_ms"] = copy_ms(moved)
    r["library_ms"] = None
    if not rle:
        for part in ("starts", "tiles"):
            r[f"{part}_alone_ms"] = alone_ms(*output_launch(K, rl, rc, rle,
                                                            sn, part))
        library = lambda: torch.repeat_interleave(rc, rl)
        if not torch.equal(library(), want[0]):
            fail(f"{name}[{tag}]: torch.repeat_interleave differs from the "
                 "plain version")
        r["library_ms"] = library_ms(library, 5)
    r["rows"], r["sn"] = R, sn
    log(f"kernel {name}[{tag}]: alone {r['alone_ms']:.3f} ms, as the "
        f"wrapper runs it {r['ms']:.3f} ms, copy_ of the bound's bytes "
        f"{r['copy_ms']:.3f} ms"
        + ("" if rle else f" (its scan {r['starts_alone_ms']:.3f} ms, its "
           f"expansion {r['tiles_alone_ms']:.3f} ms alone), "
           f"torch.repeat_interleave {r['library_ms']:.3f} ms")
        + f", bound {r['bound_ms']:.4f} ms")
    return r


def merge_kernel_cases(tag: str, cap: MergeCapture,
                       scan_sorts: SortCapture,
                       index_rank: IndexRankCapture) -> dict:
    """The merge's kernels against their plain versions (exact) on the
    inputs one device merge gave them (MergeCapture), and dense_rank's
    dense mode on the jump scan's index build's round 0 (``index_rank``),
    then timed: radix_sort on every sort of the merge and of
    ``scan_sorts`` (the jump scan's: one index-doubling round, the
    candidates) by call site (``radix_sort_sites``; ``radix_sort`` is the
    merge's largest, the join's)."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.ops.fill import running_fill_reference
    out = {}
    v, op, rev = cap.fill
    out["running_fill"] = fill_times(K, f"{tag}_merge", compare(
        "running_fill", f"{tag}_merge", "running_fill_reference",
        lambda: (K.running_fill_cuda(v, op, rev),),
        lambda: (running_fill_reference(v, op, rev),),
        f"the merge's largest fill: m={v.numel()} {v.dtype} {op}"
        f"{' reverse' if rev else ''}", 2 * nbytes(v)), v, op, rev)
    k1s, k2fs, i_s, pay_s, h_pad = cap.join

    def join_out(res):
        counter, ekey, f_cls, n_exact, members = res
        return (counter, ekey, f_cls,
                torch.tensor([n_exact, members], device=counter.device))
    J = k1s.numel()
    out["tail_good_join"] = compare(
        "tail_good_join", tag, "_tail_good_join_reference",
        lambda: join_out(K.tail_good_join_cuda(k1s, k2fs, i_s, pay_s,
                                               h_pad)),
        lambda: join_out(dm._tail_good_join_reference(k1s, k2fs, i_s, pay_s,
                                                      h_pad)),
        f"J={J} join rows, h_pad={h_pad}",
        nbytes(k1s, k2fs, i_s, pay_s) + 8 * J + 4 * (h_pad + 2))
    if cap.exact is None:
        fail(f"the {tag} merge had no exact pairs: no tail_exact_credit "
             "case")
    a = cap.exact
    f_s, h_pad_x = a[1], a[-1]
    out["tail_exact_credit"] = compare(
        "tail_exact_credit", tag, "_exact_credit_reference",
        lambda: (K.tail_exact_credit_cuda(*a),),
        lambda: (dm._exact_credit_reference(*a),),
        f"J={f_s.numel()} join rows, {a[4].numel()} queries (tot={a[5]})",
        # the three row columns and dst read once, the class arrays'
        # h_pad slots once each, the counter read and written
        nbytes(a[1], a[2], a[3], a[4]) + 4 * 4 * h_pad_x
        + 2 * nbytes(a[0]))
    br, bid, m_c, nec, n_pad = cap.sums
    out["bucket_sums"] = compare(
        "bucket_sums", tag, "_bucket_sums_reference",
        lambda: K.bucket_sums_cuda(br, bid, m_c, nec, n_pad),
        lambda: dm._bucket_sums_reference(br, bid, m_c, nec, n_pad),
        f"h_pad={br.numel()} lanes, nec={nec}, n_pad={n_pad}",
        bucket_sums_bytes(br, m_c, nec, n_pad))
    library = bucket_sums_library(br, bid, m_c, nec, n_pad)
    if not all(torch.equal(a, b) for a, b in
               zip(library(), out["bucket_sums"]["outputs"])):
        fail(f"bucket_sums[{tag}]: index_add_ differs from the plain "
             "version")
    r = out["bucket_sums"]
    r["library_ms"] = cuda_ms(library, 5)
    r["alone_ms"] = alone_ms(*bucket_sums_launch(K, br, bid, m_c, nec,
                                                 n_pad))
    r["copy_ms"] = copy_ms(bucket_sums_bytes(br, m_c, nec, n_pad))
    log(f"kernel bucket_sums[{tag}]: alone {r['alone_ms']:.3f} ms, as the "
        f"wrapper runs it {r['ms']:.3f} ms, copy_ of the same bytes "
        f"{r['copy_ms']:.3f} ms, three Tensor.index_add_ "
        f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
    # the head string's main path runs one full step (its first round,
    # on the pairs, group-start ranks), then compacted rounds; the
    # reference index runs dense steps in every round
    out["dense_rank"] = dense_rank_case(
        f"{tag} first round", *cap.rank,
        "the head string's first round (group-start ranks, the slice)")
    if index_rank.step is None:
        fail(f"the {tag} jump scan's index build ran no two-key rank step")
    out["dense_rank_index"] = dense_rank_case(
        f"{tag} index round 0", *index_rank.step,
        "the reference index's round 0 (dense ranks, the next key)")
    if cap.comp is None or cap.tail is None:
        fail(f"the {tag} merge's head string ran no compacted round or no "
             "tail")
    out["dense_rank_comp"] = dense_rank_comp_case(
        tag, cap.comp, "the head string's first compacted round")
    out["dense_rank_comp_tail"] = dense_rank_comp_case(
        f"{tag} tail", cap.tail, "the head string's tail (one block)")
    out["pair_expand"] = pair_expand_case(tag, *cap.expand)
    # the output file's bytes of the merge's runs
    rl, rc, _ = cap.run_out
    out["rle_pack"] = output_case(tag, rl, rc, True)
    out["bwt_expand"] = output_case(tag, rl, rc, False)
    k_s, len_s, chr_s = cap.runs
    out["run_merge"] = compare(
        "run_merge", tag, "_run_merge_reference",
        lambda: K.run_merge_cuda(k_s, len_s, chr_s)[:2],
        lambda: dm._run_merge_reference(k_s, len_s, chr_s)[:2],
        f"L={k_s.numel()} lanes",
        lambda want: nbytes(k_s, len_s, chr_s) + nbytes(*want))
    # the scan's own: its index's doubling shares a site with the merge's
    # head-string sort (index/device.suffix_array_device)
    sites = {f"{site} (jump scan)": args
             for site, args in scan_sorts.sites.items()}
    sites.update(cap.sorts.sites)
    out["radix_sort_sites"] = {site: sort_times(f"{tag} {site}", *args)
                               for site, args in sites.items()}
    out["radix_sort"] = max(
        (out["radix_sort_sites"][site] for site in cap.sorts.sites),
        key=lambda r: r["rows"])
    out["compact"] = compact_times(tag, *cap.compact)
    for r in [*out.values(), *out["radix_sort_sites"].values()]:
        r.pop("outputs", None)
    return out


def phases_from_log(path: pathlib.Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        if line.endswith(" ms") and ": " in line:
            k, v = line.split(": ", 1)
            out[k] = float(v[:-3])
    return out


class BlockLog:
    """Records every try of every block the blocked dense scans run, by
    wrapping ops/ms_dense._scan_block while in use: the block's window,
    bs_pad and m, whether it was retried, its host-clock seconds (device
    synced) and the peak device bytes while it ran. The peak statistic is
    reset as each block starts and ends, so ``gap_peak`` is the peak
    outside the blocks (the merge, the writer) and ``run_peak`` the peak
    of the whole span."""

    def __init__(self, md):
        self.md, self.orig = md, md._scan_block
        self.tries, self.gap_peak = [], 0

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.md._scan_block = self._spy
        return self

    def __exit__(self, *exc):
        self.md._scan_block = self.orig
        self._gap()

    def _gap(self):
        torch.cuda.synchronize()
        self.gap_peak = max(self.gap_peak, torch.cuda.max_memory_allocated())

    def _spy(self, x_u8, sx, n, **kw):
        self._gap()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self.orig(x_u8, sx, n, **kw)
        torch.cuda.synchronize()
        m = int(x_u8.shape[0]) + kw["bs_pad"]
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.tries.append(dict(
            b0=kw["b0"], end=kw["end"], emit=kw["emit_len"],
            sep_base=kw["sep_base"], bs_pad=kw["bs_pad"], m=m,
            retried=out is None,
            s=round(time.perf_counter() - t0, 4), peak=peak,
            peak_per_joint_char=round(peak / m, 1)))
        return out

    @property
    def retries(self) -> int:
        return sum(t["retried"] for t in self.tries)

    @property
    def run_peak(self) -> int:
        return max([self.gap_peak] + [t["peak"] for t in self.tries])


def same_heads(a, b) -> bool:
    """Two DeviceHeadsResults hold the same h heads (t, pos, len, smaller,
    char), compared on the card."""
    h = a.h
    return h == b.h and all(
        torch.equal(getattr(a, k)[:h], getattr(b, k)[:h])
        for k in ("head_t", "head_pos", "head_len", "head_smaller",
                  "head_char"))


def normalized_runs(run_len: np.ndarray, run_char: np.ndarray) -> tuple:
    """A run list as the device merge emits it: empty runs dropped and
    neighbours of one char joined."""
    keep = run_len > 0
    run_len, run_char = run_len[keep], run_char[keep]
    new = np.ones(len(run_char), dtype=bool)
    new[1:] = run_char[1:] != run_char[:-1]
    starts = np.nonzero(new)[0]
    return np.add.reduceat(run_len, starts) if len(starts) else run_len, \
        run_char[new]


def host_merge(x_aug: np.ndarray, dres, d: int, sn: int, rle_quirk: bool):
    """The host merge (engine/pipeline.merge_from_heads) on a device scan's
    heads, downloaded once; returns (PipelineResult, {stage: ms}, ms)."""
    from cmsbwt_tpu_torch.engine import pipeline as pl
    from cmsbwt_tpu_torch.utils.timing import PhaseTimer
    index, heads = pl.dense_result_to_inputs(
        x_aug, pl.download_heads_result(dres, len(x_aug)))
    timer = PhaseTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pl.merge_from_heads(index, heads, d, sn, rle_quirk, "cuda", timer)
    ms = (time.perf_counter() - t0) * 1e3
    return res, {k: round(t * 1e3, 1) for k, t in timer.phases}, ms


def rle_histogram(path: pathlib.Path) -> np.ndarray:
    """Chars per byte value of an .rl_bwt (records of a uint64 LE run
    length and the run's char)."""
    rec = np.fromfile(path, dtype=[("len", "<u8"), ("chr", "u1")])
    return np.bincount(rec["chr"], weights=rec["len"].astype(np.float64),
                       minlength=256).astype(np.int64)


def phase9(run_cli, check_counts, reset_counts, check_heads, paths, lst,
           oracle, k200k, x_aug, coll) -> None:
    """auto (the CLI with no --backend), the CMSBWT model, ms_dense and
    --parallel on the card, each held to its oracle and its kernels
    counted."""
    from cmsbwt_tpu_torch import CMSBWT
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index import device as idev
    from cmsbwt_tpu_torch.io import output as out_mod
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.ops.ms_device import ms_scan_device
    from cmsbwt_tpu_torch.parallel import blocked as pb

    # the default CLI: auto resolves, and the resolved route's kernels
    # carry it
    run_cli(None, "auto_default", merge="auto")
    log(f"auto[primary]: the default CLI ran backend {paths[-1][0]}")

    # the model: the device index built once over five transforms, three
    # on the device merge and two on the host merge (merge_backend 'host')
    built = []
    orig = idev.build_device_index

    def spy(*a, **kw):
        built.append(1)
        return orig(*a, **kw)
    idev.build_device_index = spy
    try:
        ref_path, coll_path = lst.read_text().split()
        model = CMSBWT(ref_path, device="cuda")
        for tag, be, engine in (
                ("model_jump", "jump", "device"),
                ("model_dense", "dense", "device"),
                ("model_jump_again", "jump", "device"),
                ("model_jump_host", "jump", "host"),
                ("model_dense_host", "dense", "host")):
            model.config = dataclasses.replace(model.config,
                                               merge_backend=engine)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = model.transform(coll_path, backend=be)
            wall = time.perf_counter() - t0
            if res.bwt != oracle[False]:
                fail(f"{tag}: CMSBWT.transform's bwt differs from the "
                     "reference tool's")
            log(f"model[{tag}]: bytes equal to the reference tool's; wall "
                f"{wall:.2f} s; phases ms " + json.dumps(
                    {k: round(t * 1e3, 1) for k, t in res.timer.phases})
                + " write " + json.dumps(out_mod.LAST_WRITE))
            if ("merge_device" in dict(res.timer.phases)) != (
                    engine == "device"):
                fail(f"{tag}: the model did not merge on the {engine} merge")
            out_mod.LAST_WRITE.clear()
            check_counts(be, tag, 1, engine,
                         plain_writes=int(engine == "device"))
        del model, res
    finally:
        idev.build_device_index = orig
    log(f"model: device index built {len(built)} time(s) over 5 transforms")
    if len(built) != 1:
        fail("CMSBWT built its device index more than once")
    torch.cuda.empty_cache()

    # ms_dense against the jump scan's heads expanded per position
    x2, c2 = load_inputs(str(k200k))
    reset_counts()
    dm = md.ms_dense(x2, c2.sx, "cuda")
    check_counts("dense", "ms_dense", 1, "none", parsed=False)
    dv = ms_scan_device(idev.build_device_index(x2, "cuda"), c2.sx, "cuda")
    heads = dv.is_head
    same = (np.array_equal(dm.pos, dv.pos)
            and np.array_equal(dm.length, dv.length)
            and np.array_equal(dm.is_head, dv.is_head)
            and np.array_equal(dm.smaller[heads], dv.smaller[heads]))
    log(f"ms_dense[200Kbp_x8]: sn={c2.sn} m={dm.m} heads={int(heads.sum())} "
        f"irreducible={dm.irreducible}; pos, length, is_head at every "
        f"position and smaller at the heads equal to the expanded jump "
        f"scan's: {same}")
    if not same:
        fail("ms_dense differs from the expanded jump scan")
    del dm, dv, x2, c2
    torch.cuda.empty_cache()

    # --parallel in 4 Mi-char blocks: bytes, heads, a kernel launch per
    # block try
    bc = 4 << 20
    with BlockLog(md) as blk:
        run_cli("dense", "dense_parallel",
                ["--parallel", "--block-chars", str(bc)], blocks=blk)
    starts = sorted({t["b0"] for t in blk.tries})
    if starts != list(range(0, coll.sn, bc)):
        fail(f"--parallel ran blocks at {starts}")
    log(f"parallel[primary]: {len(starts)} blocks, {len(blk.tries)} tries "
        "over 2 runs")
    check_heads(pb.ms_dense_heads_parallel(x_aug, coll.sx, bc,
                                           device="cuda"), "dense parallel")
    torch.cuda.empty_cache()


def phase10(run_cli, check_counts, reset_counts, lst, x_aug, coll) -> None:
    """The sharded merge after jump and dense, the mesh scan and the giant
    route, on R = torch.cuda.device_count() ranks (one NCCL rank per card),
    each held to its oracle and its kernels counted."""
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    from cmsbwt_tpu_torch.parallel import distributed
    from cmsbwt_tpu_torch.parallel.mesh import ms_dense_heads_mesh
    t10 = time.perf_counter()
    ranks = torch.cuda.device_count()
    # the sharded merge: bytes against the reference tool's (phase 5's)
    for be in ("jump", "dense"):
        run_cli(be, f"{be}_sharded", merge="sharded")
        log(f"mesh[{be}_sharded]: {ranks} NCCL rank(s); last run "
            + json.dumps(distributed.LAST_RUN))
    # the mesh scan in 4 Mi-char blocks: heads against the jump scan's
    bc = 4 << 20
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mres = ms_dense_heads_mesh(x_aug, coll.sx, bc, device="cuda")
    wall = time.perf_counter() - t0
    blocks = -(-coll.sn // bc)
    counts = check_counts("dense", "mesh_scan", 1, "none", parsed=False)
    if ranks == 1 and not (counts["lcp_lift"] == counts["dense_neighbors"]
                           >= blocks):
        fail(f"the mesh scan's {blocks} blocks launched {counts}")
    jres = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
    h = jres.h
    want = [getattr(jres, k)[:h].cpu().numpy() for k in (
        "head_t", "head_pos", "head_len", "head_smaller", "head_char")]
    got = [mres.head_t, mres.head_pos, mres.head_len, mres.head_smaller,
           mres.head_char]
    if mres.h != h or any(not np.array_equal(g.astype(w.dtype), w)
                          for g, w in zip(got, want)):
        fail(f"the mesh scan's heads differ from the jump scan's "
             f"(h={mres.h} vs {h})")
    log(f"mesh[scan]: {ranks} rank(s), {blocks} blocks of {bc}, h={h} equal "
        f"to the jump scan's; irreducible={mres.irreducible}; wall "
        f"{wall:.2f} s; last run " + json.dumps(distributed.LAST_RUN))
    del jres, mres
    torch.cuda.empty_cache()
    # the giant route on the short reference: the normal route's bytes
    short = WORK / "kshort" / "input.txt"
    normal = run_cli("jump", "giant_normal", inp=short, want=None)
    del normal
    os.environ["CMSBWT_GIANT_THRESHOLD"] = "64"
    try:
        run_cli(None, "giant", inp=short, want=None, merge="auto",
                want_merge="host")
    finally:
        del os.environ["CMSBWT_GIANT_THRESHOLD"]
    for ext in (".bwt", ".rl_bwt"):
        a = (WORK / f"port_giant{'_rle' if ext == '.rl_bwt' else ''}"
             ).with_suffix(ext).read_bytes()
        b = (WORK / f"port_giant_normal{'_rle' if ext == '.rl_bwt' else ''}"
             ).with_suffix(ext).read_bytes()
        if a != b:
            fail(f"the giant route's {ext} differs from the normal route's")
    log(f"mesh[giant]: CMSBWT_GIANT_THRESHOLD=64 on the short reference: "
        f"bytes equal to the normal route's; last run "
        + json.dumps(distributed.LAST_RUN))
    log(f"mesh: phase 10 took {time.perf_counter() - t10:.1f} s")


# dense_rank's tiles (sa_round.cu: 2048 rows) and the sizes at their edges,
# and around the compacted rounds' cap (kernels.COMP_CAP: the slice's rows
# in groups above it, which the group-start mode counts)
RANK_TILE = 2048


def rank_sizes() -> tuple:
    from cmsbwt_tpu_torch.kernels import COMP_CAP as C
    return (1, 2, 3, RANK_TILE - 1, RANK_TILE, RANK_TILE + 1,
            3 * RANK_TILE + 5, C - 1, C, C + 1, C + 2, 100_003,
            (1 << 20) + 3)

RANK_KINDS = ("random", "few", "equal", "distinct")


def rank_keys(n: int, kind: str, seed: int):
    """Two int32 key rows on the card, below (n, n + 1): random, few
    values, all equal or all distinct (key 0)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        a, b = rng.integers(0, n, n), rng.integers(0, n + 1, n)
    elif kind == "few":
        a, b = rng.integers(0, min(3, n), n), rng.integers(0, 2, n)
    elif kind == "equal":
        a, b = np.zeros(n, np.int64), np.zeros(n, np.int64)
    else:
        a, b = rng.permutation(n), rng.integers(0, n + 1, n)
    return (torch.from_numpy(a.astype(np.int32)).cuda(),
            torch.from_numpy(b.astype(np.int32)).cuda())


def _same(what: str, want, got) -> None:
    if want.dtype != got.dtype or want.shape != got.shape or \
            not torch.equal(want.cpu(), got.cpu()):
        fail(f"{what}: differs from the CPU's")


def rank_step_run(fn, args, kw) -> tuple:
    """One full rank step ``fn(order, s0, key1, out, **kw)`` (the CUDA
    wrapper or index/device._dense_rank_reference) on copies of the
    step's in-place outputs (``args`` = order, s0, key1, out; ``kw`` the
    dispatch's keywords but its scratch): every output it defines, the
    rank, top, the next key, or the slice's rows and their key 1."""
    order, s0, key1, out = args
    k = dict(kw)
    if k.get("nxt") is not None:
        k["nxt"] = k["nxt"].clone()
    if k.get("slice_") is not None:
        k["slice_"] = tuple(t.clone() for t in k["slice_"])
    rank, top = fn(order, s0, key1, None if out is None else out.clone(),
                   **k)
    sl = k.get("slice_")
    got = [rank, top]
    if sl is not None:
        c = min(int(top[0]), sl[0].numel())
        got += [t[:c] for t in sl]
    elif k.get("nxt") is not None:
        got.append(k["nxt"])
    return tuple(got)


def comp_step_run(fn, args) -> tuple:
    """One compacted call ``fn(slice, u, large, rank, sa, nxt_slice,
    shift, rounds)`` (the CUDA wrapper, or index/device's plain versions)
    on copies of its in-place outputs (``args`` as comp_clone keeps them):
    top, the rank, the suffix array, the next slice and, for a round with
    a shift, its key 1."""
    slice_, u, large, rank, sa, nxt_slice, shift, rounds = args
    slice_ = tuple(v.clone() for v in slice_)
    rank, sa = rank.clone(), sa.clone()
    ti_n, k0_n = (t.clone() for t in nxt_slice)
    top = fn(slice_, u, large, rank, sa, (ti_n, k0_n), shift, rounds)
    c = int(top[0])
    return (top, rank, sa, ti_n[:c], k0_n[:c]) + (
        (slice_[2][:c],) if shift and not rounds else ())


def _kernel_and_plain(K, idx):
    """The rank steps' CUDA wrappers (on the sorts' fault word) and plain
    versions, as rank_step_run and comp_step_run call them."""
    from cmsbwt_tpu_torch.ops.sort import fault_word
    fault = fault_word("cuda:0")

    def comp_plain(slice_, u, large, rank, sa, nxt, shift, rounds):
        if rounds:
            return idx._comp_tail_reference(slice_, u, rank, sa, nxt, shift,
                                            rounds)
        return idx._comp_rank_reference(slice_, u, large, rank, sa, nxt,
                                         shift)
    return (lambda o, s, k1, out, **kw: K.dense_rank_cuda(o, s, k1, fault,
                                                          out, **kw),
            idx._dense_rank_reference,
            lambda slice_, u, large, rank, sa, nxt, shift, rounds:
            K.dense_rank_comp_cuda(slice_, u, large, rank, sa, nxt, shift,
                                   fault, tail=rounds),
            comp_plain)


def rank_step_case(name: str, order, s0, key1, shift: int, start=None):
    """dense_rank_cuda against _dense_rank_reference on one sorted step,
    exact (rank_step_run; every output written over -7s): dense ranks
    with the next key at ``shift``, or with ``start`` = cap group-start
    ranks, the slice (cap rows) and its key 1 at ``shift``."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.index import device as idx
    kern, plain, _, _ = _kernel_and_plain(K, idx)
    n = order.numel()
    fill = lambda k: torch.full((k,), -7, dtype=torch.int32, device="cuda")
    kw = dict(nxt=fill(n), shift=shift) if start is None else \
        dict(slice_=tuple(fill(start) for _ in range(3)), shift=shift)
    args = (order, s0, key1, fill(n))
    for q, (w, g) in enumerate(zip(rank_step_run(plain, args, kw),
                                   rank_step_run(kern, args, kw))):
        if w.shape != g.shape or not torch.equal(w, g):
            fail(f"dense_rank[{name}]: output {q} differs from its plain "
                 "version")


class CompCapture:
    """Keeps a clone of every compacted call's inputs (index/device's
    comp_rank and comp_tail, as comp_clone keeps them) while in use."""

    def __enter__(self):
        from cmsbwt_tpu_torch.index import device as idx
        self.idx, self.calls = idx, []
        self.orig = (idx.comp_rank, idx.comp_tail)

        def comp(slice_, u, large, rank, sa, nxt_slice, shift, work=None):
            self.calls.append(comp_clone(slice_, u, large, rank, sa,
                                         nxt_slice, shift, 0))
            return self.orig[0](slice_, u, large, rank, sa, nxt_slice,
                                shift, work)

        def tail(slice_, u, rank, sa, nxt_slice, shift, rounds, work=None):
            self.calls.append(comp_clone(slice_, u, 0, rank, sa, nxt_slice,
                                         shift, rounds))
            return self.orig[1](slice_, u, rank, sa, nxt_slice, shift,
                                rounds, work)
        idx.comp_rank, idx.comp_tail = comp, tail
        return self

    def __exit__(self, *exc):
        self.idx.comp_rank, self.idx.comp_tail = self.orig


def comp_step_case(name: str, args) -> None:
    """dense_rank_comp_cuda against its plain version on one compacted
    call's inputs (``args`` as comp_clone keeps them), exact: every
    output of comp_step_run."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.index import device as idx
    _, _, kern, plain = _kernel_and_plain(K, idx)
    for q, (w, g) in enumerate(zip(comp_step_run(plain, args),
                                   comp_step_run(kern, args))):
        if w.shape != g.shape or not torch.equal(w, g):
            bad = [] if w.shape != g.shape else \
                torch.nonzero(w != g).flatten()[:5].tolist()
            fail(f"dense_rank_comp[{name}]: output {q} differs from its "
                 f"plain version (shapes {tuple(w.shape)}, "
                 f"{tuple(g.shape)}; at {bad}: "
                 f"{[int(w[i]) for i in bad]} != {[int(g[i]) for i in bad]})")


def comp_slices():
    """The slices at the edges of the compacted rounds' shared-memory sort
    (sa_round.cu: groups of at most kernels.COMP_CAP rows, tiles of
    dense_rank_comp_tile() rows, a block sorting by counting while no
    group of it has more than dense_rank_comp_small() rows, else by its
    bitonic network): {name: group sizes}; a group above the cap takes the
    large path."""
    from cmsbwt_tpu_torch import kernels as K
    C = K.COMP_CAP
    lib = K.load()["sa_round"]
    T, S = int(lib.dense_rank_comp_tile()), int(lib.dense_rank_comp_small())
    rng = np.random.default_rng(29)
    small = lambda k: list(rng.integers(1, 6, k))
    return {
        "small_groups": small(3 * T // 3) + [2],
        "at_the_count_limit": small(T // 2) + [S, 3, S, 1] + small(T),
        "past_the_count_limit": small(T // 2) + [S + 1, 2] + small(T)
        + [S, S + 1],
        "tile_edges": [T - 1, 2, T - 2, 3, 1, T + 1, 2],
        "at_the_cap": [3, C, 2, C - 1, 5, C, 1],
        "above_the_cap": [2, C + 1, 4, 2 * C + 7, 3],
        "large_from_a_tile_end": [T - 1, C + 1, 2, 3 * T, 1],
        "one_large_group": [3 * C + 5],
        "one_row": [1],
        "tail_one_group": [C],
        "tail_many": small(C // 4),
        "tail_two": [2],
    }


def comp_slice_case(name: str, sizes, kind: str, seed: int, rounds: int,
                    shift: int) -> None:
    """dense_rank_comp against its plain version on a slice made of
    groups of ``sizes`` rows (key 0 each group's start rank, with gaps;
    key 1 of ``kind``: few values, distinct or equal; distinct text
    positions; a random rank but at the slice's positions, where it is
    key 0), as one round, or with ``rounds`` as the tail (u <=
    COMP_CAP)."""
    from cmsbwt_tpu_torch.kernels import COMP_CAP
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int64)
    u = int(sizes.sum())
    starts = np.cumsum(np.concatenate([[0], sizes[:-1]])) + np.cumsum(
        rng.integers(0, 3, len(sizes)))
    m = int(starts[-1] + sizes[-1] + 8)
    k0 = np.repeat(starts, sizes)
    k1 = {"few": rng.integers(0, 3, u), "distinct": rng.permutation(u) + 1,
          "equal": np.ones(u, np.int64)}[kind]
    ti = rng.permutation(m)[:u]
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    large = int(sizes[sizes > COMP_CAP].sum())
    fill = lambda k: torch.full((k,), -7, dtype=torch.int32, device="cuda")
    rank = rng.integers(0, m, m)
    rank[ti] = k0           # a slice row's rank is its key 0
    args = ((dev(ti), dev(k0), dev(k1)), u, 0 if rounds else large,
            dev(rank), fill(m), (fill(u), fill(u)), shift, rounds)
    comp_step_case(f"{name}, {kind}" + (f", tail {rounds}" if rounds
                                        else ""), args)


def rank_strings() -> dict:
    """Strings for the suffix sort's checks: (values int32, bound)."""
    rng = np.random.default_rng(17)
    out = {"acgt_1000": (rng.integers(0, 4, 1000), 256),
           "acgt_300k": (rng.integers(0, 4, 300_000), 256),
           "periodic_5000": (np.tile([0, 1, 2, 1], 1250), 256),
           "equal_4099": (np.zeros(4099, np.int64), 256),
           # a slice of one group of the cap (the tail) and of the cap + 1
           # rows (the large path); one group of all 40 000 rows; groups of
           # ~10 000 rows a round
           "equal_4097": (np.zeros(4097, np.int64), 256),
           "equal_4098": (np.zeros(4098, np.int64), 256),
           "equal_40000": (np.zeros(40_000, np.int64), 256),
           "period3_30000": (np.tile([2, 0, 1], 10_000), 256),
           "n1": (rng.integers(0, 4, 1), 256)}
    # a head string: ranks with repeats, a terminator 0, pads above 2^30
    h, L = 200_000, 262_145
    r = np.empty(L, np.int64)
    r[:h] = np.repeat(rng.integers(1, 5000, h // 20), 20)
    r[h] = 0
    r[h + 1:] = (1 << 30) + np.arange(h + 1, L)
    out["head_string"] = (r, (1 << 30) + L)
    # a collection of one document repeated: the head string of its
    # ranks, every group as large as the copies
    doc = rng.integers(1, 900, 7)
    out["repeated_doc"] = (np.concatenate([np.tile(doc, 5000), [0]]), 901)
    return {k: (v.astype(np.int32), b) for k, (v, b) in out.items()}


def rank_cases() -> int:
    """dense_rank (both modes) and dense_rank_comp against their plain
    versions on the card (exact): every kind of key at the tiles' edges,
    one key and two, the next key at shifts inside and past n, the
    group-start mode's slice whole and cut, its key 1 at shifts inside
    and past n; dense_rank_comp on made slices (comp_slices: groups at
    the tiles' edges, at the cap and above it, one large group, the tail
    at the cap and over several rounds), as a round with its next key and
    as the tail; then index/device.suffix_array_device on the card against
    the CPU on rank_strings() with the history and without it, each
    compacted call on the card against its plain version (the large path
    and the tail among them). Returns the cases run."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.index import device as idx
    from cmsbwt_tpu_torch.ops import sort as S
    cases = 0
    for n in rank_sizes():
        for kind in RANK_KINDS:
            a, b = rank_keys(n, kind, n + cases)
            order, s0 = S.stable_argsort((a, b), (S.key_bits(n),
                                                  S.key_bits(n + 1)),
                                         values=True)
            o1, s1 = S.stable_argsort((a,), (S.key_bits(n),), values=True)
            for key1, (o, s) in ((None, (o1, s1)), (b, (order, s0))):
                tag = f"{kind}, n={n}, {'two keys' if key1 is not None else 'one key'}"
                for shift in (1, 3, n + 5):
                    rank_step_case(f"{tag}, dense, shift {shift}", o, s, key1,
                                   shift)
                    cases += 1
                for cap in (n, max(1, n // 3)):
                    for shift in (2, n + 5):
                        rank_step_case(f"{tag}, start, cap {cap}, shift "
                                       f"{shift}", o, s, key1, shift, cap)
                        cases += 1
    S.check_faults("cuda:0")
    big0 = K.LAUNCHES["radix_hist"]
    for name, sizes in comp_slices().items():
        tail = sum(sizes) <= idx.COMP_CAP
        for kind in ("few", "distinct", "equal"):
            for rounds, shift in ((0, 4), (0, 0)) + (
                    ((1, 2), (5, 8)) if tail else ()):
                comp_slice_case(name, sizes, kind, cases, rounds, shift)
                cases += 1
    if K.LAUNCHES["radix_hist"] == big0:
        fail("rank_cases: no made slice took the large-group path")
    S.check_faults("cuda:0")
    for name, (x, bound) in rank_strings().items():
        n = len(x)
        xc = torch.from_numpy(x)
        want = {h: idx.suffix_array_device(xc, n, bound, history=h)
                for h in (True, False)}
        xg = xc.cuda()
        got = idx.suffix_array_device(xg, n, bound, history=True)
        for q, what in enumerate(("sa", "isa", "history")):
            _same(f"suffix_array_device[{name}, history] {what}",
                  want[True][q], got[q])
        if got[3] != want[True][3]:
            fail(f"suffix_array_device[{name}, history]: k_star differs")
        sorts = K.LAUNCHES["radix_hist"]
        with CompCapture() as cap:
            got = idx.suffix_array_device(xg, n, bound, history=False)
        # the first round's sort and one a compacted round with large
        # groups (their rows only): no round sorts its slice
        sorts = K.LAUNCHES["radix_hist"] - sorts
        if sorts != 1 + sum(1 for c in cap.calls if c[2]):
            fail(f"suffix_array_device[{name}]: {sorts} sorts for "
                 f"{len(cap.calls)} compacted calls")
        for q, what in enumerate(("sa", "isa")):
            _same(f"suffix_array_device[{name}] {what}", want[True][q],
                  got[q])
        if got[2] is not None or got[3] != want[True][3]:
            fail(f"suffix_array_device[{name}]: a history or another "
                 "k_star")
        for i, args in enumerate(cap.calls):
            comp_step_case(f"{name}, call {i}", args)
            cases += 1
        cases += 1
    S.check_faults("cuda:0")
    log(f"rank_cases: {cases} cases of dense_rank, dense_rank_comp and "
        "the suffix sort equal their plain versions")
    return cases


# fasta_parse.cu's tile of raw bytes (fasta_parse_tile_bytes(), checked
# in parse_cases) and its chunk, a thread's 16-byte load
PARSE_TILE = 32768
PARSE_CHUNK = 16
PARSE_WINDOW = 64           # Config.skip_window, the jump scan's window
NO_CUT = 1 << 62


def _lines(n: int, width: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return b"".join(rng.choice(acgt, width).tobytes() + b"\n"
                    for _ in range(n))


def parse_files() -> list:
    """(name, bytes, sn_limits) of the made files parse_cases holds the
    kernel to its plain version on: the CPU tests' cases (the cut, the EOF
    separator, a 2 in a line, bad bytes, empty and header-only files, no
    '\n', an unterminated last line, 1-byte and 100 000-byte lines), and
    the kernel's tile edges: files of a tile +- 1 byte, a header and a
    line across three tiles, tiles with no '\n', a '\n' as every tile's
    last byte, 1-byte lines over a tile +- 1 byte, SX of a tile's bytes
    +- 1, an unwrapped line over five tiles, a 2 on both sides of a tile
    edge, bad bytes past the cut and in the unterminated tail of a
    multi-tile file, flushing lines across a tile edge before the cut
    line, cuts at a tile's edge, 60-byte lines off the 16-byte frame."""
    T = PARSE_TILE
    cut = b">a\nAAAA\nCCCC\n>b\nGGGG\nTT\n"
    files = [
        ("leading_header", b">a\nACGT\n>b\nGGTT\n", (NO_CUT,)),
        ("unterminated", b">a\nACGT\nGGG", (NO_CUT, 7)),
        ("no_header", b"ACGT\nGGTT\n", (NO_CUT,)),
        ("empty_line_flush", b"AC\n\nGT\n", (NO_CUT,)),
        ("prefix", b">a\nAAAA\nCCCC\nGGGG\n", (8, 6, 300)),
        ("carriage_return", b">a\r\nAC\rGT\r\n>b\nTT\r\n", (NO_CUT, 5)),
        ("separator_in_line", b">a\nAC\x02GT\n>b\nTTA\n", (NO_CUT,)),
        ("empty_file", b"", (NO_CUT, 1)),
        ("headers_only", b">a\n>b\n>c\n", (NO_CUT, 2)),
        ("no_newline", b"ACGT" * 5000, (NO_CUT,)),
        ("empty_lines", b"\n\n\n", (NO_CUT, 2)),
        ("cuts", cut, tuple(range(-1, 20))),
        ("one_byte_lines", b">a\n" + b"A\n" * 50, (NO_CUT, 20)),
        ("line_100000", b">a\n" + b"C" * 100_000 + b"\n>b\nAC\n",
         (NO_CUT, 50_000, 100_002)),
        ("bad_bytes", b">a\nAC\x00GT\n>\xff\nA\x01\x80\xff\n", (NO_CUT, 4)),
        ("bad_after_cut", b">a\nACGT\nA\x00\n", (5,)),
    ]
    for d in (-1, 0, 1):
        body = _lines(T // 61 + 2, 60, 10 + d)
        files.append((f"newline_tile{d:+d}", body[:T + d], (NO_CUT,)))
        files.append((f"one_byte_lines_tile{d:+d}", b"A\n" * (T // 2)
                      + b"C" * (d + 1), (NO_CUT, T // 2)))
        # SX of exactly a tile's bytes + d (one doc: its header's
        # separator, its bytes, the EOF separator)
        files.append((f"sx_tile{d:+d}", b">x\n" + b"T" * (T + d - 2)
                      + b"\n", (NO_CUT, T)))
    files += [
        ("header_over_tiles", b">" + b"h" * (3 * T + 5) + b"\nACGT\n"
         + _lines(5, 60, 3), (NO_CUT, 3 * T)),
        ("line_over_three_tiles", b">a\n" + b"G" * (3 * T + 5) + b"\n>b\n"
         + _lines(3, 60, 4), (NO_CUT, 2 * T + 7, 3 * T + 7)),
        ("tiles_without_newline", b"A" * (5 * T + 3) + b"\n" * 3,
         (NO_CUT,)),
        ("newline_at_tile_end", b">" + b"h" * 62 + b"\n"
         + _lines(3 * T // 64, 63, 6), (NO_CUT, T - 100, T + 1)),
        ("unwrapped_over_five_tiles", b">d0\n" + _lines(1, 5 * T + 9, 7)
         + b">d1\n" + _lines(1, 77, 8), (NO_CUT, 2 * T, 5 * T + 10)),
        ("separator_at_tile_edge", b">a\n" + b"A" * (T - 4) + b"\x02\x02"
         + b"C" * 100 + b"\n>b\n\x02GT\n", (NO_CUT, T - 3, T - 1)),
        ("bad_past_cut_and_in_tail", b">a\n" + b"A" * (T + 5) + b"\x00"
         + b"A" * 10 + b"\n>b\nGG\xff", (T // 2, T + 4, T + 5, NO_CUT)),
        ("flushes_over_tile_edge", b"A" * (T - 3) + b"\n" + b">h\n\n" * 5
         + b"GGTT\n", tuple(range(T - 3, T + 14, 2))),
        ("cuts_at_tile_edges", b">a\n" + _lines(1, 3 * T, 9),
         (T - 1, T, T + 1, T + 2, 2 * T, 2 * T + 1)),
        ("off_frame_60", b">header7\n" + _lines(2000, 60, 5),
         (NO_CUT, 65_537)),
    ]
    return files


def parse_pair(raw, sn_limit: int, window: int):
    """(kernel, plain) callables of the parse on ``raw``: the dispatch
    io/parse.parse_collection_dev as the main path runs it (fasta_parse on
    the card) and parse_collection_reference, each as (SX with its window
    of zero bytes, int64[3]: sn, separators, first bad offset)."""
    from cmsbwt_tpu_torch.io import parse as P

    def out(p):
        return (p.sx_padded, torch.tensor([p.sn, p.n_separators, p.bad],
                                          dtype=torch.int64))
    return (lambda: out(P.parse_collection_dev(raw, sn_limit, window)),
            lambda: out(P.parse_collection_reference(raw, sn_limit, window)))


def parse_cases() -> int:
    """fasta_parse against its plain version on the card (exact: SX and
    its window's zero bytes, sn, separators, the first bad offset) on
    parse_files(), each at its cuts and windows 64 and 1; returns the
    cases held."""
    from cmsbwt_tpu_torch import kernels as K
    tile = int(K.load()["fasta_parse"].fasta_parse_tile_bytes())
    if tile != PARSE_TILE:
        fail(f"fasta_parse: a {tile}-byte tile, the made files assume "
             f"{PARSE_TILE}")
    t0 = time.perf_counter()
    n = 0
    for name, data, lims in parse_files():
        raw = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(
            "cuda") if data else torch.zeros(0, dtype=torch.uint8,
                                            device="cuda")
        for lim in lims:
            for window in (PARSE_WINDOW, 1):
                kern, plain = parse_pair(raw, lim, window)
                got, want = kern(), plain()
                if got[0].shape != want[0].shape or not torch.equal(
                        got[0], want[0]) or not torch.equal(got[1], want[1]):
                    fail(f"fasta_parse[{name}, sn_limit={lim}, window="
                         f"{window}]: (sn, separators, bad) "
                         f"{got[1].tolist()} against the plain version's "
                         f"{want[1].tolist()}, or other bytes")
                n += 1
    log(f"kernel fasta_parse: {n} made cases exact against "
        f"parse_collection_reference ({time.perf_counter() - t0:.1f} s)")
    return n


def parse_parts(launch, scratch_bytes: int, reps: int = 3) -> dict:
    """fasta_parse's parts in mean device ms a launch (torch.profiler over
    ``reps`` alone launches): the scratch head's memset, the tile pass and
    the finish; {} when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    scratch = [torch.empty(max(scratch_bytes, 16), dtype=torch.uint8,
                           device="cuda") for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for sc in scratch:
            launch(sc)
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        for k, name in (("parse_tile_kernel", "tile_pass"),
                        ("parse_finish_kernel", "finish"),
                        ("Memset", "memset")):
            if k in e.key and us:
                parts[name] = parts.get(name, 0.0) + us / 1e3 / reps
    return parts


def parse_case(tag: str, path: pathlib.Path) -> dict:
    """fasta_parse against its plain version (exact) on a collection file
    the smoke wrote, read onto the card as the pipeline reads it
    (io/parse.read_raw, timed), then timed with the wrapper (the dispatch
    as the main path runs it: the buffers made, one C call, the result
    words read back once), alone (the C call into buffers made before the
    events) and beside Tensor.copy_ of the bound's bytes (the file read
    once, SX written once)."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.io import parse as P
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = P.read_raw(str(path), "cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    read = dict(P.LAST_READ)
    F = raw.numel()
    kern, plain = parse_pair(raw, F, PARSE_WINDOW)
    sn = int(plain()[1][0])
    r = compare("fasta_parse", tag, "parse_collection_reference", kern,
                plain, f"F={F} bytes, sn={sn}", F + sn)
    r.pop("outputs")
    work = K.fasta_parse_work(raw, PARSE_WINDOW)

    def launch(scratch):
        if K.fasta_parse_run(raw, F, PARSE_WINDOW,
                             work._replace(scratch=scratch)):
            fail("fasta_parse launch failed")
    r["alone_ms"] = alone_ms(launch, work.scratch.numel())
    if int(work.res[1]) != sn:
        fail(f"fasta_parse[{tag}]: alone, sn {int(work.res[1])} against {sn}")
    L = int(work.res[0])
    r["parts_ms"] = parse_parts(launch, work.scratch.numel())
    r["copy_ms"] = copy_ms(F + sn)
    r["library_ms"] = None
    r.update(bytes=F, sn=sn, lines=L, read_s=read_s, read=read)
    log(f"kernel fasta_parse[{tag}]: file read onto the card {read_s:.3f} s "
        f"({json.dumps(read)}); alone {r['alone_ms']:.3f} ms, with the "
        f"wrapper {r['ms']:.3f} ms, copy_ of the bound's bytes "
        f"{r['copy_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms; {L} lines; "
        f"its parts (ms a launch) {json.dumps(r['parts_ms'])}")
    del raw, work
    torch.cuda.empty_cache()
    return r


def parse_row(paths, parsed: dict) -> dict:
    """The kernels line's row of fasta_parse: its launches in every path
    (one per CLI run and per CMSBWT.transform of a path), its times on the
    500 Mchar collection file and, under ``primary`` and ``unwrapped``, on
    the primary's and on the 500 Mchar collection written one line a
    document."""
    big = parsed["500M"]
    keys = ("bytes", "sn", "lines", "ms", "alone_ms", "plain_ms", "copy_ms",
            "bound_ms", "read_s", "parts_ms")
    return {"name": "fasta_parse", "route": "cuda",
            "source": "cmsbwt_tpu_torch/kernels/csrc/fasta_parse.cu",
            "replaces": "cmsbwt_tpu/io/fasta.py:114",
            "launches": sum(c["fasta_parse"] for *_, c, _, _, _ in paths),
            "launches_by_run": [
                {"run": tag, "cli_runs": k, "launches": c["fasta_parse"]}
                for _, tag, k, c, _, _, _ in paths],
            "max_abs_err": max(r["err"] for r in parsed.values()),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            **{k: big[k] for k in ("alone_ms", "copy_ms", "bytes", "sn",
                                   "lines", "read_s", "parts_ms")},
            **{tag: {k: parsed[tag][k] for k in keys}
               for tag in ("primary", "unwrapped")}}


def sort_row(row, name, source, replaces, merge_cases, counted, keys):
    """The kernels line's row of a sort kernel: its 500 Mchar and primary
    merge cases, with its alone and copy_ times and the extra ``keys`` of
    the 500 Mchar case; radix_sort's also lists every call site's case at
    both shapes (``sites``)."""
    big = merge_cases["500M"][name]
    res = [big, merge_cases["primary"][name]]
    extra = {}
    if name + "_sites" in merge_cases["500M"]:
        extra["sites"] = {
            tag: {site: {k: r[k] for k in (
                "rows", "bits", "passes", "ms", "alone_ms", "plain_ms",
                "library_ms", "bound_ms", "passes_bound_ms", "err")}
                for site, r in cases[name + "_sites"].items()}
            for tag, cases in merge_cases.items()}
        res += [r for cases in merge_cases.values()
                for r in cases[name + "_sites"].values()]
    return row(name, source, replaces, res, big["library_ms"], counted,
               alone_ms=big["alone_ms"], copy_ms=big["copy_ms"],
               **{k: big[k] for k in keys},
               primary={k: merge_cases["primary"][name][k] for k in
                        ("ms", "alone_ms", "plain_ms", "library_ms",
                         "copy_ms", "bound_ms") + keys}, **extra)


def merge_row(row, name, source, replaces, merge_cases, also=()):
    """The kernels line's row of a merge kernel held on the 500 Mchar and
    the primary merge's inputs, with its alone and copy_ times at both;
    each of ``also`` (other cases of the same kernel) listed under its
    name at both shapes."""
    big, prim = merge_cases["500M"][name], merge_cases["primary"][name]
    keys = ("rows", "ms", "alone_ms", "plain_ms", "copy_ms", "bound_ms")
    extra = {a: {tag: {k: c[a][k] for k in keys}
                 for tag, c in merge_cases.items()} for a in also}
    return row(name, source, replaces,
               [big, prim] + [c[a] for c in merge_cases.values()
                              for a in also], None,
               alone_ms=big["alone_ms"], copy_ms=big["copy_ms"],
               rows=big["rows"], primary={k: prim[k] for k in keys},
               **extra)


def output_row(row, name, replaces, merge_cases):
    """The kernels line's row of a run_output.cu kernel on the 500 Mchar
    and the primary merge's runs, with its alone, copy_ and (bwt_expand)
    torch.repeat_interleave times at both."""
    big, prim = merge_cases["500M"][name], merge_cases["primary"][name]
    keys = ("rows", "sn", "ms", "alone_ms", "plain_ms", "library_ms",
            "copy_ms", "bound_ms") + (
                ("starts_alone_ms", "tiles_alone_ms")
                if name == "bwt_expand" else ())
    return row(name, "cmsbwt_tpu_torch/kernels/csrc/run_output.cu",
               replaces, [big, prim], big["library_ms"], alone_ms=big[
                   "alone_ms"], copy_ms=big["copy_ms"], rows=big["rows"],
               sn=big["sn"], primary={k: prim[k] for k in keys},
               **{k: big[k] for k in keys[8:]})


def main() -> int:
    started = time.perf_counter()
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} "
        f"device_name={kind} count={torch.cuda.device_count()}")

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    os.environ.setdefault("CMSBWT_NATIVE_DIR", str(WORK / "native"))
    os.environ["CMSBWT_INDEX_CACHE"] = str(WORK / "index_cache")
    try:
        log(f"host: {host_cpu(WORK)}")
        return run_phases(card, kind, started)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def run_phases(card: str, kind: str, started: float) -> int:
    from cmsbwt_tpu_torch import cli, kernels
    from cmsbwt_tpu_torch.engine import device_merge as dmg
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index import device as idx
    from cmsbwt_tpu_torch.ops import fill
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    from cmsbwt_tpu_torch.ops import sort as srt
    from cmsbwt_tpu_torch.utils.buckets import bucket_size
    # the plain versions' call counts
    from cmsbwt_tpu_torch.io import fasta
    from cmsbwt_tpu_torch.io import output as out_mod
    from cmsbwt_tpu_torch.io import parse
    PLAIN_CALLS = (js.REFERENCE_CALLS, md.REFERENCE_CALLS,
                   mj.REFERENCE_CALLS, fill.REFERENCE_CALLS,
                   dmg.REFERENCE_CALLS, srt.REFERENCE_CALLS,
                   idx.REFERENCE_CALLS, out_mod.REFERENCE_CALLS,
                   parse.REFERENCE_CALLS)
    # the host parses and SX's trips between host and card
    SX_COUNTS = {"host_parses": fasta.HOST_PARSES,
                 "sx_downloads": fasta.SX_DOWNLOADS,
                 "sx_uploads": mj.SX_UPLOADS}

    # phase 2: build
    log(f"phase 2 starts at {time.perf_counter() - started:.1f} s")
    kernels.load()
    log(f"build: {kernels.BUILD['seconds']:.2f} s -> {kernels.BUILD['path']}")
    entry = ""
    for line in kernels.BUILD["log"].splitlines():
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)", line)
        if "Compiling entry function" in line and m:   # mangled name
            at = m.end()
            entry = line[at:at + int(m.group(1))]
        elif "registers" in line or "spill" in line:
            log(f"build: {entry}: {line.strip()}")

    # phase 3: the scan kernel against its plain version
    log(f"phase 3 starts at {time.perf_counter() - started:.1f} s")
    k200k = write_workload(WORK / "k200k", 1, 200_000, 8, 0.01)
    kernel_case("200Kbp_x8_snp1%", k200k, expect_viol=False)
    kernel_case("200Kbp_x8_snp1%_cap8", k200k, cap=8, expect_viol=True)
    sep_lst = write_workload(WORK / "ksep", 2, 5_000, 2000, 0.03, 7)
    kernel_case("separator_dense", sep_lst)
    kernel_case("identical_copies",
                write_workload(WORK / "kid", 3, 100_000, 6, 0.0))
    kernel_case("short_reference_n127",
                write_short_reference(WORK / "kshort", 4))
    lst = write_workload(WORK / "primary", 42, 2_000_000, 10, 0.01)
    prim = kernel_case("primary_2Mbp_x10", lst, sweep=(32768, 131072))

    # phase 4: the dense kernels against their plain versions
    log(f"phase 4 starts at {time.perf_counter() - started:.1f} s")
    dense, joint = {}, {}
    for name, klst in (
            ("primary_2Mbp_x10", lst),
            ("200Kbp_x8_Nrun", write_workload(WORK / "knrun", 5, 200_000, 8,
                                              0.01, n_run=64)),
            ("separator_dense", sep_lst)):
        xk, ck = load_inputs(str(klst))
        # the joint sort's kernels on the primary scan's own calls
        with JointTimers("primary") if name.startswith("primary") \
                else contextlib.nullcontext() as jt:
            for k, r in dense_kernel_case(name, xk, ck.sx).items():
                dense.setdefault(k, []).append(r)
        if jt is not None:
            joint["primary"] = jt
        del xk, ck
        torch.cuda.empty_cache()
    log(f"lcp_lift at primary: rho rows, lmax from the stats "
        f"{dense['lcp_lift'][0]['ms']:.3f} ms; rho_pad rows, lmax read back "
        f"{dense['lcp_lift_rho_pad'][0]['ms']:.3f} ms")
    nb_cases = neighbor_cases()
    torch.cuda.empty_cache()
    oracle = reference_outputs(lst)

    # phase 5: the jump slice through the CLI, kernel launches counted
    log(f"phase 5 starts at {time.perf_counter() - started:.1f} s")
    # (backend, tag, CLI runs, launch counts, block tries, merge engine,
    # the kernels the path launches)
    paths = []

    # the device merges with exact pairs, each of which launches
    # tail_exact_credit once
    exact_merges = [0]
    tail_exact = dmg.tail_exact_dev

    def counted_tail_exact(*a, **kw):
        exact_merges[0] += 1
        return tail_exact(*a, **kw)
    dmg.tail_exact_dev = counted_tail_exact
    # the head strings' compacted calls (index/device.comp_rank, one a
    # round, and comp_tail, one for the rounds left), each of which
    # launches dense_rank_comp once
    comp_steps = [0]

    def counted(fn):
        def call(*a, **kw):
            comp_steps[0] += 1
            return fn(*a, **kw)
        return call
    idx.comp_rank, idx.comp_tail = counted(idx.comp_rank), \
        counted(idx.comp_tail)

    def reset_counts():
        kernels.reset_launch_counts()
        exact_merges[0] = comp_steps[0] = dmg.RUN_DOWNLOADS[0] = 0
        for c in SX_COUNTS.values():
            c[0] = 0
        for calls in PLAIN_CALLS:
            for k in calls:
                calls[k] = 0

    def check_counts(backend, tag, runs, engine, tries=None, scanned=True,
                     rle_writes=0, plain_writes=0, parsed=True):
        """The launch counts since reset_counts(): each kernel of the
        backend's scan (unless ``scanned`` is False: the scan was skipped)
        and of the merge ``engine`` launched, no other, no plain version;
        a device merge's writer launched once per output it wrote
        (``rle_writes`` .rl_bwt, ``plain_writes`` .bwt) and no run array
        downloaded; the collection parsed on the card by one fasta_parse
        launch per run (``parsed``: the path parsed its file) and no host
        parse; on the jump route SX neither uploaded nor downloaded;
        recorded as a path."""
        writes = {"rle_pack": rle_writes, "bwt_expand": plain_writes}
        mine = tuple(k for k in dict.fromkeys(
            (ROUTE_KERNELS[backend] if scanned else ())
            + MERGE_KERNELS[engine])
            if (k != "tail_exact_credit" or exact_merges[0])
            and (k != "dense_rank_comp" or comp_steps[0])
            and writes.get(k, 1))
        may = mine + ("fasta_parse",) + tuple(
            k for e in (backend, *engine.split("/"))
            for k in MAY_LAUNCH.get(e, ()))
        counts = dict(kernels.LAUNCHES)
        plain = {k: v for calls in PLAIN_CALLS for k, v in calls.items()}
        log(f"slice[{tag}]: kernel launches {counts}; plain calls {plain}"
            + (f"; block tries {tries}" if tries is not None else "")
            + f"; merge {engine}"
            + (f" ({exact_merges[0]} with exact pairs)"
               if engine == "device" else "")
            + f"; {comp_steps[0]} compacted head-string steps; "
            + json.dumps({k: c[0] for k, c in SX_COUNTS.items()}))
        if counts["fasta_parse"] != (runs if parsed else 0) \
                or SX_COUNTS["host_parses"][0]:
            fail(f"{tag}: fasta_parse launched {counts['fasta_parse']} "
                 f"times over {runs} runs and the host parsed "
                 f"{SX_COUNTS['host_parses'][0]} times (expected "
                 f"{runs if parsed else 0} and none)")
        if backend == "jump" and (SX_COUNTS["sx_uploads"][0]
                                  or SX_COUNTS["sx_downloads"][0]):
            fail(f"{tag}: the jump route moved SX between host and card "
                 + json.dumps({k: c[0] for k, c in SX_COUNTS.items()}))
        if any(plain.values()):
            fail(f"{tag}: a plain version ran on the card's main path")
        if any(counts[k] < 1 for k in mine) or any(
                c for k, c in counts.items() if k not in may):
            fail(f"{tag}: kernel launches {counts}, expected "
                 f"{list(mine) or 'none'}")
        if tries is not None and not (counts["lcp_lift"]
                                      == counts["dense_neighbors"] == tries):
            fail(f"{tag}: the dense kernels did not carry every block try "
                 f"({tries} tries)")
        if counts["tail_exact_credit"] != exact_merges[0]:
            fail(f"{tag}: tail_exact_credit did not carry every merge with "
                 f"exact pairs ({exact_merges[0]})")
        if counts["dense_rank_comp"] != comp_steps[0]:
            fail(f"{tag}: dense_rank_comp did not carry every compacted "
                 f"head-string step ({comp_steps[0]})")
        if engine == "device" and (
                any(counts[k] != w for k, w in writes.items())
                or dmg.RUN_DOWNLOADS[0]):
            fail(f"{tag}: the device merge's writer launched rle_pack "
                 f"{counts['rle_pack']} and bwt_expand "
                 f"{counts['bwt_expand']} times for {rle_writes} .rl_bwt "
                 f"and {plain_writes} .bwt, and downloaded "
                 f"{dmg.RUN_DOWNLOADS[0]} run lists")
        paths.append((backend, tag, runs, counts, tries, engine, mine))
        return counts

    def run_cli(backend: str | None, tag: str, extra=(),
                formats=(False, True), inp=lst, want=oracle, blocks=None,
                merge="device", scanned=True, want_merge=None) -> dict:
        """The CLI on ``inp`` in each format with ``--merge-backend
        merge``, bytes held to ``want`` (the reference tool's) unless it is
        None; the kernel launches and plain calls counted from 0 over these
        runs: each kernel of the route's scan (ROUTE_KERNELS; none with
        ``scanned`` False) and merge engine (MERGE_KERNELS) launched, and
        no other. ``backend`` None passes no
        --backend (the default, auto): the backend each .log names is the
        route. The merge engine that ran, read from each .log, must be
        ``want_merge`` (default: the host merge for --merge-backend host
        and the device, native and host backends, else the device
        merge)."""
        reset_counts()
        tries0 = len(blocks.tries) if blocks else 0
        engines, ran = set(), set()
        for rle in formats:
            out = WORK / f"port_{tag}{'_rle' if rle else ''}"
            argv = [str(inp), "-o", str(out), "--device", "cuda",
                    "--merge-backend", merge, *extra] + (
                        ["--backend", backend] if backend else []) + (
                        ["-r"] if rle else [])
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                fail(f"cli ({tag}) returned non-zero")
            wall = time.perf_counter() - t0
            fmt = "rle" if rle else "plain"
            text = out.with_suffix(".log").read_text()
            engines.add("host" if "\nhead_fixup: " in text else
                        "sharded" if "\nmerge_sharded: " in text else
                        "device")
            ran.add(re.search(r"^backend: (\w+)$", text, re.M).group(1))
            if backend == "native" and "scan_engine: native" not in text:
                fail(f"{tag}: the .log does not name the native scan engine")
            phases = json.dumps(phases_from_log(out.with_suffix(".log")))
            if "\nmerge_device: " in text:
                # the device merge's writer: R, bytes, the kernel and the
                # staging copy
                phases += " write " + json.dumps(out_mod.LAST_WRITE)
                out_mod.LAST_WRITE.clear()
            if want is None:
                log(f"slice[{tag},{fmt}]: wall {wall:.2f} s; phases ms "
                    + phases)
                continue
            got = out.with_suffix(".rl_bwt" if rle else ".bwt").read_bytes()
            if got != want[rle]:
                fail(f"{tag}: {'rl_bwt' if rle else 'bwt'} differs from "
                     f"the reference tool's ({len(got)} vs "
                     f"{len(want[rle])} bytes)")
            log(f"slice[{tag},{fmt}]: bytes equal to the reference tool's "
                f"({len(got)} bytes); wall {wall:.2f} s; phases ms "
                + phases)
        if len(ran) != 1 or (backend and ran != {backend}):
            fail(f"{tag}: the .log names the backends {sorted(ran)}")
        backend = ran.pop()
        if want_merge is None:
            want_merge = ("host" if merge == "host" or backend in (
                "device", "native", "host") else
                "sharded" if merge == "sharded" else "device")
        engine = "/".join(sorted(engines))
        if engine != want_merge:
            fail(f"{tag}: the {engine} merge ran, expected {want_merge}")
        dev = engine == "device"
        return check_counts(
            backend, tag, len(formats), engine,
            len(blocks.tries) - tries0 if blocks else None, scanned,
            rle_writes=dev * sum(formats),
            plain_writes=dev * (len(formats) - sum(formats)))

    run_cli("jump", "jump")

    # heads at two lane counts against the native scan
    x_aug, coll = load_inputs(str(lst))
    t0 = time.perf_counter()
    nat = native_heads(x_aug, coll)
    log(f"oracle: native scan h={len(nat[0])} "
        f"({time.perf_counter() - t0:.2f} s)")

    def check_heads(res, what):
        h = res.h
        got = [a[:h].cpu().numpy() if torch.is_tensor(a) else a[:h]
               for a in (res.head_t, res.head_pos, res.head_len,
                         res.head_smaller, res.head_char)]
        if h != len(nat[0]) or any(
                not np.array_equal(g.astype(w.dtype), w)
                for g, w in zip(got, nat)):
            fail(f"heads of {what} differ from the native scan "
                 f"(h={h} vs {len(nat[0])})")
        log(f"heads[{what}]: h={h} equal to the native scan")

    for lanes in (4096, 32768):
        check_heads(mj.ms_jump_heads(x_aug, coll.sx, "cuda", lanes=lanes),
                    f"jump lanes={lanes}")

    # the host merge against the device merge on the jump scan's heads
    from cmsbwt_tpu_torch.engine.device_merge import download_runs, \
        merge_heads_device_resident
    jres = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
    times = {"device": [], "host": []}
    for turn in ("device", "host", "host", "device"):
        if turn == "host":
            res, stages, ms = host_merge(x_aug, jres, coll.d, coll.sn, False)
            host = (res.run_len, res.run_char, res.counter)
            log(f"merge[primary]: host {ms:.1f} ms (h={jres.h}); stages ms "
                + json.dumps(stages))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev = merge_heads_device_resident(jres, coll.d, False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            dev = (*download_runs(*dev[:2]), dev[2])
            log(f"merge[primary]: device {ms:.1f} ms")
        times[turn].append(ms)
    want_runs = normalized_runs(host[0], host[1])
    if not (np.array_equal(dev[0], want_runs[0])
            and np.array_equal(dev[1], want_runs[1])
            and np.array_equal(dev[2], host[2])):
        fail("the host merge's (run_len, run_char, counter) differ from the "
             "device merge's at primary")
    log(f"merge[primary]: host and device (run_len, run_char, counter) "
        f"equal ({len(dev[0])} runs, {len(host[0])} before normalising); "
        f"host ms {times['host']}, device ms {times['device']}")
    # phase 11's primary case: the merge kernels on the inputs this
    # merge gives them, and the jump scan's sorts (its index built anew)
    with SortCapture() as scan_sorts, IndexRankCapture() as index_rank:
        mj.ms_jump_heads(x_aug, coll.sx, "cuda")
    with MergeCapture() as cap:
        again = merge_heads_device_resident(jres, coll.d, False)
    again = (*download_runs(*again[:2]), again[2])
    if not all(np.array_equal(a, b) for a, b in zip(again, dev)):
        fail("the device merge's runs differ between two runs")
    merge_cases = {"primary": merge_kernel_cases("primary", cap,
                                                 scan_sorts, index_rank)}
    del jres, host, dev, want_runs, again, cap, scan_sorts, index_rank

    # phase 6: the dense slice through the CLI, kernel launches counted
    log(f"phase 6 starts at {time.perf_counter() - started:.1f} s")
    run_cli("dense", "dense")
    os.environ["CMSBWT_PROFILE"] = "1"
    log("dense stages (device-synced marks, stderr):")
    try:
        check_heads(md.ms_dense_heads_on_device(x_aug, coll.sx, "cuda"),
                    "dense")
    finally:
        del os.environ["CMSBWT_PROFILE"]
    sys.stderr.flush()

    # the routes that end in the host merge, at primary
    run_cli("device", "device", merge="auto")
    run_cli("native", "native", merge="auto")
    run_cli("jump", "jump_host", merge="host")
    run_cli("dense", "dense_host", merge="host")
    os.environ["CMSBWT_SN_BOUND"] = "4000000"
    try:
        with BlockLog(md) as snb:
            run_cli("dense", "dense_sn_bound", merge="auto", blocks=snb,
                    want_merge="host")
    finally:
        del os.environ["CMSBWT_SN_BOUND"]
    starts = sorted({t["b0"] for t in snb.tries})
    log(f"sn_bound[primary, CMSBWT_SN_BOUND=4000000]: {len(snb.tries)} "
        f"block tries over 2 runs, blocks at {starts}")
    if starts != list(range(0, coll.sn, 2_000_000)):
        fail("the int64 route did not scan 2 M-char blocks")
    torch.cuda.empty_cache()
    for k, r in block_kernel_case("primary_sn_bound_blocks", x_aug, coll.sx,
                                  snb.tries[0]).items():
        dense[k].append(r)
    small = write_workload(WORK / "small", 7, 30_000, 8, 0.01)
    run_cli("host", "host_small", merge="auto", inp=small,
            want=reference_outputs(small, "ref_small"))
    torch.cuda.empty_cache()

    # phase 7: the blocked dense scan at the primary shape
    log(f"phase 7 starts at {time.perf_counter() - started:.1f} s")
    bc = 4 << 20
    with BlockLog(md) as blk:
        run_cli("dense", "dense_blocked", ["--block-chars", str(bc)],
                blocks=blk)
    log(f"blocked[primary]: block_chars={bc} tries per run "
        f"{len(blk.tries) // 2} retries {blk.retries}; blocks "
        + json.dumps(blk.tries[:len(blk.tries) // 2]))
    check_heads(md.ms_dense_heads_blocked_on_device(x_aug, coll.sx, "cuda",
                                                    bc), "dense blocked")
    torch.cuda.empty_cache()
    for k, r in block_kernel_case("primary_4Mi_blocks", x_aug, coll.sx,
                                  blk.tries[0]).items():
        dense[k].append(r)
    torch.cuda.empty_cache()
    os.environ["CMSBWT_HBM_GB"] = "2"
    try:
        choice = md.dense_block_chars(len(x_aug), coll.sn,
                                      md.dense_budget("cuda"))
        log(f"guard: CMSBWT_HBM_GB=2 at primary (sn={coll.sn}) -> "
            f"block_chars={choice}")
        with BlockLog(md) as guard:
            run_cli("dense", "dense_guard", formats=(False,), blocks=guard)
    finally:
        del os.environ["CMSBWT_HBM_GB"]
    starts = sorted({t["b0"] for t in guard.tries})
    if choice is None or starts != list(range(0, coll.sn, choice)):
        fail(f"the guard's blocks {starts} are not those of its choice "
             f"{choice}")
    x2, c2 = load_inputs(str(k200k))
    with BlockLog(md) as tiny:
        res = md.ms_dense_heads_blocked_on_device(x2, c2.sx, "cuda",
                                                  1 << 16, 4)
    ref = md.ms_dense_heads_on_device(x2, c2.sx, "cuda")
    log(f"retry[200Kbp_x8, block_chars=65536, ctx=4]: "
        f"{len(tiny.tries)} tries, {tiny.retries} retries, h={res.h}")
    if not tiny.retries:
        fail("the 4-char context did not make any block retry")
    if not same_heads(res, ref) or not all(
            torch.equal(getattr(res, k), getattr(ref, k))
            for k in ("ref_sa", "ref_isa", "ref_bwt")):
        fail("the retried blocks' heads differ from the unblocked scan's")
    del res, ref, x2, c2
    ck = ["--block-chars", str(bc), "--checkpoint-dir", str(WORK / "ckpt")]
    with BlockLog(md) as ck1:
        run_cli("dense", "dense_ckpt_first", ck, formats=(False,),
                blocks=ck1)
    saved = sorted(p.name.split(".")[0] for p in (WORK / "ckpt").iterdir())
    log(f"checkpoint: saved {saved}")
    if "dense_heads" not in saved:
        fail("the checkpointed run saved no dense_heads bundle")
    with BlockLog(md) as ck2:
        run_cli("dense", "dense_ckpt_again", ck, formats=(False,),
                blocks=ck2, scanned=False)
    if ck2.tries or not ck1.tries:
        fail("the checkpointed rerun scanned again")
    torch.cuda.empty_cache()

    # phase 8: 500 Mchars, above the card, blocks chosen by the guard
    log(f"phase 8 starts at {time.perf_counter() - started:.1f} s")
    t0 = time.perf_counter()
    big = write_workload(WORK / "ecoli_rle", 42, 5_000_000, BIG_DOCS, 0.01)
    log(f"big: wrote 5 Mbp x {BIG_DOCS} docs in "
        f"{time.perf_counter() - t0:.1f} s")
    kept = {}
    scan = md.ms_dense_heads_blocked_on_device

    def keep(*a, **kw):
        kept["res"] = scan(*a, **kw)
        return kept["res"]

    md.ms_dense_heads_blocked_on_device = keep
    os.environ["CMSBWT_PROFILE"] = "1"
    log("big: per-block stage marks (device-synced, stderr)")
    try:
        with BlockLog(md) as bl:
            t0 = time.perf_counter()
            run_cli("dense", "dense_500M", ["--no-rle-quirk"],
                    formats=(True,), inp=big, want=None, blocks=bl)
            wall = time.perf_counter() - t0
    finally:
        del os.environ["CMSBWT_PROFILE"]
        md.ms_dense_heads_blocked_on_device = scan
    sys.stderr.flush()
    xb, cb = load_inputs(str(big))
    unblocked = md.DENSE_BYTES_PER_CHAR * (bucket_size(len(xb))
                                           + bucket_size(cb.sn + 1))
    log(f"big: n={len(xb)} sn={cb.sn} unblocked need {unblocked} B; "
        f"{len(bl.tries)} block tries, {bl.retries} retries; wall "
        f"{wall:.2f} s; run peak {bl.run_peak} B (outside the blocks: "
        f"{bl.gap_peak} B); blocks "
        + json.dumps(bl.tries))
    if "res" not in kept or len(bl.tries) < 2:
        fail("the 500 Mchar run did not go through guard-chosen blocks")
    # the merge's ceiling (merge_fits) must count at least what the merge
    # took: the peak outside the blocks is the merge's and the writer's
    log(f"big: peak outside the blocks {bl.gap_peak / cb.sn:.1f} B per "
        f"collection char (the merge's ceiling counts "
        f"{dmg.MERGE_BYTES_PER_CHAR})")
    if bl.gap_peak > dmg.MERGE_BYTES_PER_CHAR * cb.sn:
        fail("the device merge took more than MERGE_BYTES_PER_CHAR per "
             "collection char")
    dres = kept.pop("res")
    t0 = time.perf_counter()
    with SortCapture() as scan_sorts, IndexRankCapture() as index_rank:
        jres = mj.ms_jump_heads(xb, cb.sx, "cuda")
    log(f"big: jump heads h={jres.h} ({time.perf_counter() - t0:.2f} s); "
        f"blocked dense heads h={dres.h} irreducible={dres.irreducible}")
    if not same_heads(dres, jres):
        fail("the 500 Mchar blocked heads differ from the jump scan's")
    del jres
    torch.cuda.empty_cache()
    # phase 11's 500 Mchar case, while its inputs are on the card: the
    # merge kernels on the inputs the merge of these heads gives them
    with MergeCapture() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merge_heads_device_resident(dres, cb.d, False, want_counter=False)
        torch.cuda.synchronize()
        log(f"big: the device merge of the same heads again "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    merge_cases["500M"] = merge_kernel_cases("500M", cap, scan_sorts,
                                             index_rank)
    del cap, scan_sorts, index_rank
    torch.cuda.empty_cache()
    # the host merge on the same heads, against the device merge's output
    from cmsbwt_tpu_torch.io import native
    res, stages, ms = host_merge(xb, dres, cb.d, cb.sn, False)
    del dres
    torch.cuda.empty_cache()
    host_out = WORK / "host_merge_500M.rl_bwt"
    if not native.write_rle_native(str(host_out), res.run_len, res.run_char):
        fail("the native RLE writer could not be built")
    del res
    same = filecmp.cmp(host_out, WORK / "port_dense_500M_rle.rl_bwt",
                       shallow=False)
    log(f"big: host merge {ms:.1f} ms; stages ms {json.dumps(stages)}; "
        f".rl_bwt equal to the device merge's: {same}")
    if not same:
        fail("the 500 Mchar host merge's .rl_bwt differs from the device "
             "merge's")
    host_out.unlink()
    with JointTimers("500M", every=False) as joint["500M"]:
        for k, r in block_kernel_case("500M", xb, cb.sx,
                                      bl.tries[0]).items():
            dense[k].append(r)
    torch.cuda.empty_cache()
    hist = rle_histogram(WORK / "port_dense_500M_rle.rl_bwt")
    want_hist = np.bincount(cb.sx, minlength=256)
    if int(hist.sum()) != cb.sn or not np.array_equal(hist, want_hist):
        fail(f"the 500 Mchar .rl_bwt decodes to {int(hist.sum())} chars "
             f"(sn {cb.sn}) or another byte histogram")
    log(f"big: .rl_bwt decodes to sn={cb.sn} chars with the collection's "
        "byte histogram")
    del xb, cb

    # phase 9: auto, the model API, ms_dense and --parallel
    log(f"phase 9 starts at {time.perf_counter() - started:.1f} s")
    phase9(run_cli, check_counts, reset_counts, check_heads, paths, lst,
           oracle, k200k, x_aug, coll)

    # phase 10: the mesh modules on the card's ranks
    log(f"phase 10 starts at {time.perf_counter() - started:.1f} s")
    phase10(run_cli, check_counts, reset_counts, lst, x_aug, coll)

    # phase 11: the device merge's kernels against their plain versions
    log(f"phase 11 starts at {time.perf_counter() - started:.1f} s")
    # (their primary and 500 Mchar cases ran in phases 5 and 8)
    t11 = time.perf_counter()
    fills = fill_cases()
    bucket_sums_cases()
    sort_cases()
    rank_cases()
    output_cases()
    for name in ("running_fill", "tail_good_join", "tail_exact_credit",
                 "bucket_sums", "run_merge", "radix_sort", "compact",
                 "dense_rank", "dense_rank_comp", "pair_expand", "rle_pack",
                 "bwt_expand"):
        for tag, res in merge_cases.items():
            r = res[name]
            log(f"merge kernel {name}[{tag}]: {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
    log(f"merge kernels: phase 11 took {time.perf_counter() - t11:.1f} s")

    # phase 12: the collection parse against its plain version
    log(f"phase 12 starts at {time.perf_counter() - started:.1f} s")
    t12 = time.perf_counter()
    parse_cases()
    parsed = {tag: parse_case(tag, WORK / d / "coll.fa")
              for tag, d in (("primary", "primary"), ("500M", "ecoli_rle"))}
    # the 500 Mchar collection again, one line a document
    t0 = time.perf_counter()
    write_workload(WORK / "unwrapped", 42, 5_000_000, BIG_DOCS, 0.01,
                   width=0)
    log(f"parse: wrote the unwrapped collection in "
        f"{time.perf_counter() - t0:.1f} s")
    parsed["unwrapped"] = parse_case("unwrapped",
                                     WORK / "unwrapped" / "coll.fa")
    shutil.rmtree(WORK / "unwrapped")
    log(f"parse: phase 12 took {time.perf_counter() - t12:.1f} s")

    def row(name, source, replaces, res, library_ms=None, counted=None,
            **extra):
        # every run that launches this kernel (``counted``: the launch
        # counts it sums, by default its own), and the runs that launch
        # none (their 0 shown)
        counted = counted or (name,)
        runs = [(tag, k, sum(c[x] for x in counted), t, e)
                for _, tag, k, c, t, e, mine in paths
                if any(x in mine for x in counted) or not mine]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(c for _, _, c, _, _ in runs),
                "launches_by_run": [
                    {"run": tag, "cli_runs": k, "launches": c,
                     "block_tries": t, "merge": e}
                    for tag, k, c, t, e in runs],
                "max_abs_err": max(r["err"] for r in res),
                "ms": res[0]["ms"], "plain_ms": res[0]["plain_ms"],
                "bound_ms": res[0]["bound_ms"], "bound_by": "bytes",
                "library_ms": library_ms, **extra}

    # the joint sort's sorts beside the merge's and the jump scan's
    for tag, jt in joint.items():
        merge_cases[tag]["radix_sort_sites"].update(
            {f"{site} (dense)": r for site, r in jt.sorts.items()})
        log(f"joint sort[{tag}]: held and timed in {jt.seconds:.1f} s; "
            f"sort sites {sorted(jt.sorts)}; seed "
            f"{jt.seed['seed']} {jt.seed['ms']:.3f} ms; rounds "
            + json.dumps([(r["kind"], r["k"], r["rows"], round(r["ms"], 3))
                          for r in jt.rounds]))
    rounds = joint["500M"].rounds + joint["primary"].rounds
    log(f"smoke: every phase passed in "
        f"{time.perf_counter() - started:.1f} s")
    csrc = "cmsbwt_tpu_torch/kernels/csrc/"
    log(json.dumps({"kernels": [
        row("ms_jump_scan", csrc + "ms_jump_scan.cu",
            "docs/retired_pallas_scan.py:525", [prim]),
        row("lcp_lift", csrc + "lcp_lift.cu",
            "cmsbwt_tpu/ops/joint_sa.py:429",
            dense["lcp_lift"] + dense["lcp_lift_rho_pad"]),
        row("dense_neighbors", csrc + "dense_neighbors.cu",
            "cmsbwt_tpu/ops/ms_dense.py:366",
            dense["dense_neighbors"] + nb_cases),
        row("running_fill", csrc + "running_fill.cu",
            "cmsbwt_tpu/engine/device_merge.py:57",
            fills + [c["running_fill"] for c in merge_cases.values()]
            + [jt.fill for jt in joint.values()],
            fills[0]["library_ms"], alone_ms=fills[0]["alone_ms"],
            copy_ms=fills[0]["copy_ms"],
            flag_fill={tag: {k: jt.fill[k] for k in (
                "ms", "alone_ms", "plain_ms", "library_ms", "bound_ms")}
                for tag, jt in joint.items()}),
        row("tail_good_join", csrc + "tail_good_join.cu",
            "cmsbwt_tpu/engine/device_merge.py:426",
            [merge_cases["500M"]["tail_good_join"],
             merge_cases["primary"]["tail_good_join"]]),
        row("tail_exact_credit", csrc + "tail_exact_credit.cu",
            "cmsbwt_tpu/engine/device_merge.py:543",
            [merge_cases["500M"]["tail_exact_credit"],
             merge_cases["primary"]["tail_exact_credit"]]),
        row("bucket_sums", csrc + "run_merge.cu",
            "cmsbwt_tpu/engine/device_merge.py:596",
            [merge_cases["500M"]["bucket_sums"],
             merge_cases["primary"]["bucket_sums"]],
            merge_cases["500M"]["bucket_sums"]["library_ms"],
            alone_ms=merge_cases["500M"]["bucket_sums"]["alone_ms"],
            copy_ms=merge_cases["500M"]["bucket_sums"]["copy_ms"]),
        row("run_merge", csrc + "run_merge.cu",
            "cmsbwt_tpu/engine/device_merge.py:694",
            [merge_cases["500M"]["run_merge"],
             merge_cases["primary"]["run_merge"]]),
        sort_row(row, "radix_sort", csrc + "radix_sort.cu",
                 "cmsbwt_tpu/engine/device_merge.py:424", merge_cases,
                 ("radix_hist", "radix_pass"), ("passes_bound_ms",)),
        sort_row(row, "compact", csrc + "compact.cu",
                 "cmsbwt_tpu/engine/device_merge.py:488", merge_cases,
                 ("compact",), ()),
        merge_row(row, "dense_rank", csrc + "sa_round.cu",
                  "cmsbwt_tpu/index/device.py:24", merge_cases,
                  ("dense_rank_index",)),
        merge_row(row, "dense_rank_comp", csrc + "sa_round.cu",
                  "cmsbwt_tpu/index/device.py:80", merge_cases,
                  ("dense_rank_comp_tail",)),
        merge_row(row, "pair_expand", csrc + "pair_expand.cu",
                  "cmsbwt_tpu/engine/device_merge.py:359", merge_cases),
        output_row(row, "rle_pack", "cmsbwt_tpu/engine/device_merge.py:717",
                   merge_cases),
        output_row(row, "bwt_expand", "cmsbwt_tpu/engine/merge.py:171",
                   merge_cases),
        parse_row(paths, parsed),
        row("sa_round", csrc + "sa_round.cu",
            "cmsbwt_tpu/ops/joint_sa.py:244", rounds
            + [jt.seed for jt in joint.values()],
            primary={k: joint["primary"].rounds[0][k]
                     for k in ("ms", "plain_ms", "bound_ms")},
            seed={tag: {k: jt.seed[k] for k in (
                "seed", "rows", "ms", "plain_ms", "bound_ms", "err")}
                for tag, jt in joint.items()},
            rounds={tag: [{k: r[k] for k in (
                "kind", "k", "rows", "m", "ms", "plain_ms", "bound_ms",
                "err")} for r in jt.rounds] for tag, jt in joint.items()})
    ]}))
    log(f"device: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
