"""Where radix_sort.cu spends its time, on one CUDA card.

    python3 tools/radix_variants.py [--rows-scale F]
    python3 tools/radix_variants.py --sites [primary,500M] [--sorters S,...]
        [--turns T]

Both modes build their sorters first, each with the port's nvcc flags by
its own nvcc process, all at once, and print each pass kernel's
registers and spills (nvcc -Xptxas=-v) and its blocks an SM (CUDA's
occupancy calculator). The sorters:

* ``committed`` — this tree's kernels/csrc/radix_sort.cu as it is (early
  counts, the one-digit path, a shared atomic a row for every count, TMA
  bulk loads, a look-back reading 4 tiles' words at once; 6144-row tiles:
  512 threads x 12 rows for passes staging u64 words, 256 x 24 for u32);
* variants of it, text-edited (VARIANTS; each edit's text must occur in
  radix_sort.cu exactly once): ``no_early`` (a tile's counts published
  after its ranking), ``no_one_digit`` (one-digit tiles ranked like the
  others), ``agg_counts`` (the next pass's counts aggregated by a vote a
  warp round), ``vote_counts`` / ``match_counts`` / ``ballot_counts``
  (the early counts and radix_hist's aggregated by a vote, by
  __match_any_sync, by a ballot per digit bit), ``hist_all``
  (radix_hist counts every pass's digits, the passes none),
  ``thread_loads`` (per-thread cp.async copies in place of the bulk
  copies and their mbarrier), ``unroll1`` (the item loops not unrolled);
  or built with other -D settings: ``lb2`` / ``lb8`` (RS_LB_BATCH),
  ``hist_rows4_b4`` (RS_HIST_ROWS, RS_HIST_BLOCKS), and tile shapes x
  blocks an SM: ``all_256x24`` and
  ``all_512x12`` (one shape for both word widths), ``tile3072``,
  ``tile4096``, ``tile8192`` (RS_THREADS, RS_ITEMS, RS_MIN_BLOCKS and
  their u32 twins RS_THREADS32, RS_ITEMS32, RS_MIN_BLOCKS32);
* ``late_counts`` — the design radix_sort.cu replaced
  (tools/radix_sort_late_counts.cu: counts published after the ranking,
  words staged in shared memory, a shared atomic a row for the next
  pass's counts, 3072-row tiles), with its own wrapper (LateSorter: one C
  call a pass).

Every sorter's permutation and values are held to
ops/sort._stable_argsort_reference (exact) before it is timed.

The default mode times every sorter on synthetic keys made on the card
from seed 12, each shaped like one of the device merge's or the jump
scan's sorts at 500 Mchars (SYNTHETIC; --rows-scale shrinks them): the
join (key1 int32 of 23 bits, a fifth of it its pad, key2f int64 of 47
bits, both uniform), runs_emit's lanes (one int32 key of 28 bits, five
groups each a valid run then a run of pads) and the jump scan's
candidates (4096 lanes x cap slots, each lane's records rising through
its own span of the text, the slots past its count pads). For each: the
whole sort as the wrapper runs it (CUDA events around 3 sorts back to
back, two rounds), and the last sort step by step (an event after each
launch: the set-up before radix_hist, radix_hist, each pass).

The sites mode runs the jump scan and one device merge at each shape
(primary: 2 Mbp x 10 docs at 1% SNP; 500M: 5 Mbp x 100 docs; the
chip_smoke workloads) and keeps every sort's keys by call site
(chip_smoke.SortCapture: the merge's sorts, and the jump scan's: one
round of the reference index's doubling, the candidates; the scan's
named "(jump scan)"). For each site: rows, widths, passes, valid share;
torch.sort passes (chip_smoke.torch_lexsort); the floor and passes byte
bounds (chip_smoke.sort_bytes); then each sorter of --sorters (default
committed,late_counts) in --turns turns (default 2: the first, the
second, the second, the first; each further turn reverses the order): the sort as the wrapper runs it (after one warm sort, as
torch.sort is timed), alone (scratch made beforehand), the wrapper's
host time (host clock around the call, no sync) over the step count,
each step, and each step again on the same keys with every pad replaced
by a uniform word of the key's width (the skew's cost apart from the
rest). Ends with a ``sites summary {json}`` line.

Prints the card's name and power limit first. Works in
_profile_work/radix_variants (gitignored) and deletes it. Imports nothing
of JAX (chip_smoke's import hook refuses it)."""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (also blocks JAX imports)
from cmsbwt_tpu_torch import kernels as K  # noqa: E402
from cmsbwt_tpu_torch.ops import sort as S  # noqa: E402

WORK = ROOT / "_profile_work" / "radix_variants"
LATE_SRC = ROOT / "tools" / "radix_sort_late_counts.cu"
# text edits of this tree's radix_sort.cu: (its text, the variant's)
NO_EARLY = [
    ("""      st_word(states + (long long)t * BINS + d,
              digit_word(a.pass, t == 0 ? LB_INCL : LB_AGG, run));
      if (run == unsigned(cnt)) s_one = d;""",
     "      if (run == unsigned(cnt)) s_one = d;"),
    ("      unsigned prefix = 0;\n      if (t > 0) {",
     """      st_word(states + (long long)t * BINS + d,
              digit_word(a.pass, t == 0 ? LB_INCL : LB_AGG, cnts[j]));
      unsigned prefix = 0;
      if (t > 0) {""")]
NO_ONE_DIGIT = [("      if (run == unsigned(cnt)) s_one = d;\n", "")]
COUNT_BODY = "  if (valid) atomicAdd(ctr + d, 1u);\n}"
VOTE_BODY = """  const int lane = threadIdx.x & 31;
  const unsigned act = __ballot_sync(FULL, valid);
  const int lead = __ffs(act) - 1;
  const int d0 = __shfl_sync(FULL, d, lead & 31);
  if (__all_sync(FULL, !valid || d == d0)) {
    if (lane == lead) atomicAdd(ctr + d0, unsigned(__popc(act)));
  } else if (valid) {
    atomicAdd(ctr + d, 1u);
  }
}"""
GROUP_BODY = """  const int lane = threadIdx.x & 31;
  const unsigned peers = PEERS;
  if (valid && !(peers & ((1u << lane) - 1u)))
    atomicAdd(ctr + d, unsigned(__popc(peers)));
}"""
NEXT_COUNT = "      count_add<RB>(nhist, nd, valid);"
# the early counts and radix_hist's by another count_add; the next
# pass's counts stay a shared atomic a row
COUNT_MODES = {
    "vote_counts": VOTE_BODY,
    "match_counts": GROUP_BODY.replace(
        "PEERS", "__match_any_sync(FULL, valid ? d : (1 << RB) + lane)"),
    "ballot_counts": GROUP_BODY.replace("PEERS", "peers_of<RB>(d, valid)")}
# the next pass's counts only, by a vote a warp round
AGG_COUNTS = [
    ("// ---------------------------------------------------------------------------\n// radix_hist:",
     "template <int RB>\n__device__ __forceinline__ void count_vote(unsigned* "
     "ctr, int d, bool valid) {\n" + VOTE_BODY + "\n\n"
     "// ---------------------------------------------------------------------------\n// radix_hist:"),
    (NEXT_COUNT, "      count_vote<RB>(nhist, nd, valid);")]
# radix_hist counts every pass's digits from the keys, the passes none
HIST_ALL = [
    ("""  int src;                              // -1: the composite, else a key
  int shift;                            // the first pass's digit's bit in it
""", "  int np;\n  int src[MAX_PASSES];\n  int shift[MAX_PASSES];\n"),
    ("i < HWARPS * BINS; i += HIST_THREADS)", "i < h.np * BINS; i += HIST_THREADS)"),
    ("  unsigned* wh = s_hist + (threadIdx.x >> 5) * BINS;",
     "  unsigned* wh = s_hist;"),
    ("""      u128 c = 0;
      unsigned long long sel = 0;""",
     """      u128 c = 0;
      unsigned long long sel = 0, w[MAX_KEYS] = {};"""),
    ("          if (q == h.src) sel = w;", "          w[q] = wq;"),
    ("""          const unsigned long long w =
              map_key(raw[j][q], h.k.pad[q], h.k.ones[q]);
          c |= u128(w) << h.k.off[q];""",
     """          const unsigned long long wq =
              map_key(raw[j][q], h.k.pad[q], h.k.ones[q]);
          c |= u128(wq) << h.k.off[q];"""),
    ("""      const unsigned long long v =
          h.src < 0 ? static_cast<unsigned long long>(c >> h.shift)
                    : sel >> h.shift;
      count_add<RB>(wh, int(v & (BINS - 1)), valid);""",
     """      (void)sel;
      for (int p = 0; p < h.np; ++p) {
        unsigned long long v = c >> h.shift[p];
#pragma unroll
        for (int q = 0; q < MAX_KEYS; ++q)
          if (h.src[p] == q) v = w[q] >> h.shift[p];
        count_add<RB>(wh + p * BINS, int(v & (BINS - 1)), valid);
      }"""),
    ("""  for (int i = threadIdx.x; i < BINS; i += HIST_THREADS) {
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < HWARPS; ++w) c += s_hist[w * BINS + i];
    if (c) atomicAdd(hist + i, c);
  }""", """  for (int i = threadIdx.x; i < h.np * BINS; i += HIST_THREADS)
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);"""),
    ("  const int smem = HIST_THREADS / 32 * (1 << RB) * 4;",
     "  const int smem = h.np * (1 << RB) * 4;"),
    ("""      h.src = recs[8];
      h.shift = recs[9];
      if (h.src < -1 || h.src >= nkeys || h.shift < 0 ||
          h.shift + RADIX_BITS > (h.src < 0 ? 128 : 64))
        return BAD;""", """      h.np = npass;
      for (int p = 0; p < npass; ++p) {
        h.src[p] = recs[p * PLAN_INTS + 8];
        h.shift[p] = recs[p * PLAN_INTS + 9];
        if (h.src[p] < -1 || h.src[p] >= nkeys || h.shift[p] < 0 ||
            h.shift[p] + RADIX_BITS > (h.src[p] < 0 ? 128 : 64))
          return BAD;
      }"""),
    ("      a.count_shift = count_shift;", "      a.count_shift = -1;")]
# every row by its own thread's cp.async, no bulk copy and no mbarrier
THREAD_LOADS = [
    ("""  const int head = min(((16 - mis) & 15) / esz, cnt);
  const int body = (cnt - head) * esz & ~15;
  const int tail = head + body / esz;
  if (threadIdx.x == 0 && body) {
    bulk_copy(dst + head * esz, src + head * esz, unsigned(body), bar);
    *tx += unsigned(body);
  }
  for (int k = threadIdx.x; k < head + cnt - tail; k += THREADS) {
    const int r = k < head ? k : tail + k - head;
    if (esz == 8)
      *reinterpret_cast<unsigned long long*>(dst + r * 8) =
          __ldg(reinterpret_cast<const unsigned long long*>(src) + r);
    else
      *reinterpret_cast<unsigned*>(dst + r * 4) =
          __ldg(reinterpret_cast<const unsigned*>(src) + r);
  }""", """  for (int r = threadIdx.x; r < cnt; r += THREADS) {
    if (esz == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                       smem_u32(dst + r * 8)), "l"(src + r * 8) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_u32(dst + r * 4)), "l"(src + r * 4) : "memory");
  }"""),
    ("  if (threadIdx.x == 0) bar_expect(bar, tx);\n", ""),
    ("  bar_wait(bar);\n",
     "  asm volatile(\"cp.async.wait_all;\" ::: \"memory\");\n")]
VARIANTS = {   # name: (-D flags, text edits)
    "committed": ([], []),
    "no_early": ([], NO_EARLY),
    "no_one_digit": ([], NO_ONE_DIGIT),
    "agg_counts": ([], AGG_COUNTS),
    **{name: ([], [(COUNT_BODY, body),
                   (NEXT_COUNT, "      if (valid) atomicAdd(nhist + nd, 1u);")])
       for name, body in COUNT_MODES.items()},
    "hist_all": ([], HIST_ALL),
    "thread_loads": ([], THREAD_LOADS),
    "lb2": (["-DRS_LB_BATCH=2"], []),
    "lb8": (["-DRS_LB_BATCH=8"], []),
    "unroll1": ([], [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 1;")]),
    "hist_rows4_b4": (["-DRS_HIST_ROWS=4", "-DRS_HIST_BLOCKS=4"], []),
    "all_256x24": (["-DRS_THREADS=256", "-DRS_ITEMS=24",
                    "-DRS_MIN_BLOCKS=2"], []),
    "all_512x12": (["-DRS_THREADS32=512", "-DRS_ITEMS32=12",
                    "-DRS_MIN_BLOCKS32=2"], []),
    "tile3072": (["-DRS_THREADS=256", "-DRS_ITEMS=12", "-DRS_MIN_BLOCKS=4",
                  "-DRS_THREADS32=256", "-DRS_ITEMS32=12",
                  "-DRS_MIN_BLOCKS32=4"], []),
    "tile4096": (["-DRS_THREADS=256", "-DRS_ITEMS=16", "-DRS_MIN_BLOCKS=3",
                  "-DRS_THREADS32=256", "-DRS_ITEMS32=16",
                  "-DRS_MIN_BLOCKS32=4"], []),
    "tile8192": (["-DRS_THREADS=512", "-DRS_ITEMS=16", "-DRS_MIN_BLOCKS=1",
                  "-DRS_THREADS32=256", "-DRS_ITEMS32=32",
                  "-DRS_MIN_BLOCKS32=2"], []),
}
LATE = "late_counts"
# (name, rows at 500 Mchars)
SYNTHETIC = (("join", 493_043_503), ("lanes", 149_470_558),
             ("candidates", 98_607_104))
SITE_SHAPES = (("primary", 42, 2_000_000, 10, 0.01),
               ("500M", 42, 5_000_000, cs.BIG_DOCS, 0.01))


def bind_late(lib) -> None:
    """The ctypes signatures of tools/radix_sort_late_counts.cu."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for k in ("radix_sort_max_passes", "radix_sort_radix_bits"):
        getattr(lib, k).restype = I
        getattr(lib, k).argtypes = []
    lib.radix_pass_blocks_per_sm.restype = I
    lib.radix_pass_blocks_per_sm.argtypes = [I, I]
    lib.radix_sort_scratch_bytes.restype = LL
    lib.radix_sort_scratch_bytes.argtypes = [LL]
    lib.radix_hist_launch.restype = I
    keys = [I, ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(LL),
            ctypes.POINTER(I), ctypes.POINTER(I)]
    lib.radix_hist_launch.argtypes = keys + [I, I, LL, P, P, P]
    lib.radix_pass_launch.restype = I
    lib.radix_pass_launch.argtypes = keys + [
        P, I, P, I, I, I, P, P, I, LL, I, P, I, LL, I, I, P, I, P, I, LL, P,
        P]


class NewSorter:
    """One build of radix_sort.cu, launched as kernels.radix_sort_cuda
    launches it (its _RadixRun: the same plan, buffers and C calls), or
    with ``hook`` one C call a step, ``hook`` called with "set-up" before
    the first and with each step's name after it."""

    def __init__(self, lib):
        self.lib = lib

    def scratch_bytes(self, n: int) -> int:
        return int(self.lib.radix_sort_scratch_bytes(n))

    def sort(self, keys, bits, values=True, scratch=None, hook=None):
        keys, bits = tuple(keys), tuple(int(b) for b in bits)
        run = K._RadixRun(self.lib, keys, bits, S.fault_word("cuda:0"),
                          values, scratch)
        D = run.steps - 1
        if hook is None:
            steps = [(0, D), (D, D + 1)] if values and D > 1 else \
                [(0, D + 1)]
        else:
            hook("set-up")
            steps = [(a, a + 1) for a in range(D + 1)]
        for a, b in steps:
            run.run(a, b)
            if hook is not None:
                hook("radix_hist" if a == 0 else f"pass {a - 1}")
        return run.result()


class LateSorter:
    """The replaced design's wrapper: radix_hist, then one C call and
    fresh outputs a pass, as kernels.radix_plan lays them out."""

    def __init__(self, lib):
        self.lib = lib

    def scratch_bytes(self, n: int) -> int:
        return int(self.lib.radix_sort_scratch_bytes(n))

    def sort(self, keys, bits, values=True, scratch=None, hook=None):
        lib, keys = self.lib, tuple(keys)
        bits = tuple(int(b) for b in bits)
        dev, n, i32 = keys[0].device, int(keys[0].shape[0]), torch.int32
        plan = K.radix_plan(bits, int(lib.radix_sort_radix_bits()), values)
        orig64 = [int(k.dtype == torch.int64) for k in keys]
        pads = [S.PADS[k.dtype] for k in keys]
        if scratch is None:
            scratch = torch.zeros(self.scratch_bytes(n), dtype=torch.uint8,
                                  device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        p = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())

        def arrays(qs, offs):
            k = len(qs)
            return (k, (ctypes.c_void_p * k)(*(keys[q].data_ptr()
                                               for q in qs)),
                    (ctypes.c_int * k)(*(orig64[q] for q in qs)),
                    (ctypes.c_longlong * k)(*(pads[q] for q in qs)),
                    (ctypes.c_int * k)(*(bits[q] for q in qs)),
                    (ctypes.c_int * k)(*offs))

        def check(err, what):
            if err:
                raise RuntimeError(f"{what}: CUDA error {err}")
            if hook:
                hook(what)
        comp = plan[0].hist_src < 0
        if hook:
            hook("set-up")
        check(lib.radix_hist_launch(
            *arrays(range(len(keys)), K.radix_offsets(bits) if comp
                    else (0,) * len(keys)), plan[0].hist_src,
            plan[0].hist_shift, n, p(scratch), p(S.fault_word(dev)), stream),
            "radix_hist")
        rows = words = vals = None
        for at, ps in enumerate(plan):
            out_words = torch.empty(n, dtype=torch.int64 if ps.stage_wide
                                    else i32, device=dev) if ps.write \
                else None
            nq = ps.next
            next_out = None if nq is None else torch.empty(
                n, dtype=torch.int64 if bits[nq] > 32 else i32, device=dev)
            if ps.vals:
                vals = torch.empty(n, dtype=keys[0].dtype, device=dev)
            out_rows = torch.empty(n, dtype=i32, device=dev)
            nxt = (None, 0, 0, 1, 0, None) if nq is None else (
                p(keys[nq]), orig64[nq], pads[nq], bits[nq],
                int(bits[nq] > 32), p(next_out))
            check(lib.radix_pass_launch(
                *arrays(ps.keys, ps.offs), p(words), int(ps.in_wide),
                p(rows), ps.dshift, ps.drop, int(ps.stage_wide),
                p(out_words), p(vals), orig64[0], pads[0], bits[0], *nxt,
                plan[at + 1].dshift if at + 1 < len(plan) else -1,
                p(out_rows), at, n, p(scratch), stream), f"pass {at}")
            rows = out_rows
            words = out_words if ps.write else next_out
        return (rows, vals) if values else rows


def edited(name: str, text: str, edits) -> str:
    """radix_sort.cu's text with a variant's edits, each of whose texts it
    holds exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: radix_sort.cu holds {old!r} "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def build(names) -> dict:
    """The sorters of ``names``, built by parallel nvcc processes."""
    WORK.mkdir(parents=True, exist_ok=True)
    text = (K.CSRC / "radix_sort.cu").read_text()
    jobs = {}
    for name in names:
        src, flags = LATE_SRC, []
        if name != LATE:
            flags, edits = VARIANTS[name]
            src = WORK / f"radix_sort_{name}.cu"
            src.write_text(edited(name, text, edits))
        jobs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, *flags, f"-I{K.CSRC}", "-o",
             str(WORK / f"lib_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sorters = {}
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        entry = ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '\w*?\d+(radix_\w+)'",
                          line)
            if m:
                entry = m.group(1)
            elif ("registers" in line or "spill" in line) and entry:
                print(f"build {name}: {entry}: {line.strip()}")
        lib = ctypes.CDLL(str(WORK / f"lib_{name}.so"))
        if name == LATE:
            bind_late(lib)
            sorters[name] = LateSorter(lib)
            occ = [lib.radix_pass_blocks_per_sm(w, c)
                   for w, c in ((0, 0), (1, 0), (1, 1))]
        else:
            K.bind_radix_sort(lib)
            sorters[name] = NewSorter(lib)
            occ = [lib.radix_pass_blocks_per_sm(i, r, w, c)
                   for i, r, w, c in ((4, 1, 0, 0), (8, 1, 1, 0),
                                      (12, 0, 1, 1))]
        print(f"build {name}: pass blocks an SM (u32 words, u64 words, "
              f"composed int32 + int64 keys): {occ}", flush=True)
    return sorters


def check_equal(name, sorter, keys, bits, values=True) -> None:
    want = S._stable_argsort_reference(keys, bits, values)
    got = sorter.sort(keys, bits, values)
    torch.cuda.synchronize()
    if values:
        same = all(torch.equal(a, b) for a, b in zip(want, got))
    else:
        same = torch.equal(want, got)
    S.check_faults("cuda:0")
    if not same:
        raise SystemExit(f"{name}: differs from the plain version")


def stepped(sorter, keys, bits, values=True) -> list:
    """[(step, ms)] of one sort: an event before the sort and after each
    launch."""
    marks = []

    def hook(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))
    sorter.sort(keys, bits, values)      # warm
    torch.cuda.synchronize()
    first = torch.cuda.Event(enable_timing=True)
    first.record()
    sorter.sort(keys, bits, values, hook=hook)
    torch.cuda.synchronize()
    out, prev = [], first
    for label, ev in marks:
        out.append((label, round(prev.elapsed_time(ev), 4)))
        prev = ev
    return out


def host_ms(sorter, keys, bits, values=True, reps: int = 5) -> float:
    """Host clock around ``reps`` wrapper calls with no sync between
    them, per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        sorter.sort(keys, bits, values)
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def randomized_pads(keys, bits, seed: int = 5):
    """The keys with every pad replaced by a uniform word of its width."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = []
    for k, b in zip(keys, bits):
        top = min((1 << b) - 1, S.PADS[k.dtype])
        r = torch.randint(0, top, k.shape, generator=g, device="cuda",
                          dtype=torch.int64).to(k.dtype)
        out.append(torch.where(k == S.PADS[k.dtype], r, k))
    return tuple(out)


def synthetic(name: str, rows: int):
    """Keys on the card (seed 12) shaped like a sort at 500 Mchars."""
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    dev, i32 = "cuda", torch.int32
    if name == "join":
        key1 = torch.randint(0, (1 << 23) - 1, (rows,), generator=g,
                             device=dev, dtype=i32)
        key1[torch.rand(rows, generator=g, device=dev) < 0.2] = S.INT_MAX
        key2f = torch.randint(0, (1 << 47) - 1, (rows,), generator=g,
                              device=dev, dtype=torch.int64)
        return (key1, key2f), (23, 47)
    if name == "lanes":
        k = torch.randint(0, (1 << 28) - 1, (rows,), generator=g,
                          device=dev, dtype=i32)
        grp = torch.arange(rows, device=dev) * 5 // rows
        start = (grp * rows + 4) // 5
        end = ((grp + 1) * rows + 4) // 5
        at = torch.arange(rows, device=dev)
        k[at - start >= (end - start) * 3 // 5] = S.INT_MAX
        return (k,), (28,)
    lanes = 4096
    cap = max(1, rows // lanes)
    span = 500_000_101 // lanes
    slot = torch.arange(cap, device=dev)
    nrec = torch.randint(cap // 5, cap // 2 + 1, (lanes, 1), generator=g,
                         device=dev)
    step = torch.randint(1, 2 * span // cap + 2, (lanes, cap), generator=g,
                         device=dev)
    t = (torch.arange(lanes, device=dev)[:, None] * span
         + torch.cumsum(step, 1) // 2).clamp_(max=500_000_100)
    k = torch.where(slot[None, :] < nrec, t, S.INT_MAX).to(i32).reshape(-1)
    return (k,), (S.key_bits(500_000_101),)


def synthetic_main(scale: float, names) -> None:
    sorters = build(names)
    for case, rows in SYNTHETIC:
        rows = max(1, int(rows * scale))
        keys, bits = synthetic(case, rows)
        valid = float((keys[0] != S.PADS[keys[0].dtype]).float().mean())
        print(f"case {case}: {rows} rows, widths {bits}, valid share "
              f"{valid:.4f}", flush=True)
        for name, sorter in sorters.items():
            check_equal(f"{name}[{case}]", sorter, keys, bits)
            torch.cuda.empty_cache()
        for rnd in (1, 2):
            for name, sorter in sorters.items():
                ms = cs.cuda_ms(lambda: sorter.sort(keys, bits), 3)
                steps = stepped(sorter, keys, bits)
                print(f"round {rnd} {case} {name}: {ms:.3f} ms a sort; "
                      "steps ms: " + ", ".join(f"{lab} {t:.3f}"
                                               for lab, t in steps),
                      flush=True)
                torch.cuda.empty_cache()
        del keys
        torch.cuda.empty_cache()


def capture_sites(shape) -> dict:
    """Every stable_argsort call site's keys from the jump scan (its
    index and candidates) and one device merge at this shape."""
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    name, seed, ref_len, docs, snp = shape
    lst = cs.write_workload(WORK / name, seed, ref_len, docs, snp)
    x_aug, coll = load_inputs(str(lst))
    with cs.SortCapture() as scan:
        res = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
    with cs.SortCapture() as merge:
        dm.merge_heads_device_resident(res, coll.d, False,
                                       want_counter=False)
        torch.cuda.synchronize()
    del res, x_aug, coll
    shutil.rmtree(WORK / name)
    torch.cuda.empty_cache()
    # the scan's index shares its doubling's site with the merge's
    # head-string sort
    return {**{f"{site} (jump scan)": a for site, a in scan.sites.items()},
            **merge.sites}


def sites_main(shapes, names, turns: int) -> None:
    sorters = build(names)
    rb = int(next(iter(sorters.values())).lib.radix_sort_radix_bits())
    summary = {}
    for shape in SITE_SHAPES:
        if shape[0] not in shapes:
            continue
        sites = capture_sites(shape)
        for site, (keys, bits, values) in sites.items():
            tag = f"{shape[0]} {site}"
            n = keys[0].numel()
            plan = K.radix_plan(bits, rb, values)
            floor, moved = cs.sort_bytes(keys, bits, values, rb)
            valid = float((keys[0] != S.PADS[keys[0].dtype]).float().mean())
            r = {"rows": n, "bits": list(bits),
                 "dtypes": [str(k.dtype)[6:] for k in keys],
                 "values": values, "passes": len(plan),
                 "valid_share": round(valid, 4),
                 "floor_bound_ms": cs.bound_ms(floor),
                 "passes_bound_ms": cs.bound_ms(moved),
                 "torch_sort_ms": cs.library_ms(
                     lambda: cs.torch_lexsort(keys), 3)}
            for name, sorter in sorters.items():
                check_equal(f"{name}[{tag}]", sorter, keys, bits, values)
            rnd_keys = randomized_pads(keys, bits)
            order = [name for i in range(turns)
                     for name in (list(sorters) if i % 2 == 0
                                  else list(sorters)[::-1])]
            for name in order:
                sorter = sorters[name]
                sr = r.setdefault(name, {"ms": [], "alone_ms": [],
                                         "host_ms": []})
                sr["ms"].append(cs.library_ms(
                    lambda: sorter.sort(keys, bits, values), 5))
                sr["alone_ms"].append(cs.alone_ms(
                    lambda scratch: sorter.sort(keys, bits, values,
                                                scratch=scratch),
                    sorter.scratch_bytes(n)))
                sr["host_ms"].append(host_ms(sorter, keys, bits, values))
                if "steps" not in sr:
                    sr["steps"] = stepped(sorter, keys, bits, values)
                    sr["steps_random_pads"] = stepped(sorter, rnd_keys, bits,
                                                      values)
                torch.cuda.empty_cache()
            for name in sorters:
                sr = r[name]
                sr["host_ms_per_step"] = round(
                    min(sr["host_ms"]) / (len(plan) + 1), 4)
            print(f"site {tag}: " + json.dumps(r), flush=True)
            summary[tag] = {k: v for k, v in r.items()}
            del rnd_keys
        del sites
        torch.cuda.empty_cache()
    print("sites summary " + json.dumps(summary), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sites", nargs="?", const="primary,500M")
    ap.add_argument("--sorters")
    ap.add_argument("--rows-scale", type=float, default=1.0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    K.load()
    try:
        if args.sites:
            names = (args.sorters or f"committed,{LATE}").split(",")
            sites_main(args.sites.split(","), names, args.turns)
        else:
            names = (args.sorters.split(",") if args.sorters
                     else [*VARIANTS, LATE])
            synthetic_main(args.rows_scale, names)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
