"""Profile the dense route's joint suffix sort (ops/joint_sa.py) on one
CUDA card, by round and by operator.

    python3 tools/profile_joint_sa.py [--shapes primary,ecoli_dense,500M]
    python3 tools/profile_joint_sa.py --parent DIR [--shapes ...] [--cli]
    python3 tools/profile_joint_sa.py --split [--shapes primary,500M]

For each shape the joint string the dense scan sorts is built on the card
as the main path builds it: ``primary`` (2 Mbp x 10 docs at 1% SNP, seed
42, unblocked, the wide seed), ``ecoli_dense`` (5 Mbp x 20 docs,
unblocked) and ``500M`` (5 Mbp x 100 docs: the first block the memory
guard chooses, narrow seed, as phase 8 of chip_smoke.py and
``profile_slice.py --blocked`` scan it). Then, on that string:

1. the rounds: the seed's unresolved count u0, each round's kind (full,
   compacted; the rest of the loop's levels skip) and u after it;
2. joint_suffix_array timed ``--reps`` times (CUDA events, warm), with
   the peak device bytes per joint char over the call (b and sp
   resident, as in the scan);
3. one run with the module's steps timed by category, each call
   synchronised before and after (so host gaps count, and the sum sits
   a little above the plain run): the sorts, the flag fills, the rank
   steps (the sorted-row change flags, the singletons, the scatters back
   to text order), the shifted rank rows, and the rest;
4. one run under torch.profiler: the top operators by device time;
5. ms_dense._irreducible_slots on the outputs, timed;
6. with ``--cli``, the dense CLI once on the 500M shape (``-r
   --no-rle-quirk``, the guard's blocks, CMSBWT_PROFILE=1): its
   ``ms_scan`` phase and each block's ``dense.block.joint_sa`` span,
   and ``dense.concat_blocks`` (the cache emptied after the last block),
   and
   each ``torch.cuda.empty_cache`` call's ms and the segments it freed.

With ``--split`` each shape's first full round's rank step is taken
apart instead, on its live inputs (the sort stops there; where sa_round
runs the seed's rank step, that too, with and without its store), each
piece
warmed once and timed over 5 launches between CUDA events: sa_round with
its wrapper, and each of its kernels by torch.profiler; the same with the
text-order store of its results removed (NO_SCATTER, a text edit of
sa_round.cu built beside it); a probe that gathers the 16-byte key row
of each sorted row through perm and one that scatters an 8-byte word
through perm (SPLIT_SRC); torch's ``K[perm]`` and ``w.index_copy_(0,
perm, v)`` on the same bytes; and ``Tensor.copy_`` of the bound's bytes
(chip_smoke.sa_round_bytes); where the checkout bins its scatter, the
wrapper again with bins of 2^19, 2^21 and 2^22 positions (BIN_SHIFTS).
One ``split {json}`` line per shape.

Each measurement runs in a child process that imports the package from
one checkout. With ``--parent DIR`` (an older checkout's root, e.g. from
``git archive``) the children run parent, this, this, parent, so the two
trees are compared on one card; each child prints a ``joint_sa {json}``
line per shape and the tool ends with a ``joint_sa summary {json}`` line.

Works in _profile_work/ (gitignored) and deletes it. Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORK = ROOT / "_profile_work"
SHAPES = {"primary": (42, 2_000_000, 10, 0.01, False),
          "ecoli_dense": (42, 5_000_000, 20, 0.01, False),
          "500M": (42, 5_000_000, 100, 0.01, True)}
# the module's steps by category: (attribute of ops/joint_sa, category);
# a name a checkout lacks is skipped, so one list serves both trees
STEPS = (("_sort_rows", "sort"), ("stable_argsort", "sort"),
         ("_flag_fill", "fill"), ("running_fill", "fill"),
         ("round_ranks", "rank_step"), ("seed_ranks", "rank_step"),
         ("_changes", "rank_step"),
         ("_next_is", "rank_step"), ("_invert", "rank_step"),
         ("_shifted", "shifted"), ("_next_key", "shifted"))


def joint_string(lst: str, blocked: bool, dev: str = "cuda"):
    """The joint string the dense scan sorts for the input list ``lst``
    (unblocked, or the first block the memory guard chooses), built on the
    card as the main path builds it: (b, sp, m, wide, n, window, n_pad,
    block_chars)."""
    import torch
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.utils.buckets import bucket_size
    x_aug, coll = load_inputs(lst)
    n, sx = len(x_aug), coll.sx
    if blocked:
        bc = md.dense_block_chars(n, coll.sn, md.dense_budget(dev))
        ctx = md._default_ctx(bc, None)
        end = min(min(bc, coll.sn) + ctx, coll.sn)
        window = sx[:end]
        n_pad, s_pad = bucket_size(n), md.block_pad(bc, ctx, window)
    else:
        bc, window = None, sx
        n_pad, s_pad, _ = md.joint_geometry(n, sx)
    m = n_pad + s_pad
    x_u8 = md.upload_bytes(x_aug, n_pad, dev)
    sx_u8 = md.upload_bytes(window, s_pad, dev)
    wide = md.wide_seed_ok(x_u8[:n], sx_u8[:len(window)], m)
    b, sp = md._build_joint_core(x_u8, sx_u8, n, len(window), 0, n_pad,
                                 s_pad)
    del x_u8, sx_u8, x_aug, coll
    torch.cuda.synchronize()
    return b, sp, m, wide, n, window, n_pad, bc


def child(root: pathlib.Path, shapes: list, reps: int, tag: str,
          dev: str = "cuda", cli_list: str | None = None) -> None:
    """Measure the checkout at ``root`` on each (name, input list, blocked)
    of ``shapes``; print one ``joint_sa {json}`` line each."""
    sys.path.insert(0, str(root))
    import torch
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    if dev == "cuda":
        kernels.load()
    for name, lst, blocked in shapes:
        b, sp, m, wide, n, window, n_pad, bc = joint_string(lst, blocked,
                                                            dev)
        out = {"tag": tag, "shape": name, "m": m, "block_chars": bc,
               "seed": "wide" if wide else "narrow"}

        # 1. the rounds
        rounds, seeds = [], {}
        saved = {k: getattr(js, k) for k in ("_full_round", "_comp_round",
                                             "_narrow_seed", "_wide_seed",
                                             "seed_ranks") if hasattr(js, k)}

        def seed_spy(fn):
            def run(*a, **kw):
                res = fn(*a, **kw)
                ch = res[2]
                if isinstance(ch, torch.Tensor):   # the change flags
                    nxt = torch.ones_like(ch)
                    nxt[:-1] = ch[1:]
                    seeds["u0"] = m - int((ch & nxt).sum())
                return res
            return run

        def seed_ranks_spy(fn):
            def run(*a, **kw):
                res = fn(*a, **kw)
                seeds["u0"] = int(res[3])
                return res
            return run

        def round_spy(fn, kind, at):
            def run(*a, **kw):
                res = fn(*a, **kw)
                rounds.append({"kind": kind, "k": a[2] if kind == "full"
                               else a[3], "u": int(res[at])})
                return res
            return run
        js._narrow_seed = seed_spy(saved["_narrow_seed"])
        js._wide_seed = seed_spy(saved["_wide_seed"])
        if "seed_ranks" in saved:
            js.seed_ranks = seed_ranks_spy(saved["seed_ranks"])
        js._full_round = round_spy(saved["_full_round"], "full", 5)
        js._comp_round = round_spy(saved["_comp_round"], "comp", 4)
        try:
            js.joint_suffix_array(b, sp, m, wide)
        finally:
            for k, fn in saved.items():
                setattr(js, k, fn)
        sl = js.WIDE_SEED_LEVEL if wide else js.SEED_LEVEL
        levels = len(range(sl, js.n_levels(m) - 1, 2))
        out.update(u0=seeds.get("u0"), rounds=rounds,
                   skip_rounds=levels - len(rounds))

        # 2. timed, with the peak per joint char
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(reps):
            torch.cuda.reset_peak_memory_stats()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = js.joint_suffix_array(b, sp, m, wide)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            del res
        peak = torch.cuda.max_memory_allocated()
        out.update(ms=times, peak_bytes=peak,
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                   peak_per_joint_char=round(peak / m, 1),
                   peak_above_inputs_per_joint_char=round((peak - base) / m,
                                                          1))

        # 3. by category, each outermost step synchronised; and the seed
        # step: from the end of the seed's last sort to the first round
        spent, depth, marks = {}, [0], {}

        def timed(fn, cat):
            def run(*a, **kw):
                if cat == "shifted" and "round" not in marks:
                    torch.cuda.synchronize()
                    marks["round"] = time.perf_counter()
                if depth[0]:
                    return fn(*a, **kw)
                depth[0] += 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    spent[cat] = spent.get(cat, 0.0) + (t1 - t0) * 1e3
                    if cat == "sort" and "round" not in marks:
                        marks["sorted"] = t1
                    depth[0] -= 1
            return run
        orig = {k: getattr(js, k) for k, _ in STEPS if hasattr(js, k)}
        orig_sort = torch.sort
        for k, cat in STEPS:
            if k in orig:
                setattr(js, k, timed(orig[k], cat))
        torch.sort = timed(orig_sort, "sort")   # the module's direct sorts
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = js.joint_suffix_array(b, sp, m, wide)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        finally:
            torch.sort = orig_sort
            for k, fn in orig.items():
                setattr(js, k, fn)
        spent = {k: round(v, 3) for k, v in spent.items()}
        spent["rest"] = round(total - sum(spent.values()), 3)
        out.update(by_category_ms=spent, by_category_total_ms=round(total, 3),
                   seed_step_ms=round((marks["round"] - marks["sorted"])
                                      * 1e3, 3) if "round" in marks
                   else None)

        # 4. by operator
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        del res
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = js.joint_suffix_array(b, sp, m, wide)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        dev_ms = sum(e.self_device_time_total for e in ka
                     if e.device_type == DeviceType.CUDA) / 1e3
        ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in ka if e.device_type != DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
        kern = sorted(((e.key[:60], e.self_device_time_total / 1e3, e.count)
                       for e in ka if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        sa = {}
        for e in ka:
            if e.device_type == DeviceType.CUDA and "sa_round" in e.key:
                name = e.key[e.key.index("sa_round"):][:48]
                t, c = sa.get(name, (0.0, 0))
                sa[name] = (round(t + e.self_device_time_total / 1e3, 4),
                            c + e.count)
        out.update(profiled_device_ms=round(dev_ms, 3),
                   sa_round_kernels_ms_count=sa,
                   top_ops=[[k, round(t, 3), c] for k, t, c in ops[:16]],
                   top_kernels=[[k, round(t, 3), c] for k, t, c in
                                kern[:12]])

        # 5. the irreducible slots' sort, on these outputs
        sa, isa, _, _, _, split_lv = res
        irr = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st = md._irreducible_slots(b, sp, sa, isa, split_lv, n,
                                       len(window), m, n_pad)
            e1.record()
            torch.cuda.synchronize()
            irr.append(e0.elapsed_time(e1))
            del st
        out["irreducible_ms"] = irr
        print("joint_sa " + json.dumps(out), flush=True)
        del res, sa, isa, split_lv, b, sp
        torch.cuda.empty_cache()
    if cli_list:
        cli_500m(root, cli_list, tag)


# --split: the first full round's rank step taken apart
SPLIT_SRC = r"""
#include <cuda_runtime.h>
// one 16-byte key row gathered through perm per row, folded so that no
// load is dead; one 8-byte word scattered through perm per row
namespace {
constexpr int T = 256, N = 8;
__device__ void rows(const int* perm, long long r0, int R, int* src) {
  if (r0 + N <= R) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(perm + r0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(perm + r0 + 4));
    src[0] = a.x; src[1] = a.y; src[2] = a.z; src[3] = a.w;
    src[4] = b.x; src[5] = b.y; src[6] = b.z; src[7] = b.w;
  } else {
    for (int j = 0; j < N; ++j) src[j] = r0 + j < R ? perm[r0 + j] : -1;
  }
}
__global__ void gather_k(const int* perm, const int4* K, int R, int* out) {
  const long long r0 = N * ((long long)blockIdx.x * T + threadIdx.x);
  if (r0 >= R) return;
  int src[N], x = 0;
  rows(perm, r0, R, src);
  int4 w[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    w[j] = src[j] >= 0 ? __ldg(K + src[j]) : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < N; ++j) x ^= w[j].x ^ w[j].y ^ w[j].z ^ w[j].w;
  if (x == 0x7fffffff) out[0] = x;
}
__global__ void scatter_w(const int* perm, long long* w, int R, int m) {
  const long long r0 = N * ((long long)blockIdx.x * T + threadIdx.x);
  if (r0 >= R) return;
  int src[N];
  rows(perm, r0, R, src);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (unsigned(src[j]) < unsigned(m)) w[src[j]] = (r0 + j) << 1 | 1;
}
}  // namespace
extern "C" int split_gather(const void* perm, const void* K, int R,
                            void* out, void* stream) {
  gather_k<<<int((R + N * T - 1) / (N * T)), T, 0, (cudaStream_t)stream>>>(
      (const int*)perm, (const int4*)K, R, (int*)out);
  return int(cudaGetLastError());
}
extern "C" int split_scatter(const void* perm, void* w, int R, int m,
                             void* stream) {
  scatter_w<<<int((R + N * T - 1) / (N * T)), T, 0, (cudaStream_t)stream>>>(
      (const int*)perm, (long long*)w, R, m);
  return int(cudaGetLastError());
}
"""
# the rank step with its text-order store removed: text edits of
# sa_round.cu (the first alternative whose every text occurs exactly
# once): PR 14's scatter of one word a row; the binned scatter's staging
# store and its two placing kernels
NO_SCATTER = (
    (("""      if (unsigned(at) < unsigned(a.m))
        a.words[at] = (static_cast<long long>(run.mid) << 31) |
                      (static_cast<long long>(run.full) << 1) | sing;
""", ""),),
    (("""      if (d < 0) continue;
      a.st_pos[d] = s_pos[p];""", """      if (d < 0 || d >= 0) continue;
      a.st_pos[d] = s_pos[p];"""),
     ("""  const int c0 = blockIdx.x * CHUNK;
""", """  const int c0 = blockIdx.x * CHUNK;
  if (c0 >= 0) return;
"""),
     ("""  const int base = blockIdx.x * FINE;
""", """  const int base = blockIdx.x * FINE;
  if (base >= 0) return;
""")),
)


# the bin widths --split also times sa_round's binned scatter at
BIN_SHIFTS = (19, 21, 22)


class _Stop(Exception):
    pass


def build_split(K, root: pathlib.Path) -> dict:
    """The probes (SPLIT_SRC) and sa_round.cu without its text-order store,
    built by two parallel nvcc processes with the port's flags."""
    d = WORK / "split"
    d.mkdir(parents=True, exist_ok=True)
    text = (root / "cmsbwt_tpu_torch/kernels/csrc/sa_round.cu").read_text()
    for edits in NO_SCATTER:
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            break
    else:
        raise SystemExit("--split: no NO_SCATTER edit fits sa_round.cu")
    (d / "sa_round_no_scatter.cu").write_text(text)
    (d / "probes.cu").write_text(SPLIT_SRC)
    csrc = root / "cmsbwt_tpu_torch/kernels/csrc"
    jobs = {name: subprocess.Popen(
        [K._nvcc(), *K.NVCC_FLAGS, f"-I{csrc}", "-o",
         str(d / f"lib{name}.so"), str(d / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("sa_round_no_scatter", "probes")}
    libs = {}
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(d / f"lib{name}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs["probes"].split_gather.argtypes = [P, P, I, P, P]
    libs["probes"].split_scatter.argtypes = [P, P, I, I, P]
    # the variant takes the committed library's signatures
    committed = K.load()["sa_round"]
    for fname, f in vars(committed).items():
        if isinstance(f, ctypes._CFuncPtr):
            g = getattr(libs["sa_round_no_scatter"], fname)
            g.restype, g.argtypes = f.restype, f.argtypes
    return libs


def kernel_ms(fn) -> dict:
    """Device ms of each kernel of one call of ``fn`` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:48]: round(e.self_device_time_total / 1e3, 4)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def split_round(K, libs, perm, keys, lv, k) -> dict:
    """The first full round's rank step taken apart on its live inputs:
    each piece warmed once, then 5 launches between CUDA events."""
    import torch
    import chip_smoke as cs
    R, m = perm.numel(), lv.numel()
    # a tuple: the wrapper empties a list of keys once it has packed it
    keys = keys if isinstance(keys, torch.Tensor) else tuple(keys)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        return round(cs.cuda_ms(fn, 5), 4)
    wrapper = lambda: K.sa_round_cuda(perm, keys, lv, k)
    out = {"rows": R, "m": m, "k": k, "wrapper_ms": ms(wrapper),
           "wrapper_kernels_ms": kernel_ms(wrapper)}
    saved = K.load()["sa_round"]
    K.load()["sa_round"] = libs["sa_round_no_scatter"]
    try:
        out["no_scatter_wrapper_ms"] = ms(wrapper)
        out["no_scatter_kernels_ms"] = kernel_ms(wrapper)
    finally:
        K.load()["sa_round"] = saved
    kk = keys if isinstance(keys, torch.Tensor) else torch.stack(keys, 1)
    kk = kk.contiguous()
    probe, sink = libs["probes"], torch.zeros(1, dtype=torch.int32,
                                              device=perm.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    # the wrapper at other bin widths (kernels.SA_BIN_SHIFT), where the
    # checkout has them
    shift0 = getattr(K, "SA_BIN_SHIFT", None)
    for sh in BIN_SHIFTS if shift0 is not None else ():
        K.SA_BIN_SHIFT = sh
        try:
            out[f"bins_2^{sh}"] = {"wrapper_ms": ms(wrapper),
                                   "kernels_ms": kernel_ms(wrapper)}
        finally:
            K.SA_BIN_SHIFT = shift0
    out["gather_ms"] = ms(lambda: probe.split_gather(p(perm), p(kk), R,
                                                     p(sink), stream))
    w = torch.empty(m, dtype=torch.int64, device=perm.device)
    out["scatter_ms"] = ms(lambda: probe.split_scatter(p(perm), p(w), R, m,
                                                       stream))
    p64 = perm.long()
    out["torch_gather_ms"] = ms(lambda: kk[p64])
    v = torch.arange(R, dtype=torch.int64, device=perm.device)
    out["torch_index_copy_ms"] = ms(lambda: w.index_copy_(0, p64, v))
    del p64, v, w
    moved = cs.sa_round_bytes(perm, list(kk.unbind(1)), lv, None)
    out["bound_ms"] = round(cs.bound_ms(moved), 4)
    out["bound_bytes_per_row"] = moved / R
    out["copy_bound_bytes_ms"] = round(cs.copy_ms(moved), 4)
    return out


def split_seed(K, libs, order, rows, sl) -> dict:
    """The seed's rank step on sa_round's seed mode (a checkout that has
    it), with the wrapper and by kernel, and without its store."""
    import torch
    import chip_smoke as cs
    rows = tuple(rows)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        return round(cs.cuda_ms(fn, 5), 4)
    wrapper = lambda: K.sa_round_seed_cuda(order, rows, sl)
    out = {"seed_wrapper_ms": ms(wrapper),
           "seed_kernels_ms": kernel_ms(wrapper),
           "seed_bound_ms": round(cs.bound_ms(cs.seed_bytes(order, rows)),
                                  4)}
    saved = K.load()["sa_round"]
    K.load()["sa_round"] = libs["sa_round_no_scatter"]
    try:
        out["seed_no_scatter_wrapper_ms"] = ms(wrapper)
    finally:
        K.load()["sa_round"] = saved
    shift0 = K.SA_BIN_SHIFT
    for sh in BIN_SHIFTS:
        K.SA_BIN_SHIFT = sh
        try:
            out[f"seed_bins_2^{sh}"] = {"wrapper_ms": ms(wrapper),
                                        "kernels_ms": kernel_ms(wrapper)}
        finally:
            K.SA_BIN_SHIFT = shift0
    return out


def split_child(root: pathlib.Path, shapes: list, tag: str) -> None:
    """--split on the checkout at ``root``: one ``split {json}`` line per
    shape, from its seed's rank step where sa_round runs it and its first
    full round (the sort stops there)."""
    sys.path.insert(0, str(root))
    import torch
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops import joint_sa as js
    libs = build_split(kernels, root)
    for name, lst, blocked in shapes:
        b, sp, m, wide, *_ = joint_string(lst, blocked)
        got, orig = {}, js.round_ranks

        def spy(perm, keys, lv, k, comp=None):
            if comp is not None:
                return orig(perm, keys, lv, k, comp)
            got.update(split_round(kernels, libs, perm, keys, lv, k))
            raise _Stop
        js.round_ranks = spy
        seed_orig = getattr(js, "seed_ranks", None)
        if seed_orig is not None:
            def seed_spy(order, rows, sl):
                got.update(split_seed(kernels, libs, order, rows, sl))
                return seed_orig(order, rows, sl)
            js.seed_ranks = seed_spy
        try:
            js.joint_suffix_array(b, sp, m, wide)
        except _Stop:
            pass
        finally:
            js.round_ranks = orig
            if seed_orig is not None:
                js.seed_ranks = seed_orig
        print("split " + json.dumps({"tag": tag, "shape": name, "m": m,
                                     "seed": "wide" if wide else "narrow",
                                     **got}), flush=True)
        del b, sp
        torch.cuda.empty_cache()


def cli_500m(root: pathlib.Path, lst: str, tag: str) -> None:
    """The dense CLI once on ``lst`` with CMSBWT_PROFILE=1: one ``dense_cli
    {json}`` line with its phases and block marks."""
    import io
    import re
    import torch
    from cmsbwt_tpu_torch import cli
    out = WORK / f"cli_{tag}"
    os.environ["CMSBWT_PROFILE"] = "1"
    # each emptying of torch's cache: its ms and the segments it freed
    empties, empty = [], torch.cuda.empty_cache

    def timed_empty():
        segs = torch.cuda.memory_stats().get("segment.all.current", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        empty()
        empties.append((round((time.perf_counter() - t0) * 1e3, 1), segs))
    torch.cuda.empty_cache = timed_empty
    err, sys.stderr = sys.stderr, io.StringIO()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main([lst, "-o", str(out), "--device", "cuda", "--backend",
                       "dense", "-r", "--no-rle-quirk"])
        wall = time.perf_counter() - t0
        marks = sys.stderr.getvalue()
    finally:
        sys.stderr = err
        torch.cuda.empty_cache = empty
        del os.environ["CMSBWT_PROFILE"]
    if rc:
        raise RuntimeError("the dense CLI failed")
    phases = {}
    for line in out.with_suffix(".log").read_text().splitlines():
        if line.endswith(" ms") and ": " in line:
            k, v = line.split(": ", 1)
            phases[k] = float(v[:-3])
    get = lambda name: [float(x) for x in re.findall(
        rf"{name}[^:]*: ([0-9.]+) ms", marks)]
    print("dense_cli " + json.dumps({
        "tag": tag, "wall_s": wall, "phases_ms": phases,
        "blk_jsa_ms": get("dense.block.joint_sa"),
        "blk_irr_ms": get("dense.block.irreducible"),
        "concat_blocks_ms": get("dense.concat_blocks"),
        "empty_cache_ms_segments": empties}), flush=True)
    for f in WORK.glob(f"cli_{tag}*"):
        f.unlink()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="primary,ecoli_dense,500M")
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cli", action="store_true",
                    help="also run the dense CLI once on the 500M shape")
    ap.add_argument("--split", action="store_true",
                    help="take the first full round's rank step apart "
                    "instead")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        spec = json.loads(args.child)
        if spec.get("split"):
            split_child(pathlib.Path(spec["root"]), spec["shapes"],
                        spec["tag"])
        else:
            child(pathlib.Path(spec["root"]), spec["shapes"], args.reps,
                  spec["tag"], cli_list=spec.get("cli"))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profile_joint_sa: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs   # noqa: E402  (also blocks JAX imports)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        shapes, cli_list = [], None
        names = args.shapes.split(",")
        if args.cli and "500M" not in names:
            names.append("500M")
        for name in names:
            seed, ref_len, docs, snp, blocked = SHAPES[name]
            t0 = time.perf_counter()
            lst = cs.write_workload(WORK / name, seed, ref_len, docs, snp)
            print(f"wrote {name} in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            if name in args.shapes.split(","):
                shapes.append((name, str(lst), blocked))
            if name == "500M" and args.cli:
                cli_list = str(lst)
        turns = [("this", ROOT)] if args.parent is None else [
            ("parent", args.parent.resolve()), ("this", ROOT),
            ("this", ROOT), ("parent", args.parent.resolve())]
        summary = {}
        for tag, root in turns:
            spec = json.dumps({"root": str(root), "shapes": shapes,
                               "tag": tag, "cli": cli_list,
                               "split": args.split})
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, __file__, "--child", spec,
                                "--reps", str(args.reps)],
                               capture_output=True, text=True)
            sys.stdout.write(r.stdout)
            sys.stderr.write(r.stderr[-4000:])
            if r.returncode:
                print(f"profile_joint_sa: the {tag} child failed "
                      f"({r.returncode})", file=sys.stderr)
                return 1
            print(f"turn {tag}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            for line in r.stdout.splitlines():
                if line.startswith("dense_cli {"):
                    d = json.loads(line[len("dense_cli "):])
                    s = summary.setdefault("dense_cli", {}).setdefault(
                        tag, [])
                    s.append({k: d[k] for k in ("blk_jsa_ms",
                                                "concat_blocks_ms",
                                                "empty_cache_ms_segments")}
                             | {"ms_scan": d["phases_ms"].get("ms_scan")})
                if line.startswith("split {"):
                    d = json.loads(line[len("split "):])
                    summary.setdefault("split", {}).setdefault(
                        d["shape"], {}).setdefault(tag, []).append(
                        {k: v for k, v in d.items()
                         if k.endswith("_ms") and not isinstance(v, dict)})
                if line.startswith("joint_sa {"):
                    d = json.loads(line[len("joint_sa "):])
                    s = summary.setdefault(d["shape"], {}).setdefault(
                        tag, {"ms": [], "peak_per_joint_char": [],
                              "irreducible_ms": []})
                    s["ms"] += d["ms"]
                    s["peak_per_joint_char"].append(d["peak_per_joint_char"])
                    s["irreducible_ms"] += d["irreducible_ms"]
        print("joint_sa summary " + json.dumps(summary), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
