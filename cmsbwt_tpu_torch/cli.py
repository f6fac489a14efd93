"""Command-line interface of the port, flag-compatible with cmsbwt_tpu's
(``cmsbwt [-p N] [-b GiB] [-r] [-o out] <inputlist>``) plus ``--device``.

The input list file has the reference path on line 1 and the collection
path on line 2. Outputs ``<out>.bwt`` or ``<out>.rl_bwt`` (with ``-r``)
plus ``<out>.log``. ``--device cuda`` (the default) on a machine without a
usable CUDA device is an error.

Under a launcher (torchrun, or CMSBWT_COORDINATOR, CMSBWT_NUM_PROCESSES
and CMSBWT_PROCESS_ID) every process runs this CLI as one rank of the mesh
routes (NCCL on cuda, gloo on cpu), and rank 0 writes the outputs.
Without one, a mesh route on cuda starts one rank per visible card itself.
"""
from __future__ import annotations

import argparse
import sys
import time

from .config import UINT64_MAX, Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cmsbwt_tpu_torch",
        description="BWT of a repetitive string collection via compressed "
                    "matching statistics against a reference (PyTorch/CUDA "
                    "port of cmsbwt_tpu).")
    p.add_argument("filename",
                   help="file containing the reference path (line 1) and the "
                        "collection path (line 2)")
    p.add_argument("-p", dest="prefix_length", type=int, default=UINT64_MAX,
                   help="read only a prefix of the collection file "
                        "(number of characters; default: whole file)")
    p.add_argument("-b", dest="buffer", type=int, default=2,
                   help="additional memory buffer size in GB (accepted for "
                        "reference CLI compatibility)")
    p.add_argument("-r", dest="rle", action="store_true",
                   help="output the run-length encoded BWT")
    p.add_argument("-o", dest="outname", default="",
                   help="basename for the output files (default: input name)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on (default cuda; cpu runs the plain "
                        "torch versions of the kernels)")
    p.add_argument("--backend",
                   choices=["auto", "host", "native", "device", "dense",
                            "jump"],
                   default="auto",
                   help="compute backend: auto (default; on cuda the jump "
                        "scan, by the rule measured on the H100, and the "
                        "blocked dense scan for collections of 2^31 chars "
                        "or more; on cpu the JAX package's rule: native, "
                        "else host below 2 M chars and jump above), jump "
                        "(head-jumping scan over a reference index, the "
                        "CUDA ms_jump_scan kernel), dense (one joint suffix "
                        "sort of reference and collection; the CUDA "
                        "lcp_lift and dense_neighbors kernels), device (the "
                        "jump scan's heads expanded to every position, then "
                        "the host merge), native (the C++ OpenMP scan engine "
                        "and the host merge) or host (the Python spec scan, "
                        "for small inputs); the .log names the backend that "
                        "ran")
    p.add_argument("--lanes", type=int, default=Config.lanes,
                   help="parallel MS cursors of the jump scan "
                        "(default %(default)s)")
    p.add_argument("--block-chars", type=int, default=None,
                   help="dense backend: stream the collection in blocks of "
                        "this many chars (default: one joint sort, or blocks "
                        "sized by the memory guard when that would not fit "
                        "the device's free memory or CMSBWT_HBM_GB)")
    p.add_argument("--parallel", action="store_true",
                   help="dense backend: scan in blocks (of --block-chars, "
                        "default one per rank, capped by the phrase-chunk "
                        "cap and the memory guard); one card scans them one "
                        "after another, R > 1 ranks (the visible cards, or "
                        "a launcher's processes) in waves of R, one block "
                        "per rank (the mesh scan)")
    p.add_argument("--merge-backend",
                   choices=["auto", "host", "device", "sharded"],
                   default="auto",
                   help="downstream merge engine of the jump and dense "
                        "backends: device (sorted joins on the device), "
                        "host (numpy + native OpenMP) or auto (default: "
                        "the device merge, but the host merge for dense on "
                        "the cpu, above the card's merge memory ceiling and "
                        "for collections of 2^31 chars or more; "
                        "CMSBWT_MERGE_BACKEND=host|device overrides it) or "
                        "sharded (every stage spread over the ranks: the "
                        "visible cards, or a launcher's processes; int64, "
                        "for any collection size)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="dense backend: checkpoint/resume directory; the "
                        "scan's heads are saved there as one bundle and "
                        "each finished block of the scan (unblocked: the "
                        "whole collection as one block) as its own file, "
                        "and a rerun (of either package) loads them instead "
                        "of scanning; host/native: also holds the "
                        "reference-index cache")
    p.add_argument("--no-rle-quirk", action="store_true",
                   help="emit exact RLE(plain) instead of replicating the "
                        "reference RLE writer's multi-class residual bytes")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = Config(
        filename=args.filename,
        outname=args.outname,
        rle=args.rle,
        buffer_gib=args.buffer,
        prefix_length=args.prefix_length,
        backend=args.backend,
        lanes=args.lanes,
        dense_block_chars=args.block_chars,
        dense_parallel=args.parallel,
        merge_backend=args.merge_backend,
        checkpoint_dir=args.checkpoint_dir,
        replicate_reference_rle_quirk=not args.no_rle_quirk,
    )
    from .parallel import distributed
    distributed.maybe_initialize(device=args.device)
    say = print if distributed.is_primary() else (lambda *a: None)
    say("==== CMS-BWT (PyTorch/CUDA)")
    say(f"Input file: {cfg.filename}")
    say(f"Output basename: {cfg.resolved_outname()}")
    say(f"Prefix length: {cfg.prefix_length}")
    say(f"Output format: {'RLE' if cfg.rle else 'FULL'}")
    say(f"Device: {args.device}")
    t0 = time.time()
    from .engine.pipeline import compute_bwt
    out = compute_bwt(cfg, args.device)
    say(f"==== Wrote {out['out_path']} ({out['bytes']} bytes)")
    say(f"==== Time elapsed: {(time.time() - t0) * 1000:.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
