"""bwt_expand_roofline: run_output.cu's plain writer's share of its
roofline in the traced stretch: tile_starts_kernel and bwt_expand_kernel,
5 B a run (io/output.LAST_WRITE['runs']) and 1 B a char of the .bwt (the
job's sn) over 3.35 TB/s, over their device time."""
from portbench import roofline

KERNELS = ("tile_starts_kernel", "bwt_expand_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    moved = sum(roofline.bwt_expand_bytes(j.runs, j.sn) for j in run.jobs
                if j.traced and j.runs is not None and not j.rle)
    return roofline.share_pct(moved, t.kernel_s(KERNELS)) if moved else None
