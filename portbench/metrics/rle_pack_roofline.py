"""rle_pack_roofline: run_output.cu's rle_pack_kernel's share of its
roofline in the traced stretch: 14 B a run (io/output.LAST_WRITE['runs'])
over 3.35 TB/s, over its device time."""
from portbench import roofline

KERNELS = ("rle_pack_kernel",)


def read(run):
    t = run.trace
    if t is None:
        return None
    moved = sum(roofline.rle_pack_bytes(j.runs) for j in run.jobs
                if j.traced and j.runs is not None and j.rle)
    return roofline.share_pct(moved, t.kernel_s(KERNELS))
