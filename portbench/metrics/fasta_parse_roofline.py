"""fasta_parse_roofline: fasta_parse.cu's share of its roofline in the
traced stretch: the bytes it must move (the file read once, SX and its
window written once) over 3.35 TB/s, over the device time of
parse_tile_kernel and parse_finish_kernel."""
from portbench import roofline

KERNELS = ("parse_tile_kernel", "parse_finish_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    moved = sum(roofline.fasta_parse_bytes(j.file_bytes, j.sn,
                                           run.skip_window)
                for j in run.jobs if j.traced)
    return roofline.share_pct(moved, t.kernel_s(KERNELS))
