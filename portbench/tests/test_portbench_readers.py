"""Each metric reader on a synthetic run: counters, phases and made traces
whose kernels, copies and host spans are known."""
import json

import pytest

from benchtools import ROOT, bench
from portbench import harness, roofline
from portbench.devtrace import JOB_SPAN, Trace, kernel_id


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def made_trace():
    """Two jobs in 0..1000 us and 1000..2000 us. Device: parse tile and
    finish kernels, a sort's two kernels, rle_pack, a copy and a memset;
    the rest idle. Host: the job spans, a span, an op."""
    events = [
        ev("user_annotation", JOB_SPAN, 0, 1000),
        ev("user_annotation", JOB_SPAN, 1000, 1000),
        ev("user_annotation", "portbench.transform", 10, 300),
        ev("cpu_op", "aten::copy_", 320, 20),
        ev("kernel", "void parse_tile_kernel<512>(unsigned char const*, "
           "long)", 400, 100),
        ev("kernel", "parse_finish_kernel(int*)", 500, 20),
        ev("kernel", "void radix_hist_kernel(unsigned int const*)", 600, 50),
        ev("kernel", "void radix_pass_kernel<8, 4>(int)", 640, 60),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1200, 100),
        ev("gpu_memset", "Memset (Device)", 1300, 50),
        ev("kernel", "rle_pack_kernel(int const*, unsigned char*)", 1500,
           200),
        ev("gpu_user_annotation", "portbench.transform", 0, 2000),
        ev("kernel", "outside_kernel()", 2500, 100),
    ]
    return Trace.from_events(events)


def made_run(trace=None):
    job = dict(wall_s=0.1, sn=1000, file_bytes=1100, read_s=0.02,
               rle=True, out_len=90, cpu_s=0.1, minflt=0)
    jobs = [harness.Job(input=i % 2, phases={"ms_scan": 0.01 * (i + 1),
                                             "merge_device": 0.03,
                                             "encode": 0.004},
                        runs=10 * (i + 1), index_s=0.05 + (i < 2),
                        version=i + 1, traced=i < 2, **job)
            for i in range(40)]
    jobs[-1].wall_s = 0.5
    return harness.Run(traffic={}, config={}, setup_s=12.5, window_s=4.0,
                       jobs=jobs, launches={"a": 300, "b": 100},
                       peak_bytes=3 * 2**30, trace=trace, skip_window=64)


def read(name, run):
    return harness.reader(ROOT, name)(run)


@pytest.mark.parametrize("name,want", [
    ("void radix_pass_kernel<8, 4>(int)", "radix_pass_kernel"),
    ("parse_finish_kernel(int*)", "parse_finish_kernel"),
    ("ns::k<1>(x)", "k"),
    # as CUPTI names the port's kernels and PyTorch's
    ("void (anonymous namespace)::radix_pass_kernel<8, unsigned int, 0>"
     "((anonymous namespace)::Pass)", "radix_pass_kernel"),
    ("(anonymous namespace)::parse_tile_kernel(unsigned char const*, long "
     "long)", "parse_tile_kernel"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() "
     "const::{lambda()#4}>(int, float)", "unrolled_elementwise_kernel"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_"
     "detail::cub::DeviceRadixSortPolicy<long, int>::Policy900, true>(int*)",
     "DeviceRadixSortOnesweepKernel"),
])
def test_kernel_id(name, want):
    assert kernel_id(name) == want


def test_copies_keep_their_names():
    t = Trace.from_events([ev("user_annotation", JOB_SPAN, 0, 10),
                           ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)",
                              1, 2)])
    assert t.top_ops() == [["Memcpy HtoD (Pinned -> Device)",
                            pytest.approx(2e-6)]]


def test_trace_busy_idle_and_breakdown():
    t = made_trace()
    assert (t.lo, t.hi, len(t.jobs)) == (0, 2000, 2)
    assert t.window_s == pytest.approx(2e-3)
    # 400-520 + 600-700 + 1200-1350 + 1500-1700 (outside_kernel is out)
    assert t.busy_s() == pytest.approx(570e-6)
    assert t.kernel_s(["rle_pack_kernel"]) == pytest.approx(200e-6)
    assert t.kernel_s(["radix_hist_kernel", "radix_pass_kernel"]) == \
        pytest.approx(110e-6)
    ops = dict(t.top_ops())
    assert ops["rle_pack_kernel"] == pytest.approx(200e-6)
    assert "outside_kernel" not in ops
    assert "portbench.transform" not in ops     # an annotation, not work
    assert t.gaps() == [(0, 400), (520, 600), (700, 1200), (1350, 1500),
                        (1700, 2000)]
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(2e-3 - 570e-6)
    assert gaps["portbench.transform"] == pytest.approx(400e-6)  # mid 200
    assert len(t.top_ops(2)) == 2


def test_trace_round_trip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("user_annotation", JOB_SPAN, 5, 10),
        ev("kernel", "k()", 6, 2)]}))
    t = Trace.load(path)
    assert t.busy_s() == pytest.approx(2e-6)


def test_end_to_end_readers():
    run = made_run()
    assert read("chars_per_s", run) == pytest.approx(40 * 1000 / 4.0 / 1e6)
    assert read("job_p95_ms", run) == pytest.approx(100.0, rel=0.5)
    assert read("job_p95_ms", run) >= 100.0
    assert read("peak_device_gib", run) == pytest.approx(3.0)
    assert read("setup_s", run) == 12.5


def test_p95_needs_twenty_jobs():
    run = made_run()
    run.jobs = run.jobs[:21]          # 19 of them untraced
    assert read("job_p95_ms", run) is None
    run.jobs = run.jobs[2:21]         # none traced: all 19 count
    assert read("job_p95_ms", run) is None
    run.jobs = made_run().jobs[2:22]
    assert read("job_p95_ms", run) == pytest.approx(100.0)


def test_untraced_runs_count_every_job():
    run = made_run()
    for j in run.jobs:
        j.traced = False
    assert read("index_ms", run) == pytest.approx(
        (2 * 1.05 + 38 * 0.05) / 40 * 1e3)


def test_program_readers():
    run = made_run()
    assert read("read_ms", run) == pytest.approx(20.0)
    # the traced jobs (the first two) are left out
    assert read("index_ms", run) == pytest.approx(50.0)
    assert read("scan_ms", run) == pytest.approx(
        sum(0.01 * (i + 1) for i in range(2, 40)) / 38 * 1e3)
    assert read("merge_ms", run) == pytest.approx(30.0)
    assert read("encode_ms", run) == pytest.approx(4.0)
    assert read("launches_per_job", run) == pytest.approx(400 / 40)


def test_trace_readers():
    run = made_run(made_trace())
    assert read("sort_ms", run) == pytest.approx(110e-3 / 2)
    moved = 2 * roofline.fasta_parse_bytes(1100, 1000, 64)
    assert read("fasta_parse_roofline", run) == pytest.approx(
        100 * moved / roofline.HBM_BYTES_PER_S / 120e-6)
    assert read("rle_pack_roofline", run) == pytest.approx(
        100 * roofline.rle_pack_bytes(10 + 20) / roofline.HBM_BYTES_PER_S
        / 200e-6)
    # 285 us busy a traced job over the untraced jobs' mean wall
    assert read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 285e-6 / ((37 * 0.1 + 0.5) / 38)))
    # a window that held only the traced jobs: the stretch's own time
    run.jobs = run.jobs[:2]
    assert read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 570 / 2000))


def test_bwt_expand_roofline():
    """The plain writer's two kernels over the traced .bwt jobs' runs and
    chars; .rl_bwt jobs and the untraced ones count nothing."""
    t = Trace.from_events([
        ev("user_annotation", JOB_SPAN, 0, 1000),
        ev("user_annotation", JOB_SPAN, 1000, 1000),
        ev("kernel", "void (anonymous namespace)::tile_starts_kernel(int "
           "const*, long long, int, long long, int2*, unsigned char*)",
           100, 30),
        ev("kernel", "(anonymous namespace)::bwt_expand_kernel(int const*)",
           130, 90),
        ev("kernel", "tile_starts_kernel()", 1100, 20),
        ev("kernel", "bwt_expand_kernel()", 1120, 60),
        ev("kernel", "rle_pack_kernel()", 1500, 40)])
    run = made_run(t)
    for j in run.jobs:
        j.rle = False
    run.jobs[1].rle = True
    moved = roofline.bwt_expand_bytes(10, 1000)
    assert moved == 5 * 10 + 1000
    assert read("bwt_expand_roofline", run) == pytest.approx(
        100 * moved / roofline.HBM_BYTES_PER_S / 200e-6)
    # no .bwt job traced: nothing to read, not 0
    run.jobs[0].rle = True
    assert read("bwt_expand_roofline", run) is None


@pytest.mark.parametrize("name", ["sort_ms", "fasta_parse_roofline",
                                  "rle_pack_roofline", "device_idle_pct",
                                  "bwt_expand_roofline"])
def test_nothing_to_read_gives_nothing(name):
    assert read(name, made_run()) is None
    empty = Trace.from_events([ev("user_annotation", JOB_SPAN, 0, 10)])
    assert read(name, made_run(empty)) is None


@pytest.mark.parametrize("name", ["read_ms", "index_ms", "scan_ms",
                                  "merge_ms", "encode_ms"])
def test_absent_counters_give_nothing(name):
    run = made_run()
    for j in run.jobs:
        j.read_s = j.index_s = None
        j.phases = {}
    assert read(name, run) is None


@pytest.mark.parametrize("key", ["end_to_end", "per_layer"])
def test_every_listed_metric_has_a_reader(key):
    for m in bench()[key]:
        assert callable(harness.reader(ROOT, m["name"]))
