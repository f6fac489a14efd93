"""The readers of the program's spans (portbench/spans.py and the metrics
index_load_ms, index_build_ms, read_file_ms, encode_copy_ms,
merge_idle_ms) on a made trace whose program spans, benchmark spans and
device intervals are known, beside a made table of the program's spans
(utils/timing.SPANS), on a trace without program spans and a program
without the table, and in a traced tiny run on the CPU through the jump
route and the device merge."""
import pathlib

import pytest

import benchtools
from benchtools import ROOT
from cmsbwt_tpu_torch.utils import timing
from portbench import guard, harness, spans
from portbench.devtrace import JOB_SPAN, Trace

NEW = ["index_load_ms", "index_build_ms", "read_file_ms", "encode_copy_ms",
       "merge_idle_ms"]


def ev(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def prog(name, ts, dur):
    return ev("user_annotation", "cmsbwt." + name, ts, dur)


def made_events():
    """Two jobs in 0..1000 and 1000..2000 us. The first builds the index
    (0..300) and transforms (300..1000); the second transforms. Device:
    20-30, 100-150, 240-290, 600-700, 1500-1990, each with its launch;
    idle gaps' middles at 10 (index.load), 65 and 195 (index.sa), 445
    (parse.read.file), 1100 (the second job's merge_device), 1995 (no
    program span)."""
    events = [
        ev("user_annotation", JOB_SPAN, 0, 1000),
        ev("user_annotation", JOB_SPAN, 1000, 1000),
        ev("user_annotation", "portbench.index", 0, 300),
        ev("user_annotation", "portbench.transform", 300, 700),
        ev("user_annotation", "portbench.transform", 1000, 1000),
        prog("index.load", 0, 50),
        prog("index.build", 60, 190),
        prog("index.sa", 60, 140),
        prog("transform", 300, 690),
        prog("parse.read", 300, 200),
        prog("parse.read.file", 310, 90),
        prog("parse.read.file", 410, 70),
        prog("merge_device", 500, 300),
        prog("merge.fixup", 500, 100),
        prog("encode", 800, 190),
        prog("encode.download", 800, 100),
        prog("encode.tobytes", 900, 50),
        prog("transform", 1000, 990),
        prog("merge_device", 1000, 200),
        ev("cpu_op", "aten::copy_", 1010, 20),
    ]
    for k, (t0, t1, launch) in enumerate([(20, 30, 5), (100, 150, 70),
                                          (240, 290, 210), (600, 700, 560),
                                          (1500, 1990, 1400)]):
        events.append(ev("cuda_runtime", "cudaLaunchKernel", launch, 3,
                         correlation=k))
        events.append(ev("kernel", f"k{k}()", t0, t1 - t0, correlation=k))
    return events


def plain_run():
    job = dict(input=0, wall_s=0.1, sn=1000, file_bytes=1100, phases={},
               read_s=0.02, runs=10, rle=True, index_s=0.05, out_len=90,
               version=1, cpu_s=0.1, minflt=0)
    return harness.Run(traffic={}, config={}, setup_s=1.0, window_s=1.0,
                       jobs=[harness.Job(traced=i < 2, **job)
                             for i in range(4)],
                       launches={}, peak_bytes=None, trace=None,
                       skip_window=64)


def made_run(events):
    run = plain_run()
    run.trace = Trace.from_events(events)
    return run


def read(name, run):
    return harness.reader(ROOT, name)(run)


# host ms a job run outside the profiler spends in each span
UNTRACED_MS = {"index.load": 10.0, "parse.read.file": 20.0,
               "encode.download": 30.0, "encode.tobytes": 5.0}


def fill_table(untraced: int = 3) -> None:
    """The program's table after ``untraced`` jobs outside the profiler
    (UNTRACED_MS each); the traced jobs' spans are in the trace alone."""
    timing.reset()
    table = timing.SPANS
    rows = [(n, ms * 1e-3) for n, ms in UNTRACED_MS.items()
            for _ in range(untraced)]
    rows += [("transform", 0.5)] * untraced
    for n, s in rows:
        row = table.setdefault(n, [0.0, 0])
        row[0] += s
        row[1] += 1


@pytest.fixture(autouse=True)
def clean_table():
    timing.reset()
    yield
    timing.reset()


def test_program_spans_nest_parents_first():
    t = Trace.from_events(made_events())
    got = spans.program(t)
    assert got[:3] == [(0, 50, "index.load"), (60, 250, "index.build"),
                       (60, 200, "index.sa")]
    assert len(got) == 14


def test_idle_by_span():
    t = Trace.from_events(made_events())
    by = spans.idle_by_span(t)
    assert by == pytest.approx({"index.load": 20e-6, "index.sa": 160e-6,
                                "parse.read.file": 310e-6,
                                "merge_device": 800e-6, "": 10e-6})
    assert sum(by.values()) == pytest.approx(
        t.window_s - t.busy_s())
    # every gap's middle lies inside a call of the benchmark
    assert spans.idle_by_span(t, spans.CALLS) == pytest.approx(by)
    assert spans.idle_by_span(t, ["portbench.index"]) == pytest.approx(
        {"index.load": 20e-6, "index.sa": 160e-6})


@pytest.mark.parametrize("prefix,want", [
    ("merge_device", 800e-6), ("index.build", 160e-6), ("index", 180e-6),
    ("parse.read", 310e-6), ("transform", 1110e-6), ("merge", 0.0),
    ("encode", 0.0)])
def test_idle_under(prefix, want):
    t = Trace.from_events(made_events())
    assert spans.idle_s_under(t, prefix) == pytest.approx(want)


def test_device_until_the_call_ends():
    t = Trace.from_events(made_events())
    # 100-150 and 240-290: from index.build's start to portbench.index's
    # end; 20-30 ran before it
    assert spans.device_s_until(t, "index.build", "portbench.index") == \
        pytest.approx(100e-6)
    assert spans.device_s_until(t, "index.build", "portbench.none") == 0


@pytest.mark.parametrize("name,want", [
    ("index_load_ms", 10.0), ("index_build_ms", 100e-3 / 2),
    ("read_file_ms", 20.0), ("encode_copy_ms", 35.0),
    ("merge_idle_ms", 800e-3 / 2)])
def test_readers_on_a_made_trace(name, want):
    fill_table()
    assert read(name, made_run(made_events())) == pytest.approx(want)


@pytest.mark.parametrize("untraced", [1, 7])
def test_untraced_spans_are_read_per_job(untraced):
    run = made_run(made_events())
    fill_table(untraced)
    for n, ms in UNTRACED_MS.items():
        assert spans.untraced_ms_per_job(run, [n]) == pytest.approx(ms)
    assert spans.untraced_ms_per_job(run, ["encode.download",
                                           "encode.tobytes"]) == \
        pytest.approx(35.0)
    # no job outside the profiler: nothing to read
    fill_table(0)
    assert spans.untraced_ms_per_job(run, ["index.load"]) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_prints_the_idle_by_program_span(name, capsys):
    fill_table()
    read(name, made_run(made_events()))
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("idle by program span: ")


def test_the_idle_line_is_printed_once_a_trace(capsys):
    run = made_run(made_events())
    for name in NEW:
        read(name, run)
    assert capsys.readouterr().err.count("idle by program span: ") == 1


def test_merge_idle_prints_the_idle_by_program_span(capsys):
    read("merge_idle_ms", made_run(made_events()))
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("idle by program span: ")
    words = err[0].split()
    at = {w: float(words[i + 1]) for i, w in enumerate(words)
          if w in ("idle_s", "in_calls_s", "staged_s", "staged_pct")}
    assert at["idle_s"] == pytest.approx(1300e-6)
    assert at["in_calls_s"] == pytest.approx(1300e-6)
    assert at["staged_s"] == pytest.approx(1290e-6)
    assert at["staged_pct"] == pytest.approx(100 * 1290 / 1300)
    assert '"merge_device": ' in err[0]


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_gives_nothing(name):
    """An older program records no span: each reader gives None."""
    events = [e for e in made_events()
              if not e["name"].startswith("cmsbwt.")]
    assert read(name, made_run(events)) is None
    assert read(name, plain_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_table_gives_nothing(name, monkeypatch,
                                                   capsys):
    """An older program's utils/timing has no SPANS: each reader gives None
    and does not raise."""
    monkeypatch.delattr(timing, "__getattr__")
    assert not hasattr(timing, "SPANS")
    events = [e for e in made_events()
              if not e["name"].startswith("cmsbwt.")]
    assert read(name, made_run(events)) is None
    assert "idle by program span" not in capsys.readouterr().err


@pytest.mark.parametrize("name", NEW)
def test_listed_with_their_cells(name):
    """Each lists the cells it was made for (the index's readers only the
    cell that builds the index a job); cells added later may join."""
    m = {m["name"]: m for m in benchtools.bench()["per_layer"]}[name]
    assert m["moves"] == "chars_per_s"
    want = (["ecoli100_r"] if name.startswith("index")
            else ["ecoli100_r", "sars10k_r"])
    assert m["workloads"][:len(want)] == want
    if name.startswith("index"):
        assert "sars10k_r" not in m["workloads"]


def test_traced_jump_run_reports_them(tmp_path, capsys):
    """A traced tiny run of the per-job-index cell on the jump route with
    the device merge (the cells' route on a card) reports each of them
    but index_build_ms: the CPU has no device intervals to read."""
    root = benchtools.tiny_copy(tmp_path)
    guard.install()
    line = harness.run_cell(pathlib.Path(root), "tiny_e", 2**31 + 25, 0.5,
                            True, device="cpu",
                            program={"backend": "jump"})
    assert line["correct"] is True
    assert sorted(set(NEW) & set(line["metrics"])) == sorted(
        set(NEW) - {"index_build_ms"})
    assert line["metrics"]["merge_idle_ms"]["value"] >= 0
    assert "idle by program span: " in capsys.readouterr().err
