"""The benchmark's tiny cells through the whole run on a CUDA card: the
port's kernels, the trace of the card and the reference on it. Skips
without a card; on one:

    python3 -m pytest portbench/tests -m card -n 0
"""
import pytest

import benchtools


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # one copy, so that the port's kernels build once for these tests
    return benchtools.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.card
@pytest.mark.parametrize("cell", benchtools.tiny_cells())
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cells_on_the_card(card, root, cell, trace):
    from portbench import guard, harness
    guard.install()
    line = harness.run_cell(root, cell, 2**31 + 21, 1.0, trace)
    assert line["correct"] is True, line
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "device_idle_pct" in line["metrics"]
    else:
        assert line["metrics"]["peak_device_gib"]["value"] > 0
