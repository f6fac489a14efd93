"""The guard against JAX, and that no module of the benchmark imports it."""
import ast
import subprocess
import sys

import pytest

from benchtools import ROOT
from portbench import guard


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib",
                                  "jaxlib.xla_client", "flax", "cmsbwt_tpu",
                                  "cmsbwt_tpu.models.cms_bwt"])
def test_refuses(name):
    assert guard.forbidden(name)
    with pytest.raises(ImportError, match="refused by the benchmark"):
        guard.NoJax().find_spec(name)


@pytest.mark.parametrize("name", ["cmsbwt_tpu_torch",
                                  "cmsbwt_tpu_torch.models.cms_bwt",
                                  "torch", "numpy", "jaxx", "cmsbwt"])
def test_passes(name):
    assert not guard.forbidden(name)
    assert guard.NoJax().find_spec(name) is None


def test_loaded_lists_forbidden(monkeypatch):
    monkeypatch.setitem(sys.modules, "cmsbwt_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "cmsbwt_tpu_torch.fake", object())
    got = guard.loaded()
    assert "cmsbwt_tpu.fake" in got
    assert "cmsbwt_tpu_torch.fake" not in got


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "portbench").rglob("*.py")))
def test_no_module_imports_jax(path):
    bad = [m for m in _imports(ROOT / path) if guard.forbidden(m)
           or m.split(".")[0] in ("chip_smoke", "bench", "tools")]
    assert not bad, f"{path} imports {bad}"


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run on the CPU through run.py's guard leaves no forbidden
    module in sys.modules."""
    code = (
        "import sys, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
        "from portbench import guard\n"
        "guard.install()\n"
        "import benchtools\n"
        f"root = benchtools.tiny_copy(pathlib.Path({str(tmp_path)!r}))\n"
        "line = benchtools.run_tiny(root, 'tiny_s', seconds=0.2)\n"
        "assert line['correct'], line\n"
        "print('LOADED', guard.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_run_without_a_card_prints_nothing(tmp_path):
    """run.py exits non-zero with no result where no card is visible."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "sars10k_r", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
