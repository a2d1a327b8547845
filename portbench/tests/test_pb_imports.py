"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import re
import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tencent_recommendation_2025_tpu"}
IMPORT = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)


def _imports(path):
    return {m.split(".")[0] for m in IMPORT.findall(path.read_text())}


def test_sources_import_nothing_forbidden():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not {m for m in _imports(path)
                    if m.startswith("tencent_recommendation")}, path


def test_a_run_loads_nothing_forbidden():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
        "import tiny\n"
        "from portbench import run, calibrate\n"
        "tiny.run(tiny.cell('flagship.train'))\n"
        "tiny.run(tiny.cell('flagship.serve'))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "tencent_recommendation_2025_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
