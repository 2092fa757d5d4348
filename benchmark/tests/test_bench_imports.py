"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program: the sources (``ast``,
top-level names compared whole, so ``athenapk_tpu_torch`` is not
``athenapk_tpu``) and the modules a CPU run leaves loaded."""

import ast
import json
import subprocess
import sys

import pytest

from bench_helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "athenapk_tpu"}
BENCH = ROOT / "benchmark"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)
REFERENCE = [p for p in SOURCES if "reference" in p.relative_to(BENCH).parts]


def top_level_imports(path):
    """Top-level names of the absolute imports in ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_sources_import_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[str(p.relative_to(BENCH)) for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert not names & (FORBIDDEN | {"athenapk_tpu_torch", "benchmark"})


def _in_subprocess(code):
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.splitlines()[-1])


def test_cpu_run_loads_no_jax():
    loaded = _in_subprocess(
        "import json, sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from bench_helpers import run\n"
        "from benchmark.run import forbidden_modules\n"
        "run('linwave-mhd-uniform-256', 3)\n"
        "print(json.dumps(forbidden_modules()))\n")
    assert loaded == []


def test_reference_loads_nothing_of_the_program():
    loaded = _in_subprocess(
        "import json, sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from bench_helpers import small\n"
        "from benchmark.harness.spec import Cell\n"
        "for w in ('linwave-mhd-uniform-256',):\n"
        "    c = Cell(w)\n"
        "    s = c.reference().sim(c.deck(1, small(w, 8)), 'cpu')\n"
        "    u = s.initial_state()\n"
        "    dt, c_h = s.next_dt(u, 0.0, None)\n"
        "    s.cycle(u, dt, c_h, 0.0)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not set(loaded) & (FORBIDDEN | {"athenapk_tpu_torch"})
