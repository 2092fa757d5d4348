"""The port stands alone: no module of ``athenapk_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib`` or ``athenapk_tpu``; nor do the
card tests and their deck helper, which run where only the port is
installed.

Checked on the sources with ``ast``, because an interpreter may have jax
in ``sys.modules`` already at start-up, which would make a runtime check
prove nothing.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "athenapk_tpu")
SOURCES = sorted((ROOT / "athenapk_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "torch_decks.py"]


def _is_forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_sources_exist():
    assert len(SOURCES) > 10
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [f"{path.name}:{line}: {mod}" for line, mod in _imports(path)
           if _is_forbidden(mod)]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "core/amr_forest.py", "refinement/prolong_restrict.py", "amr/smr.py",
    "amr/smr_hydro.py", "amr/driver.py", "refinement/criteria.py",
    "amr/remesh.py", "diffusion/diffusion.py", "utils/few_modes_ft.py",
    "pgen/turbulence.py", "pgen/rand_blast.py", "pgen/diffusion.py",
    "outputs/hdf5.py", "outputs/restart.py", "tracers/tracers.py",
    "tracers/smr_tracers.py"])
def test_refined_mesh_modules_are_checked(module):
    """The refined-mesh slices' modules (static and adaptive), the forest
    binding among them, the diffusion and forcing modules, and the output,
    restart and tracer modules (which replace numpy-only or jax modules of
    the JAX package with copies of their own) are among the sources
    checked above."""
    assert ROOT / "athenapk_tpu_torch" / module in SOURCES


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom athenapk_tpu.core import x\n"
                   "import athenapk_tpu_torch\nimportlib.import_module('jaxlib')\n")
    found = [mod for _, mod in _imports(src) if _is_forbidden(mod)]
    assert found == ["jax.numpy", "athenapk_tpu.core", "jaxlib"]
