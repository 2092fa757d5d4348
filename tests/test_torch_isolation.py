"""The port stands alone: no module of ``athenapk_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib`` or ``athenapk_tpu``.

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
    ROOT / "chip_smoke.py"]


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


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom athenapk_tpu.core import x\n"
                   "import athenapk_tpu_torch\nimportlib.import_module('jaxlib')\n")
    found = [mod for _, mod in _imports(src) if _is_forbidden(mod)]
    assert found == ["jax.numpy", "athenapk_tpu.core", "jaxlib"]
