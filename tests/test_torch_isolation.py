"""The port stands alone: no module of ``athenapk_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib`` or ``athenapk_tpu``; nor do the
card tests and their deck helper, which run where only the port is
installed, nor the rank functions of the multi-rank tests, which run in
spawned processes that import only the port.

And the port's imports point one way: down the layers of ``LAYERS``.

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
    ROOT / "tests" / "torch_decks.py", ROOT / "tests" / "torch_dist_workers.py"]


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
    "tracers/smr_tracers.py", "parallel/__init__.py",
    "parallel/mesh_sharding.py", "parallel/halo.py", "parallel/dryrun.py",
    "tracers/sharded.py", "amr/sharded.py"])
def test_refined_mesh_modules_are_checked(module):
    """The refined-mesh slices' modules (static and adaptive), the forest
    binding among them, the diffusion and forcing modules, the output,
    restart and tracer modules (which replace numpy-only or jax modules of
    the JAX package with copies of their own) and the multi-rank modules
    are among the sources checked above."""
    assert ROOT / "athenapk_tpu_torch" / module in SOURCES


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom athenapk_tpu.core import x\n"
                   "import athenapk_tpu_torch\nimportlib.import_module('jaxlib')\n")
    found = [mod for _, mod in _imports(src) if _is_forbidden(mod)]
    assert found == ["jax.numpy", "athenapk_tpu.core", "jaxlib"]


# The port's layers, bottom to top (README's module map draws them).  A
# module imports its own layer or lower ones, inside functions too.
LAYERS = (
    ("core", "config", "utils", "__init__"),
    ("eos", "recon", "riemann", "srcterms", "diffusion", "refinement"),
    ("solver",),
    ("amr", "tracers", "outputs", "pgen", "parallel"),
    ("deck",),
    ("amr.driver",),
    ("driver",),
    ("kernel_ab",),
)


def _layer(parts):
    """The layer (1 at the bottom) of the port's module ``parts`` (its
    dotted name below the package, as a tuple); the package itself is in
    the bottom one."""
    for key in (".".join(parts[:2]), parts[0] if parts else "__init__"):
        for n, names in enumerate(LAYERS):
            if key in names:
                return n + 1
    raise KeyError(".".join(parts))


def _port_imports(path: Path, package: Path):
    """``(line, parts)`` of every import of the port's modules in ``path``
    (a module of ``package``), relative or absolute, at any depth: the
    module imported from, with each imported name (a name may be a
    module)."""
    own = path.relative_to(package).with_suffix("").parts
    pkg = list(own[:-1])
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
            elif (node.module or "").split(".")[0] == package.name:
                base = []
            else:
                continue
            mod = base + (node.module.split(".") if node.module else [])
            if not node.level:
                mod = mod[1:]
            for alias in node.names:
                yield node.lineno, tuple(mod + [alias.name])
        elif isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                if parts[0] == package.name:
                    yield node.lineno, tuple(parts[1:])


def _upward_imports(package: Path):
    bad = []
    for path in sorted(package.rglob("*.py")):
        own = _layer(path.relative_to(package).with_suffix("").parts)
        for line, parts in _port_imports(path, package):
            if _layer(parts) > own:
                bad.append(f"{path.relative_to(package)}:{line}: "
                           f"{'.'.join(parts)} (layer {_layer(parts)} "
                           f"above {own})")
    return bad


def test_imports_point_down_the_layers():
    assert not _upward_imports(ROOT / "athenapk_tpu_torch")


def test_layer_check_catches_an_upward_import(tmp_path):
    package = tmp_path / "athenapk_tpu_torch"
    (package / "eos").mkdir(parents=True)
    (package / "eos" / "m.py").write_text(
        "from ..core import kernels\nfrom . import adiabatic\n"
        "from ..solver import sweep\n\n\ndef f():\n"
        "    from ..driver import resolve_device\n"
        "    from athenapk_tpu_torch.amr.driver import SmrSimulation\n")
    (package / "deck.py").write_text("from .amr import driver\n")
    found = [line.split(" (")[0] for line in _upward_imports(package)]
    assert found == ["deck.py:1: amr.driver", "eos/m.py:3: solver.sweep",
                     "eos/m.py:7: driver.resolve_device",
                     "eos/m.py:8: amr.driver.SmrSimulation"]
