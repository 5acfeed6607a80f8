"""The port stands alone: no module of graph_hscn_tpu_torch/, not
chip_smoke.py and not the gloo ranks' tests/torch_dist.py imports JAX, its libraries or the JAX package (the card's
machine has no JAX).  Every import statement is read with ``ast``, those
inside functions too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "graph_hscn_tpu")
# tests/torch_dist.py runs the edge-partition tests' gloo ranks, which
# load the port alone.
SOURCES = sorted((ROOT / "graph_hscn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist.py"]


def imported_modules(source: str) -> list[str]:
    """Every module an ``import`` or ``from ... import`` in ``source``
    names, at any depth (relative imports stay inside the package)."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_sources_are_found():
    assert len(SOURCES) > 40
    assert ROOT / "graph_hscn_tpu_torch" / "runner.py" in SOURCES
    for name in ("mesh", "edge_partition", "sharded_gcn", "data_parallel",
                 "hybrid", "dryrun"):
        assert (ROOT / "graph_hscn_tpu_torch" / "parallel"
                / f"{name}.py") in SOURCES
    for name in ("loader", "native"):
        assert (ROOT / "graph_hscn_tpu_torch" / "data"
                / f"{name}.py") in SOURCES


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in imported_modules(path.read_text()) if forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_every_form():
    src = ("import jax.numpy as jnp\nfrom flax import linen\n"
           "def f():\n    import optax\n    from graph_hscn_tpu.ops "
           "import spmm\nimport graph_hscn_tpu_torch.runner\n"
           "from . import x\n")
    assert [m for m in imported_modules(src) if forbidden(m)] == [
        "jax.numpy", "flax", "optax", "graph_hscn_tpu.ops"]
