"""Nothing under ``cutbench/`` imports JAX or the JAX package ``repro``,
compared by whole top-level module names (``repro_torch`` begins with
``repro``), nothing reads ``benchmarks/``, and the reference imports
nothing of the program."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    """Top-level names of every absolute import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(HERE)): sorted(set(_imports(p)) & FORBIDDEN)
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
    # whole names: the port itself is imported, and is not the JAX package
    assert "repro_torch" in {n for p in files for n in _imports(p)}


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((HERE / "reference").rglob("*.py")):
        names = set(_imports(p))
        assert "repro_torch" not in names and "cutbench" not in names, p
        tree = ast.parse(p.read_text())
        rel = [n for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.level > 1]
        assert not rel, p      # nothing from outside the reference folder
