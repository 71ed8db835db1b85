"""No module of the benchmark imports JAX, its libraries or the JAX
package (top-level names compared whole: the port's own name begins with
the JAX package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "uvc_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "uvc_tpu_torch" not in set(_imports(path))


def test_forbidden_check_compares_whole_names(monkeypatch):
    import sys
    from uvcbench import run
    monkeypatch.setitem(sys.modules, "uvc_tpu_torch_like", object())
    assert "uvc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "uvc_tpu.configs", object())
    assert "uvc_tpu" in run.forbidden_modules()
