"""Import hygiene of the port: nothing under ``src/repro_torch/``, not
``chip_smoke.py`` and not the examples' twins (``examples/torch_*.py``)
imports ``jax`` or the JAX package ``repro`` (an AST scan, so a lazy
import inside a function is caught too)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(REPO).as_posix() for p in FILES}
    assert "src/repro_torch/core/store.py" in names
    assert "src/repro_torch/kernels/quadconv/ops.py" in names
    for module in ("kernels/attention/ops.py", "kernels/ssd/ops.py",
                   "models/lm.py", "serve/decode.py", "launch/serve.py",
                   "sim/reproducer.py", "ml/resnet.py", "sim/spectral.py",
                   "core/locktrack.py", "configs/quadconv_ae.py",
                   "sim/halo.py", "sim/distributed.py",
                   "core/deployment.py", "parallel/compress.py"):
        assert f"src/repro_torch/{module}" in names
    assert len([n for n in names if n.startswith("examples/torch_")]) == 5
    assert _imported_roots(REPO / "src" / "repro" / "core" / "store.py") \
        & {"jax"}
