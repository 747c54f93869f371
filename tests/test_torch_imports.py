"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or anything of the reference package."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for line, name in _imports(p)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
