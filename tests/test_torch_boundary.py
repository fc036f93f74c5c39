"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, and no module of it (nor ``chip_smoke.py`` and
``chip_serve_ab.py``, which drive it on the card) imports either."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(PKG.rglob("*.py"))


def _module_name(path: Path) -> str:
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_import_leaves_jax_and_repro_unloaded():
    names = [_module_name(p) for p in MODULES]
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'loaded': len(sys.modules), 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "repro_torch.core.session" in names


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", MODULES + [ROOT / "chip_smoke.py",
                                            ROOT / "chip_serve_ab.py"],
                         ids=[_module_name(p) for p in MODULES]
                         + ["chip_smoke", "chip_serve_ab"])
def test_module_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path.name} imports {bad}"
