"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, and no module of it (nor ``chip_smoke.py`` and
``chip_serve_ab.py``, which drive it on the card, nor the port's
examples) imports either."""

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
#: scripts that drive the port: run as programs, never imported as modules
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "chip_serve_ab.py",
           ROOT / "examples" / "quickstart_torch.py",
           ROOT / "examples" / "serve_private_bert_torch.py"]


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
    for m in ("repro_torch.core.session", "repro_torch.net.party",
              "repro_torch.net.faults", "repro_torch.net.resilience",
              "repro_torch.serve.gateway", "repro_torch.sched.schedulers",
              "repro_torch.sched.speculation", "repro_torch.accel.sim",
              "repro_torch.accel.energy", "repro_torch.analysis.cli",
              "repro_torch.analysis.secretflow",
              "repro_torch.analysis.jit_hygiene"):
        assert m in names, m


@pytest.mark.parametrize("path", SCRIPTS[2:], ids=[p.stem for p in SCRIPTS[2:]])
def test_example_loads_neither_jax_nor_repro(path):
    """Load an example as a module (its ``main`` is not run) in a fresh
    interpreter: it and everything it imports stay clear of JAX."""
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", MODULES + SCRIPTS,
                         ids=[_module_name(p) for p in MODULES]
                         + [p.stem for p in SCRIPTS])
def test_module_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path.name} imports {bad}"
