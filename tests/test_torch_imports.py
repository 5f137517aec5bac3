"""Import hygiene of the port: with JAX made unimportable, every
``repro_torch`` module and every module ``chip_smoke.py`` imports must
load, no module of the JAX package may be loaded, and no kernel build may
start (kernels build at their first launch, never at import)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHECK = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                 # any `import jax` now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for must in ("repro_torch.launch.serve", "repro_torch.serve.engine",
             "repro_torch.obs.trace", "repro_torch.serve.admission",
             "repro_torch.models.embedder", "repro_torch.core.attacks",
             "repro_torch.examples.private_rag_serve",
             "repro_torch.models.moe", "repro_torch.configs.registry"):
    assert must in names, must
for name in names:
    importlib.import_module(name)
for stmt in sys.argv[1:]:                 # chip_smoke.py's import statements
    exec(stmt, {})
from repro_torch.kernels import ext
assert ext.builds_started() == 0, ext.build_info
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
assert sys.modules["jax"] is None
print(len(names))
"""


def _chip_smoke_imports() -> list:
    """Every import statement in chip_smoke.py (top level and inside its
    functions), plus the module itself."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    stmts = {"import chip_smoke"}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) and not (
                isinstance(node, ast.ImportFrom)
                and node.module == "__future__"):
            stmts.add(ast.unparse(node))
    return sorted(stmts)


def test_port_and_chip_smoke_import_without_jax_or_repro():
    stmts = _chip_smoke_imports()
    assert "from repro_torch.crypto import rlwe" in stmts
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", CHECK, *stmts], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 59


def test_port_sources_never_name_jax_or_repro():
    """Static check beside the runtime one: no `import jax` / `from repro.`
    in the port or in chip_smoke.py."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (f, name)
