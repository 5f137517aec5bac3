"""Independence checks: the JAX package stays out of every run, and the
plain reference stays out of the program.

Names are compared by their top-level part, whole: ``repro_torch`` (the
port) begins with ``repro`` (the JAX package) and is no match for it."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN_IN_RUN = frozenset({"jax", "jaxlib", "flax", "repro"})
FORBIDDEN_IN_REFERENCE = FORBIDDEN_IN_RUN | {"repro_torch"}


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if top(n) in FORBIDDEN_IN_RUN})


def imported_names(path: Path) -> List[str]:
    """Every absolute module name ``path`` imports (``import a.b``,
    ``from a.b import c``); relative imports stay inside their package."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def reference_violations(ref_dir: Path) -> List[str]:
    """``file: module`` for each import under ``ref_dir`` of jax, the JAX
    package or the port."""
    bad = []
    for path in sorted(Path(ref_dir).rglob("*.py")):
        for name in imported_names(path):
            if top(name) in FORBIDDEN_IN_REFERENCE:
                bad.append(f"{path.name}: {name}")
    return bad
