"""Independence: no run loads jax or the JAX package ``repro`` (names
compared whole: the port, ``repro_torch``, is no match), and the plain
reference imports neither of them nor the port."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

from rag_bench import guard

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.serve.engine", "reproducible",
             "jaxtyping", "repro", "repro.serve", "jax.numpy", "flax",
             "jaxlib.xla_client"]
    assert guard.loaded_forbidden(names) == [
        "flax", "jax.numpy", "jaxlib.xla_client", "repro", "repro.serve"]


def test_the_reference_imports_no_jax_no_repro_no_port():
    assert guard.reference_violations(ROOT / "rag_bench" / "reference") == []
    names = set()
    for path in (ROOT / "rag_bench" / "reference").glob("*.py"):
        names.update(guard.imported_names(path))
    assert {"numpy", "torch"} <= {guard.top(n) for n in names}


def test_the_scan_finds_a_forbidden_import(tmp_path):
    (tmp_path / "a.py").write_text("import numpy\nfrom repro_torch.core "
                                   "import planner\n")
    (tmp_path / "b.py").write_text("from repro.core import planner\n"
                                   "from . import a\n")
    assert guard.reference_violations(tmp_path) == [
        "a.py: repro_torch.core", "b.py: repro.core"]


def test_a_run_loads_neither_jax_nor_repro():
    code = textwrap.dedent(f"""
        import io, json, sys
        sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                         {str(ROOT / 'rag_bench' / 'tests')!r}]
        import torch
        torch.set_num_threads(1)
        from conftest import SMALL_RAG
        from rag_bench import guard, harness
        out = harness.run_cell("rag768-paced", seed=3, seconds=1.0,
                               trace=False, device="cpu",
                               config_overrides=SMALL_RAG, log=io.StringIO())
        print(json.dumps([out["correct"], guard.loaded_forbidden()]))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    correct, found = json.loads(res.stdout.strip().splitlines()[-1])
    assert found == [] and correct
