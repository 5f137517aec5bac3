"""``BENCHMARK.json`` and the files it names, found by name.

A cell is ``cells/<name>.json``; its configuration ``configs/<name>.json``
(the sizes as run) with ``configs/<name>.py`` beside it (the program,
``make_program``, or for the retrieval round only the code that makes
its inputs from the seed, ``make_inputs``); its traffic mix
``traffic/<name>.json``; each metric ``metrics/<name>.py`` (a reader with
``read(run) -> float | None``).  Adding a cell, configuration, mix or
metric adds files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold ``.`` and ``-``)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module {name!r} ({path})")
    mod_name = "rag_bench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> Optional[bool]:
    cells = metric.get("workloads")
    return None if cells is None else cell in cells


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics ``cell`` reports (``--trace 0``)."""
    return [m for m in bench["end_to_end"] if _applies(m, cell) is not False]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics ``cell`` reports (``--trace 1``): those that
    list it, and those without a list whose moved metric it reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        a = _applies(m, cell)
        if a or (a is None and m["moves"] in moved):
            out.append(m)
    return out
