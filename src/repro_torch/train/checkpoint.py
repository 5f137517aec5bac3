"""Fault-tolerant checkpointing (npz + JSON).

Counterpart of ``repro/train/checkpoint.py``, with its layout:

    <dir>/step_<N>/
        meta.json           leaf paths, shapes, dtypes, step
        shard_0.npz         the leaves as numpy arrays (one host shard)
        COMMIT              written last; a checkpoint without COMMIT is
                            incomplete and ignored by `latest_step`

written under ``.tmp_step_<N>`` and renamed into place, with the oldest
committed checkpoints beyond ``keep`` removed.  Two things differ: the
meta is JSON (the reference's msgpack is not a dependency of the port),
and numpy has no bfloat16, so a bfloat16 tensor is stored as its uint16
view with ``bfloat16`` in the meta.

A state is a tree of dicts, tuples (NamedTuples included) and lists with
tensors at the leaves, e.g. ``(params, opt_state)``.  `restore` loads a
checkpoint into the structure of an example state: each leaf takes the
example leaf's dtype and lands on ``device`` (default: the example leaf's
device); a leaf whose example already lies there is filled in place, so a
module whose parameters are in the state holds the restored values.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """[(path, leaf)] in the tree's order: dict keys as they iterate,
    sequence positions in order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a "
                        f"{type(tree).__name__}, not a tensor")
    out = []
    for key, sub in items:
        out += _flatten(sub, f"{prefix}/{key}")
    return out


def _unflatten(example: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """``example``'s structure with its leaves taken from ``leaves`` in
    `_flatten`'s order."""
    if isinstance(example, torch.Tensor):
        return next(leaves)
    if isinstance(example, dict):
        return {k: _unflatten(v, leaves) for k, v in example.items()}
    items = [_unflatten(v, leaves) for v in example]
    if isinstance(example, list):
        return items
    return type(example)(*items) if hasattr(example, "_fields") else \
        tuple(items)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(directory, step: int, tree: Any, *, keep: int = 3) -> Path:
    """Atomically save a state checkpoint for `step`."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = _flatten(tree)
    arrays = {}
    meta_leaves = []
    for i, (path, leaf) in enumerate(leaves):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        arrays[f"a{i}"] = arr
        meta_leaves.append({"path": path, "shape": list(t.shape),
                            "dtype": _dtype_name(t.dtype)})
    np.savez(tmp / "shard_0.npz", **arrays)
    meta = {"step": step, "n_leaves": len(leaves), "leaves": meta_leaves}
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int) -> None:
    steps = sorted(p for p in directory.glob("step_*") if (p / "COMMIT").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p)


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "COMMIT").exists()]
    return max(steps) if steps else None


def _load_leaf(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def restore(directory, step: int, example_tree: Any, *,
            device: DeviceLike = None) -> Any:
    """Restore into the structure of `example_tree` (see the module
    docstring for where each leaf lands).  The checkpoint must hold the
    example's leaf paths and shapes."""
    directory = Path(directory) / f"step_{step:08d}"
    if not (directory / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {directory}")
    meta = json.loads((directory / "meta.json").read_text())
    example = _flatten(example_tree)
    saved = [(m["path"], tuple(m["shape"])) for m in meta["leaves"]]
    want = [(path, tuple(leaf.shape)) for path, leaf in example]
    if saved != want:
        raise ValueError(f"checkpoint {directory} holds another state: "
                         f"{len(saved)} leaves (path, shape) against the "
                         f"example's {len(want)}, or other paths or shapes")
    target = None if device is None else resolve_device(device)
    out = []
    with np.load(directory / "shard_0.npz") as data:
        for i, ((_, ex), m) in enumerate(zip(example, meta["leaves"])):
            dev = ex.device if target is None else target
            value = _load_leaf(data[f"a{i}"], m["dtype"]).to(
                device=dev, dtype=ex.dtype)
            if ex.device == dev:
                out.append(ex.copy_(value))
            else:
                out.append(value.requires_grad_(ex.requires_grad))
    return _unflatten(example_tree, iter(out))


__all__ = ["save", "restore", "latest_step"]
