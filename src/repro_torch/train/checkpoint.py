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

Over a mesh (the reference's elastic re-sharding): a state whose leaves
are this rank's slices under ``specs`` (a tree of
`repro_torch.launch.mesh.ShardSpec` of the state's structure, e.g.
``(param_specs, optimizer.state_specs(param_specs))``) is saved as full
arrays, each gathered from every rank (`launch.mesh.gather_full`), and
the first rank writes them in the layout above while the others wait for
its ``COMMIT``; `restore` with ``mesh`` and ``specs`` gives each rank its
`launch.mesh.local_slice` under the current mesh's specs, whatever mesh
shape, or single process, saved the checkpoint.
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
from repro_torch.launch import mesh as mesh_lib


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


def _spec_paths(specs: Any, prefix: str = "") -> dict:
    """{path: ShardSpec} of a specs tree laid out as the state (paths as
    `_flatten` gives them; None entries are whole leaves)."""
    if specs is None or isinstance(specs, mesh_lib.ShardSpec):
        return {prefix: specs or mesh_lib.ShardSpec(())}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out = {}
    for key, sub in items:
        out.update(_spec_paths(sub, f"{prefix}/{key}"))
    return out


def _placements(leaves: list, mesh, specs) -> Optional[list]:
    """Each leaf's ShardSpec (None without a mesh)."""
    if mesh is None:
        return None
    by_path = _spec_paths(specs)
    missing = [path for path, _ in leaves if path not in by_path]
    if missing:
        raise ValueError(f"specs miss leaves {missing[:4]}")
    return [by_path[path] for path, _ in leaves]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(directory, step: int, tree: Any, *, keep: int = 3, mesh=None,
         specs: Any = None) -> Path:
    """Atomically save a state checkpoint for `step`; over ``mesh`` the
    state's leaves are this rank's slices under ``specs`` (collective:
    every rank calls it; the first writes)."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    leaves = _flatten(tree)
    placed = _placements(leaves, mesh, specs)
    if placed is not None:
        leaves = [(path, mesh_lib.gather_full(leaf.detach(), mesh, spec))
                  for (path, leaf), spec in zip(leaves, placed)]
        if mesh_lib.axes_position(mesh, mesh_lib.row_axes(mesh)) != 0:
            mesh_lib.barrier(mesh)          # the first rank's COMMIT
            return final
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

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
    if placed is not None:
        mesh_lib.barrier(mesh)
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
            device: DeviceLike = None, mesh=None, specs: Any = None) -> Any:
    """Restore into the structure of `example_tree` (see the module
    docstring for where each leaf lands).  The checkpoint must hold the
    example's leaf paths and shapes; with ``mesh`` and ``specs`` each
    example leaf is this rank's slice of the saved one."""
    directory = Path(directory) / f"step_{step:08d}"
    if not (directory / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {directory}")
    meta = json.loads((directory / "meta.json").read_text())
    example = _flatten(example_tree)
    placed = _placements(example, mesh, specs)
    saved = [(m["path"], tuple(m["shape"])) for m in meta["leaves"]]
    if placed is not None:
        saved = [(path, _local_shape(shape, mesh, spec))
                 for (path, shape), spec in zip(saved, placed)]
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
            value = _load_leaf(data[f"a{i}"], m["dtype"])
            if placed is not None:
                value = mesh_lib.local_slice(value, mesh, placed[i])
            value = value.to(device=dev, dtype=ex.dtype)
            if ex.device == dev:
                out.append(ex.copy_(value))
            else:
                out.append(value.requires_grad_(ex.requires_grad))
    return _unflatten(example_tree, iter(out))


def shard_state(tree: Any, mesh, specs: Any) -> Any:
    """A new state of ``tree``'s structure holding this rank's slices of
    its (full) leaves under ``specs`` (`launch.mesh.local_slice`)."""
    by_path = _spec_paths(specs)
    return _unflatten(tree, iter(
        [mesh_lib.local_slice(leaf.detach(), mesh, by_path[path])
         for path, leaf in _flatten(tree)]))


def _local_shape(shape, mesh, spec) -> tuple:
    """The shape of a rank's `launch.mesh.local_slice` of a ``shape``
    tensor under ``spec`` (a dimension that does not split keeps its size,
    and the restore's shape check then refuses it)."""
    out = list(shape)
    for d, axes in enumerate(spec.dims):
        n = mesh_lib.axes_size(mesh, axes) if axes else 1
        if d < len(out) and out[d] % n == 0:
            out[d] //= n
    return tuple(out)


__all__ = ["save", "restore", "latest_step", "shard_state"]
