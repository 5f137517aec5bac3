"""Multi-pod dry run: build every (arch x shape x mesh) cell and count it.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 (512) forced host devices and reads XLA's
memory and cost analyses and the post-SPMD HLO.  Eager PyTorch has no
such program, so the port counts what its cells say, with no device and
no process group:

  * bytes per rank: every input leaf (parameters, optimizer state,
    batch) at its ``meta`` shape, divided by the ranks of the mesh axes
    its `ShardSpec` names (a dimension that does not divide rounds up, as
    a padded shard); ``argument_size_in_bytes`` and ``bytes_per_device``,
    checked against the H100's 80 GB.  Temporaries are not known and not
    guessed (``temp_size_in_bytes`` null);
  * FLOPs: one call of ``cell.fn`` on the ``meta`` inputs under
    ``torch.utils.flop_counter.FlopCounterMode``, which counts
    matmul-class ops only (matrix products, convolutions, attention);
    the count is the whole mesh's, and per device it is that over the
    ranks.  A cell whose step runs collectives (``Cell.mesh_fn``) is
    counted through ``fn``, its one-process equivalent.  An op that
    cannot run on ``meta`` tensors (data-dependent shapes, ``.item()``)
    and a step with no matmul-class op leave the count null, with the
    reason in ``error``: never a silent zero;
  * no HLO, so no collective bytes and no ``t_collective_s``
    (``collectives_note`` says so).  `parse_collectives` and
    `effective_wire_bytes` are the reference's helpers, copied.

Roofline terms use NVIDIA's H100 SXM data-sheet peaks (dense bf16 989
TFLOP/s, float32 67 TFLOP/s, HBM 3.35 TB/s, 80 GB, at the 700 W power
limit): a spec sheet, not a measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \
      [--multipod] [--roofline] [--variant V] [--out runs/dryrun]
  python -m repro_torch.launch.dryrun --all [--multipod]

The module sets no environment variable and touches no device.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import families, registry
from repro_torch.launch.mesh import ShardSpec

# NVIDIA H100 SXM data sheet (dense, no sparsity; 700 W power limit)
H100 = "NVIDIA H100 80GB HBM3 (SXM), 700 W power limit: data-sheet peaks"
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_HBM_BW = 3.35e12        # bytes/s
H100_HBM_BYTES = 80e9

COLLECTIVE_RE = re.compile(
    r"=\s+([a-z0-9]+)\[([0-9,]*)\][^=]*?"
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}


def parse_collectives(hlo_text: str) -> dict:
    """Sum result-shape bytes per collective type from post-SPMD HLO."""
    out = {}
    for m in COLLECTIVE_RE.finditer(hlo_text):
        dtype, dims, op = m.group(1), m.group(2), m.group(3)
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        b = n * DTYPE_BYTES[dtype]
        rec = out.setdefault(op, {"count": 0, "result_bytes": 0})
        rec["count"] += 1
        rec["result_bytes"] += b
    return out


def effective_wire_bytes(collectives: dict, n_devices: int) -> float:
    """Ring-model per-device wire bytes (standard algorithm bandwidth)."""
    f = (n_devices - 1) / max(n_devices, 1)
    total = 0.0
    for op, rec in collectives.items():
        b = rec["result_bytes"]
        if op == "all-reduce":
            total += 2 * b * f
        elif op in ("all-gather", "reduce-scatter", "all-to-all"):
            total += b * f
        elif op == "collective-permute":
            total += b
    return total


def leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a tree of dicts, tuples and NamedTuples; a leaf
    is anything else (a tensor, a `ShardSpec`, a number)."""
    if isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, tuple) and not isinstance(tree, ShardSpec):
        fields = getattr(tree, "_fields", None)
        items = list(zip(fields or range(len(tree)), tree))
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += leaves(sub, f"{prefix}.{key}" if prefix else str(key))
    return out


def shard_bytes(t: torch.Tensor, spec: ShardSpec, mesh,
                stage_split: int = 1) -> int:
    """Bytes of one rank's block of ``t`` under ``spec`` (each split
    dimension rounded up), over ``stage_split`` pipeline stages."""
    shape = list(t.shape)
    for d, axes in enumerate(spec.dims):
        if axes:
            shape[d] = -(-shape[d] // mesh.axes_size(axes))
    return -(-math.prod(shape) // stage_split) * t.element_size()


def bytes_per_rank(cell: families.Cell, mesh) -> int:
    """Every tensor input's bytes on one rank under the cell's specs."""
    total = 0
    for arg, specs in zip(cell.args, cell.in_shardings):
        spec_of = dict(leaves(specs))
        for path, leaf in leaves(arg):
            if not isinstance(leaf, torch.Tensor):
                continue
            spec = spec_of[path] if path in spec_of else spec_of[""]
            split = 1
            if cell.stage_axis and (".layers." in f".{path}"):
                split = mesh.axes_size(cell.stage_axis)
            total += shard_bytes(leaf, spec, mesh, split)
    return total


def count_flops(cell: families.Cell) -> float:
    """Matmul-class FLOPs of one call of ``cell.fn`` on its meta inputs."""
    with FlopCounterMode(display=False) as counter:
        cell.fn(*cell.args)
    return float(counter.get_total_flops())


def _peak(cell: families.Cell) -> tuple:
    """(FLOP/s, label): bf16 where the cell's floating inputs hold bf16."""
    dts = {leaf.dtype for arg in cell.args for _, leaf in leaves(arg)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()}
    if torch.bfloat16 in dts:
        return H100_BF16_FLOPS, "bf16 dense 989 TFLOP/s"
    return H100_FP32_FLOPS, "float32 67 TFLOP/s"


def run_cell(arch: str, shape: str, multi_pod: bool,
             roofline: bool = False, scan_knob=None,
             variant=None) -> dict:
    mesh = families.production_mesh(multi_pod=multi_pod)
    entry = registry.get(arch)
    t0 = time.monotonic()
    cell = entry.build_cell(entry.config, entry.shapes[shape], mesh,
                            roofline=roofline, scan_knob=scan_knob,
                            variant=variant)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "devices": mesh.size, "card": H100,
           "build_s": round(time.monotonic() - t0, 2)}
    rec["argument_size_in_bytes"] = bytes_per_rank(cell, mesh)
    rec["temp_size_in_bytes"] = None           # not known in eager PyTorch
    rec["bytes_per_device"] = rec["argument_size_in_bytes"]
    rec["fits_hbm"] = rec["bytes_per_device"] <= H100_HBM_BYTES
    rec["donated"] = bool(cell.donate_argnums)
    rec["flops_counted"] = ("matmul-class ops only "
                            "(torch.utils.flop_counter), the whole mesh's")
    if cell.mesh_fn is not None:
        rec["flops_counted"] += "; counted on the one-process equivalent"
    t1 = time.monotonic()
    try:
        flops = count_flops(cell)
    except Exception as e:          # noqa: BLE001 — recorded, never a zero
        flops = None
        rec["error"] = (f"FLOPs not counted: {type(e).__name__}: "
                        f"{str(e)[:300]}")
    rec["count_s"] = round(time.monotonic() - t1, 2)
    if flops == 0:
        flops = None
        rec["error"] = "FLOPs not counted: the step has no matmul-class op"
    rec["matmul_flops"] = flops
    peak, label = _peak(cell)
    rec["peaks"] = {"flops": label, "hbm": "3.35 TB/s", "source": H100}
    if flops is not None:
        rec["matmul_flops_per_device"] = flops / mesh.size
        rec["t_compute_s"] = rec["matmul_flops_per_device"] / peak
    # each input byte read once: a lower bound (activations not counted)
    rec["t_memory_s"] = rec["bytes_per_device"] / H100_HBM_BW
    rec["collectives_note"] = ("eager PyTorch builds no HLO: collective "
                               "bytes and t_collective_s not computed")
    return rec


def run_roofline(arch: str, shape: str, variant=None) -> dict:
    """The cell at one microbatch on the single-pod mesh: FLOPs and the
    roofline terms; the memory fields are the pod record's."""
    rec = run_cell(arch, shape, multi_pod=False, roofline=True,
                   variant=variant)
    rec["roofline_method"] = "flop_counter"
    rec["variant"] = variant
    for k in ("argument_size_in_bytes", "temp_size_in_bytes",
              "bytes_per_device", "fits_hbm"):
        rec.pop(k, None)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="FLOPs at one microbatch (single-pod only)")
    ap.add_argument("--variant", default=None,
                    help="hillclimb variant (moe_a2a, tp_repl, micro2, ...)")
    ap.add_argument("--out", default="runs/dryrun")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(arch, shape) for arch in registry.REGISTRY
                 for shape in registry.get(arch).shapes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    for arch, shape in cells:
        tag = "multipod" if args.multipod else "pod"
        if args.roofline:
            tag = "roofline"
        if args.variant:
            tag += f"-{args.variant}"
        path = outdir / f"{arch}__{shape}__{tag}.json"
        if path.exists():
            print(f"[skip] {path}")
            continue
        print(f"[dryrun] {arch} x {shape} ({tag}) ...", flush=True)
        try:
            if args.roofline:
                rec = run_roofline(arch, shape, variant=args.variant)
            else:
                rec = run_cell(arch, shape, args.multipod,
                               variant=args.variant)
            rec["ok"] = True
        except Exception as e:  # noqa: BLE001 — recorded for triage
            rec = {"arch": arch, "shape": shape, "mesh": tag, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        path.write_text(json.dumps(rec, indent=2))
        status = "OK" if rec.get("ok") else f"FAIL: {rec.get('error')}"
        if rec.get("ok") and rec.get("error"):
            status += f" ({rec['error'][:120]})"
        print(f"[dryrun] {arch} x {shape} ({tag}) -> {status}", flush=True)


if __name__ == "__main__":
    main()
