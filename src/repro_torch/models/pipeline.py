"""Pipeline parallelism (GPipe) over a mesh axis (PyTorch).

Counterpart of ``repro/models/pipeline.py``.  The layer stack is split into
S contiguous stages, stage s held by the ranks at position s of the
pipeline axis.  Microbatches stream through: at tick t stage 0 ingests
microbatch t, every other stage takes the activation the previous stage
sent at tick t - 1, and the last stage writes microbatch t - (S - 1);
after each tick the activations move one hop forward around the ring
(`launch.mesh.ppermute`, whose backward sends the cotangents back, so
autograd runs the backward pipeline).  Bubble fraction = (S-1)/(n_micro +
S - 1).

SPMD: every rank of the axis runs the same ticks with the same shapes, and
the choice between the fed microbatch and the received state, and the
last stage's writes, are ``torch.where`` selections rather than branches,
so every rank's autograd graph has the same shape and its backward issues
the same point-to-point exchanges in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch import mesh as mesh_lib


def pipeline_apply(stage_fn: Callable, x_micro: torch.Tensor, *, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run the pipeline.

    x_micro:   (n_micro, mb, ...) this rank's microbatched activations
               (the same on every rank of ``axis``; a caller that shards
               the microbatch dim over other axes passes its share).
    stage_fn(h) -> y: applies THIS rank's stage (its layers), shape kept.

    Returns (n_micro, mb, ...): the last stage's outputs on every rank of
    the axis.  The closing broadcast is the reference's psum of the last
    stage's one-hot-masked buffer, as `launch.mesh.all_reduce_fwd`: its
    backward hands each rank the cotangent once, not S times."""
    axes = (axis,)
    n_stages = mesh_lib.axes_size(mesh, axes)
    stage = mesh_lib.axes_position(mesh, axes)
    n_micro = x_micro.shape[0]
    dev = x_micro.device
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == n_stages - 1, device=dev)
    state = torch.zeros_like(x_micro[0])          # in-flight activation
    outs = [torch.zeros_like(x_micro[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        feed = x_micro[min(t, n_micro - 1)]
        y = stage_fn(torch.where(is_first, feed, state))
        slot = t - (n_stages - 1)
        if slot >= 0:
            outs[slot] = torch.where(is_last, y, outs[slot])
        state = mesh_lib.ppermute(y, mesh, axis, 1)
    out = torch.stack(outs) * is_last.to(x_micro.dtype)
    return mesh_lib.all_reduce_fwd(out, mesh, axes)


__all__ = ["pipeline_apply"]
