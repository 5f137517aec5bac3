"""int8 gradient compression with error feedback (distributed-optimization).

At multi-pod scale the gradient all-reduce crosses the slow pod axis; int8
quantization cuts those bytes 4x (vs f32 accumulators).  Classic error
feedback (Seide et al., 1-bit SGD; Karimireddy et al. EF-SGD) keeps the
compression unbiased-in-the-limit: the residual of each step's quantization
is added back before the next step's compression.

Counterpart of ``repro/train/compress.py``: per-tensor codes equal the
reference's bit for bit (``torch.round`` and ``jnp.round`` both round half
to even), and so does `make_compressed_psum`, the int8 all-reduce over
mesh axes.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.launch import mesh as mesh_lib


def quantize_int8(x: torch.Tensor) -> tuple:
    """Per-tensor symmetric absmax int8 quantization; returns (q, scale)."""
    absmax = torch.max(torch.abs(x))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """Roundtrip for error-feedback math (local simulation of the wire)."""
    q, s = quantize_int8(x)
    return dequantize_int8(q, s)


def ef_step(grad: torch.Tensor, error: torch.Tensor) -> tuple:
    """One error-feedback step: returns (compressed_grad, new_error)."""
    corrected = grad.to(torch.float32) + error
    sent = compress_decompress(corrected)
    return sent, corrected - sent


def init_error_state(grads_like: Dict[str, torch.Tensor]) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}


def make_compressed_psum(mesh, axes: tuple):
    """int8-quantized all-reduce of partial gradients over ``axes`` of
    ``mesh`` (`repro_torch.launch.mesh.make_mesh`): a transform of a dict
    of this rank's partial gradients into their sums, the same on every
    rank along ``axes``; every rank calls it in lockstep.

    Per tensor: the ranks share the largest absmax scale (an all-reduce
    MAX), each quantizes its part to ``clip(round(part / scale), -127,
    127)``, the codes are summed as int32 (an all-reduce SUM, as the
    reference's ``psum`` of int32 codes) and the sum is dequantized.  The
    reference's ``shard_map`` contract (one slice of a stacked leading
    axis per participant) becomes one rank's own tensor."""
    axes = tuple(axes)

    def leaf_psum(local: torch.Tensor) -> torch.Tensor:
        _, s = quantize_int8(local)
        s_max = mesh_lib.all_reduce(s, mesh, axes, op="max")
        q = torch.clamp(torch.round(local / s_max), -127, 127)
        acc = mesh_lib.all_reduce(q.to(torch.int32), mesh, axes)
        return acc.to(torch.float32) * s_max

    def transform(grads: Dict[str, torch.Tensor]) -> dict:
        return {k: leaf_psum(g) for k, g in grads.items()}

    return transform


__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress",
           "ef_step", "init_error_state", "make_compressed_psum"]
