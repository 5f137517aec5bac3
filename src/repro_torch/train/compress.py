"""int8 gradient compression with error feedback (distributed-optimization).

At multi-pod scale the gradient all-reduce crosses the slow pod axis; int8
quantization cuts those bytes 4x (vs f32 accumulators).  Classic error
feedback (Seide et al., 1-bit SGD; Karimireddy et al. EF-SGD) keeps the
compression unbiased-in-the-limit: the residual of each step's quantization
is added back before the next step's compression.

Counterpart of ``repro/train/compress.py``: per-tensor codes equal the
reference's bit for bit (``torch.round`` and ``jnp.round`` both round half
to even).  Left for later (ROADMAP queue 1, item 2):
``make_compressed_psum``, the int8 all-reduce over a mesh.
"""

from __future__ import annotations

from typing import Dict

import torch


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


__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress",
           "ef_step", "init_error_state"]
