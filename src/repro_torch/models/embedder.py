"""Text embedding model for the RAG service: mean-pooled bidirectional
transformer encoder over hashed tokens, unit-normalized output.

Counterpart of ``repro/models/embedder.py``, the in-framework stand-in for
gtr-t5-base / MiniLM: the protocol and benchmarks only need *some* shared
embedding model both sides can run; its dimension is what the paper's
theory cares about.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.models.transformer import Transformer, TransformerConfig


def encoder_config(dim: int = 768, *, vocab: int = 32768,
                   n_layers: int = 4) -> TransformerConfig:
    """d_head 128 and max(4, dim // 128) heads: at dim 256 the heads span
    512 != d_model, as in the reference."""
    return TransformerConfig(
        name=f"embedder-{dim}", n_layers=n_layers, d_model=dim,
        n_heads=max(4, dim // 128), n_kv_heads=max(4, dim // 128),
        d_ff=dim * 4, vocab=vocab, d_head=128, dtype="float32", remat=False)


class Embedder(nn.Module):
    """The encoder's weights (a `Transformer` under ``model``; its unembed
    is carried, as in the reference's tree, and unused) and `embed`."""

    def __init__(self, cfg: TransformerConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        self.model = Transformer(cfg, generator=generator, device=device)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.no_grad()
    def embed(self, tokens, mask=None) -> torch.Tensor:
        """tokens (B, S) -> unit-norm embeddings (B, d_model), float32 on
        the embedder's device.

        Bidirectional (the chunked attention without a causal mask, RoPE
        at positions 0..S-1), final rms_norm, then mean pool: over every
        position, pads included, when ``mask`` is None (as the service
        calls it), else over the positions ``mask`` (B, S) weights."""
        x, _ = self.model.hidden(tokens, causal=False)
        if mask is not None:
            m = torch.as_tensor(mask, device=x.device).to(x.dtype)
            x = x * m[..., None]
            pooled = x.sum(1) / torch.clamp(m.sum(1)[:, None], min=1.0)
        else:
            pooled = x.mean(dim=1)
        return pooled / (torch.linalg.vector_norm(pooled, dim=-1,
                                                  keepdim=True) + 1e-6)

    def forward(self, tokens, mask=None) -> torch.Tensor:
        return self.embed(tokens, mask)


__all__ = ["encoder_config", "Embedder"]
