"""Dense & MoE causal LM (counterpart of ``repro/models/transformer.py``).

The reference stacks layer parameters along a leading (n_layers,) axis and
scans them; the port keeps one module per layer (``layers.{i}.attn.wq``,
...), and `repro_torch.convert.transformer_params` splits a reference tree's
stacked leaves into them.  Weights are initialised from an explicit
``torch.Generator`` with the reference's shapes and scales (normal x scale,
ones for norms), drawn on the generator's device and then moved to the
model's, so a CPU generator's seed gives the same weights on every device
(a CUDA generator draws a large model on the card, in other bits);
``jax.random`` cannot be replayed, so parity with the reference goes
through `convert`.

A config with ``moe_experts`` set holds a `repro_torch.models.moe.Moe`
(``layers.{i}.moe``) in place of each layer's SwiGLU ``mlp``, with its
experts padded to a multiple of ``tp`` as in the reference.

Entry points (methods of `Transformer`):
  forward(tokens)                  logits + MoE aux loss for training
  loss(tokens, targets)            the forward part of ``loss_fn``
  prefill / decode_step            serving with a KV cache

Left for later (ROADMAP queue 1, item 2): the multi-device items
(``param_specs``, ``decode_param_specs``, ``fsdp_param_specs``,
``cache_specs``, ``abstract_params``, ``pipeline_forward``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import AttentionSpec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    # MoE (None = dense)
    moe_experts: Optional[int] = None
    moe_top_k: int = 8
    moe_d_ff: Optional[int] = None
    # system
    dtype: str = "bfloat16"
    tp: int = 1                 # tensor-parallel degree (padding target)
    vocab_pad_to: int = 512
    remat: bool = True
    kv_chunk: int = 1024
    scan_unroll: int = 1
    # activation sharding (the reference's; the port runs on one device)
    batch_axes: Optional[tuple] = None
    tp_axis: Optional[str] = "model"
    moe_impl: str = "einsum"
    mesh: Optional[object] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad_to) * self.vocab_pad_to

    @property
    def attn_spec(self) -> AttentionSpec:
        return AttentionSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            qk_norm=self.qk_norm, qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta, tp_pad_to=self.tp)

    @property
    def moe_spec(self) -> Optional[moe_lib.MoeSpec]:
        if self.moe_experts is None:
            return None
        return moe_lib.MoeSpec(
            d_model=self.d_model, d_ff=self.moe_d_ff or self.d_ff,
            n_experts=self.moe_experts, top_k=self.moe_top_k,
            ep_pad_to=self.tp, batch_axes=self.batch_axes,
            ep_axis=(self.tp_axis if self.batch_axes is not None
                     and self.tp > 1 else None),
            impl=self.moe_impl, mesh=self.mesh)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts is not None

    def param_count(self) -> int:
        """Approximate true (unpadded) parameter count."""
        a = self.d_model * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.is_moe:
            f = 3 * self.d_model * (self.moe_d_ff or self.d_ff) * self.moe_experts
            f += self.d_model * self.moe_experts
        else:
            f = 3 * self.d_model * self.d_ff
        emb = self.vocab * self.d_model * 2
        return self.n_layers * (a + f) + emb

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        a = self.d_model * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        f = 3 * self.d_model * (self.moe_d_ff or self.d_ff) * self.moe_top_k
        emb = self.vocab * self.d_model * 2
        return self.n_layers * (a + f) + emb


class Block(nn.Module):
    """One pre-norm layer: ``attn_norm``, ``attn``, ``mlp_norm`` and
    ``mlp`` (dense) or ``moe`` (MoE)."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        dt = cfg.torch_dtype
        self.attn_norm = layers.make_ones((cfg.d_model,), device, dt)
        self.mlp_norm = layers.make_ones((cfg.d_model,), device, dt)
        self.attn = layers.Attention(cfg.attn_spec, generator, device, dt)
        if cfg.is_moe:
            self.moe = moe_lib.Moe(cfg.moe_spec, generator, device, dt)
        else:
            self.mlp = layers.Mlp(cfg.d_model, cfg.d_ff, generator, device,
                                  dt)

    def forward(self, x, cfg: TransformerConfig, positions, *, causal=True,
                cache=None) -> tuple:
        """(x out, new_kv, aux): aux is the MoE load-balancing loss, 0 on
        the dense path."""
        h, new_kv = self.attn(layers.rms_norm(x, self.attn_norm),
                              positions=positions, causal=causal, cache=cache,
                              kv_chunk=cfg.kv_chunk)
        x = x + h
        if cfg.is_moe:
            h, aux = self.moe(layers.rms_norm(x, self.mlp_norm))
        else:
            h = self.mlp(layers.rms_norm(x, self.mlp_norm))
            aux = torch.zeros((), device=x.device)
        return x + h, new_kv, aux


class Transformer(nn.Module):
    """Parameters ``embed`` (padded_vocab, d_model), ``layers.{i}``,
    ``final_norm`` and ``unembed`` (d_model, padded_vocab), as in the
    reference's tree."""

    def __init__(self, cfg: TransformerConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        dt = cfg.torch_dtype
        self.cfg = cfg
        emb_scale = 1.0 / math.sqrt(cfg.d_model)
        self.embed = layers.make_param((cfg.padded_vocab, cfg.d_model),
                                       emb_scale, gen, dev, dt)
        self.layers = nn.ModuleList(Block(cfg, gen, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = layers.make_ones((cfg.d_model,), dev, dt)
        self.unembed = layers.make_param((cfg.d_model, cfg.padded_vocab),
                                         emb_scale, gen, dev, dt)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def hidden(self, tokens, *, causal: bool = True) -> tuple:
        """tokens (B, S) -> (final-normed hidden states (B, S, d_model),
        the MoE aux loss summed over the layers)."""
        tokens = self._tokens(tokens)
        x = self.embed[tokens]
        positions = torch.arange(tokens.shape[1], device=self.device)[None, :]
        aux = torch.zeros((), device=self.device)
        for blk in self.layers:
            x, _, a = blk(x, self.cfg, positions, causal=causal)
            aux = aux + a
        return layers.rms_norm(x, self.final_norm), aux

    @torch.no_grad()
    def forward(self, tokens) -> tuple:
        """Training forward: tokens (B, S) -> (logits (B, S, padded_vocab),
        MoE aux loss averaged over the layers: 0 on the dense path)."""
        x, aux = self.hidden(tokens)
        return torch.matmul(x, self.unembed), aux / self.cfg.n_layers

    @torch.no_grad()
    def loss(self, tokens, targets, *, aux_weight: float = 0.01) -> torch.Tensor:
        """Mean next-token NLL over the real vocabulary (the reference's
        ``loss_fn``)."""
        logits, aux = self.forward(tokens)
        logits = logits.float()
        mask = torch.arange(logits.shape[-1], device=logits.device) < \
            self.cfg.vocab
        logits = torch.where(mask[None, None, :], logits, -1e30)
        logp = torch.log_softmax(logits, dim=-1)
        tgt = self._tokens(targets)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        return nll.mean() + aux_weight * aux

    def init_cache(self, batch: int, max_len: int) -> dict:
        """KV cache: k, v (n_layers, B, max_len, kv_heads, d_head), len 0."""
        spec = self.cfg.attn_spec
        shape = (self.cfg.n_layers, batch, max_len, spec.padded_kv_heads,
                 spec.d_head)
        z = lambda: torch.zeros(shape, dtype=self.cfg.torch_dtype,
                                device=self.device)
        return {"k": z(), "v": z(), "len": 0}

    @torch.no_grad()
    def prefill(self, tokens, max_len: int) -> tuple:
        """Full-sequence (causal) prefill building the cache; returns
        (logits (B, S, padded_vocab), cache)."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        cache = self.init_cache(b, max_len)
        x = self.embed[tokens]
        positions = torch.arange(s, device=self.device)[None, :]
        for i, blk in enumerate(self.layers):
            x, (nk, nv), _ = blk(x, self.cfg, positions)
            cache["k"][i, :, :s] = nk.to(cache["k"].dtype)
            cache["v"][i, :, :s] = nv.to(cache["v"].dtype)
        x = layers.rms_norm(x, self.final_norm)
        cache["len"] = s
        return torch.matmul(x, self.unembed), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict) -> tuple:
        """tokens (B, s) + cache -> (logits (B, padded_vocab) of the last
        position, cache).  The port writes the new keys and values into
        ``cache``'s tensors in place; the returned dict shares them."""
        tokens = self._tokens(tokens)
        s = tokens.shape[1]
        n = int(cache["len"])
        x = self.embed[tokens]
        positions = n + torch.arange(s, device=self.device)[None, :]
        for i, blk in enumerate(self.layers):
            x, _, _ = blk(x, self.cfg, positions,
                          cache=(cache["k"][i], cache["v"][i], n))
        x = layers.rms_norm(x, self.final_norm)
        logits = torch.matmul(x[:, -1, :], self.unembed)
        return logits, {"k": cache["k"], "v": cache["v"], "len": n + s}


__all__ = ["TransformerConfig", "Block", "Transformer"]
