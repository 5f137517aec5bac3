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

`DeepseekV2Config` (no counterpart in the reference) builds DeepSeek-V2's
stack: latent attention (`repro_torch.models.layers.MlaAttention`) in
every layer, ``first_dense_layers`` SwiGLU layers and then MoE layers with
DeepSeek's gate, dropless dispatch and shared experts; its cache holds
each layer's normed latent and roped k_pe (``ckv``, ``kpe``) in place of
per-head keys and values.  `init_by_name` draws such a model's weights
tensor by tensor from sub-seeds of its parameters' names, so that a plain
reference can redraw any one of them.

Entry points (methods of `Transformer`):
  forward(tokens)                  logits + MoE aux loss for training
  loss(tokens, targets)            ``loss_fn``: differentiable
  prefill / decode_step            serving with a KV cache (no autograd);
                                   a decode step reports to a ``probe``

Parameters are built with ``requires_grad`` off, as a serving model holds
no autograd state; a trainer turns it on (``model.requires_grad_(True)``,
`repro_torch.launch.train.make_lm_run`).  With ``cfg.remat`` and autograd
recording, `hidden` checkpoints each `Block`
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
scanned layer): a layer's activations are recomputed in the backward
pass instead of kept.

Multi-device items: ``param_specs`` (2D FSDP x TP), ``decode_param_specs``,
``fsdp_param_specs`` and ``cache_specs`` are the reference's sharding
specs as maps from the port's parameter names (cache keys) to
`repro_torch.launch.mesh.ShardSpec`s, the reference's leading stacked-layer
entry dropped from the parameters' (one module per layer; the KV cache
keeps its layer axis); `expert_parallel_specs` is the layout of the
``shard_a2a`` MoE path (experts over the EP axis, everything else
replicated); `shard_params` gives each rank its slices of a model, and
`abstract_params` the reference's shapes and dtypes as ``meta`` tensors.
A config with ``moe_impl="shard_a2a"`` and a ``mesh`` runs its MoE layers
through `repro_torch.models.moe.moe_fwd_sharded`: each rank feeds its batch
shard and holds its experts (`shard_params` with `expert_parallel_specs`).
GPipe training (`pipeline_stage`, `pipeline_forward`, `pipeline_loss`,
the reference's ``pipeline_forward`` / ``pipeline_loss_fn``) splits the
layers into stages over a pipeline axis through
`repro_torch.models.pipeline.pipeline_apply`.  Sharded compute over the
other layouts (the lowered cells) is still to port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import ShardSpec, local_slice
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import AttentionSpec
from repro_torch.models.pipeline import pipeline_apply

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
    # sharding: batch and TP/EP axes of the mesh (the MoE's shard_a2a path)
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

    def layer_is_moe(self, i: int) -> bool:
        """Whether layer ``i`` holds a MoE (every layer of a MoE config)."""
        return self.is_moe

    @property
    def mla_spec(self) -> Optional[layers.MlaSpec]:
        """Latent attention's spec, or None: GQA (`AttentionSpec`)."""
        return None

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


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config(TransformerConfig):
    """DeepSeek-V2's decoder (the published ``modeling_deepseek.py``):
    latent attention with ``kv_lora_rank``, q direct (no q compression),
    heads of ``qk_nope_dim`` + ``qk_rope_dim`` for q·k and ``v_head_dim``
    for v, YaRN rope on the rope dimensions; ``first_dense_layers`` SwiGLU
    layers of ``d_ff``, then MoE layers of ``moe_experts`` experts of
    ``moe_d_ff`` (top ``moe_top_k`` of a softmax, not renormalised, times
    ``routed_scaling``), dropless, with a shared SwiGLU of
    ``moe_shared_d_ff``.  ``n_kv_heads`` and ``d_head`` are unused."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_scaling: Optional[layers.YarnScaling] = None
    first_dense_layers: int = 1
    moe_shared_d_ff: Optional[int] = None
    routed_scaling: float = 1.0

    def layer_is_moe(self, i: int) -> bool:
        return self.is_moe and i >= self.first_dense_layers

    @property
    def mla_spec(self) -> layers.MlaSpec:
        return layers.MlaSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            kv_lora_rank=self.kv_lora_rank, qk_nope_dim=self.qk_nope_dim,
            qk_rope_dim=self.qk_rope_dim, v_head_dim=self.v_head_dim,
            rope_theta=self.rope_theta, rope_scaling=self.rope_scaling)

    @property
    def moe_spec(self) -> Optional[moe_lib.MoeSpec]:
        if self.moe_experts is None:
            return None
        return moe_lib.DroplessMoeSpec(
            d_model=self.d_model, d_ff=self.moe_d_ff or self.d_ff,
            n_experts=self.moe_experts, top_k=self.moe_top_k,
            routed_scale=self.routed_scaling,
            shared_d_ff=self.moe_shared_d_ff)

    def _attn_params(self) -> int:
        h, d = self.n_heads, self.d_model
        return (d * h * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank
                + self.kv_lora_rank * h * (self.qk_nope_dim + self.v_head_dim)
                + h * self.v_head_dim * d + 2 * d)

    def _moe_params(self, experts: int) -> int:
        d, f = self.d_model, self.moe_d_ff or self.d_ff
        return (d * self.moe_experts + 3 * d * f * experts
                + 3 * d * (self.moe_shared_d_ff or 0))

    def param_count(self, experts: Optional[int] = None) -> int:
        """Every parameter (norms, the latent's norm and the shared
        experts included), with ``experts`` routed experts a MoE layer
        (all by default)."""
        moe = self.n_layers - self.first_dense_layers
        return (self.n_layers * self._attn_params()
                + self.first_dense_layers * 3 * self.d_model * self.d_ff
                + moe * self._moe_params(experts or self.moe_experts)
                + 2 * self.vocab * self.d_model + self.d_model)

    def active_param_count(self) -> int:
        return self.param_count(self.moe_top_k)


class Block(nn.Module):
    """One pre-norm layer: ``attn_norm``, ``attn`` (GQA, or latent
    attention where the config has an ``mla_spec``), ``mlp_norm`` and
    ``mlp`` (dense) or ``moe`` (MoE; whether layer ``index`` holds one is
    ``cfg.layer_is_moe(index)``)."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device: torch.device, index: int = 0):
        super().__init__()
        dt = cfg.torch_dtype
        self.attn_norm = layers.make_ones((cfg.d_model,), device, dt)
        self.mlp_norm = layers.make_ones((cfg.d_model,), device, dt)
        mla = cfg.mla_spec
        if mla is None:
            self.attn = layers.Attention(cfg.attn_spec, generator, device, dt)
        else:
            self.attn = layers.MlaAttention(mla, generator, device, dt)
        self.is_moe = cfg.layer_is_moe(index)
        if self.is_moe:
            self.moe = moe_lib.Moe(cfg.moe_spec, generator, device, dt)
        else:
            self.mlp = layers.Mlp(cfg.d_model, cfg.d_ff, generator, device,
                                  dt)

    def forward(self, x, cfg: TransformerConfig, positions, *, causal=True,
                cache=None, probe=None) -> tuple:
        """(x out, new_kv, aux): aux is the MoE load-balancing loss, 0 on
        the dense path.  ``probe`` (serving traces) gets a mark after the
        attention ("mla" or "attn") and after the MLP ("moe" or "mlp")."""
        h, new_kv = self.attn(layers.rms_norm(x, self.attn_norm),
                              positions=positions, causal=causal, cache=cache,
                              kv_chunk=cfg.kv_chunk)
        x = x + h
        if probe is not None:
            probe.mark("attn" if isinstance(self.attn, layers.Attention)
                       else "mla")
        if self.is_moe:
            h, aux = self.moe(layers.rms_norm(x, self.mlp_norm), probe=probe)
        else:
            h = self.mlp(layers.rms_norm(x, self.mlp_norm))
            aux = torch.zeros((), device=x.device)
        if probe is not None:
            probe.mark("moe" if self.is_moe else "mlp")
        return x + h, new_kv, aux


def _block_out(blk: Block, x, cfg: TransformerConfig, positions,
               causal: bool) -> tuple:
    """(x out, aux) of one layer: the unit `Transformer.hidden` remats."""
    x, _, aux = blk(x, cfg, positions, causal=causal)
    return x, aux


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
        self.layers = nn.ModuleList(Block(cfg, gen, dev, i)
                                    for i in range(cfg.n_layers))
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
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.layers:
            if remat:
                x, a = checkpoint.checkpoint(_block_out, blk, x, self.cfg,
                                             positions, causal,
                                             use_reentrant=False)
            else:
                x, a = _block_out(blk, x, self.cfg, positions, causal)
            aux = aux + a
        return layers.rms_norm(x, self.final_norm), aux

    def forward(self, tokens) -> tuple:
        """Training forward: tokens (B, S) -> (logits (B, S, padded_vocab),
        MoE aux loss averaged over the layers: 0 on the dense path)."""
        x, aux = self.hidden(tokens)
        return torch.matmul(x, self.unembed), aux / self.cfg.n_layers

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

    @property
    def cache_keys(self) -> tuple:
        """The cache's two per-layer tensors: keys and values, or latent
        attention's normed latent and roped k_pe."""
        return ("k", "v") if self.cfg.mla_spec is None else ("ckv", "kpe")

    def init_cache(self, batch: int, max_len: int) -> dict:
        """KV cache: k, v (n_layers, B, max_len, kv_heads, d_head), len 0;
        under latent attention ckv (n_layers, B, max_len, kv_lora_rank)
        and kpe (n_layers, B, max_len, qk_rope_dim)."""
        cfg, mla = self.cfg, self.cfg.mla_spec
        head = (cfg.attn_spec.padded_kv_heads, cfg.attn_spec.d_head)
        widths = ((head, head) if mla is None else
                  ((mla.kv_lora_rank,), (mla.qk_rope_dim,)))
        cache = {key: torch.zeros((cfg.n_layers, batch, max_len) + w,
                                  dtype=cfg.torch_dtype, device=self.device)
                 for key, w in zip(self.cache_keys, widths)}
        cache["len"] = 0
        return cache

    @torch.no_grad()
    def prefill(self, tokens, max_len: int, *, last_only: bool = False,
                cache: Optional[dict] = None) -> tuple:
        """Full-sequence (causal) prefill building the cache; returns
        (logits (B, S, padded_vocab), cache), or with ``last_only`` the
        last position's logits (B, padded_vocab) alone (the head runs on
        that position only).  ``cache``: tensors of `init_cache` (B,
        max_len) to write into in place of new ones."""
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        keys = self.cache_keys
        if cache is None:
            cache = self.init_cache(b, max_len)
        else:
            cache = {key: cache[key] for key in keys}
        x = self.embed[tokens]
        positions = torch.arange(s, device=self.device)[None, :]
        for i, blk in enumerate(self.layers):
            x, new, _ = blk(x, self.cfg, positions)
            for key, t in zip(keys, new):
                cache[key][i, :, :s] = t.to(cache[key].dtype)
        if last_only:
            x = x[:, -1]
        x = layers.rms_norm(x, self.final_norm)
        cache["len"] = s
        return torch.matmul(x, self.unembed), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, *, probe=None) -> tuple:
        """tokens (B, s) + cache -> (logits (B, padded_vocab) of the last
        position, cache).  The port writes the new keys and values into
        ``cache``'s tensors in place; the returned dict shares them.
        ``cache["len"]`` may be a 0-d device tensor, read on the device
        (so that the step can be captured in a CUDA graph and replayed).
        ``probe`` (serving traces): see `Block.forward` and
        `repro_torch.models.moe.moe_fwd`."""
        tokens = self._tokens(tokens)
        s = tokens.shape[1]
        n = cache["len"]
        if not torch.is_tensor(n):
            n = int(n)
        keys = self.cache_keys
        x = self.embed[tokens]
        positions = n + torch.arange(s, device=self.device)[None, :]
        for i, blk in enumerate(self.layers):
            x, _, _ = blk(x, self.cfg, positions, probe=probe,
                          cache=(cache[keys[0]][i], cache[keys[1]][i], n))
        x = layers.rms_norm(x, self.final_norm)
        logits = torch.matmul(x[:, -1, :], self.unembed)
        return logits, {keys[0]: cache[keys[0]], keys[1]: cache[keys[1]],
                        "len": n + s}


def param_seed(seed: int, name: str) -> int:
    """The 63-bit seed of parameter ``name``'s draw: the first 8 bytes of
    BLAKE2b over ``"<seed>/<name>"``, little-endian, shifted right once."""
    digest = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def init_by_name(model: "Transformer", seed: int, device: DeviceLike = None
                 ) -> "Transformer":
    """Draw every parameter of ``model`` (built on any device, ``meta``
    too) anew on ``device``, in place, each from its own generator on
    ``device`` seeded with ``param_seed(seed, name)``: a vector is 1 +
    0.1 x normal (the norms, so that each weight shows); a matrix or stack
    of them normal x 1/sqrt(its input width, ``shape[-2]``), the
    embedding (vocab, d) normal x 1/sqrt(d); drawn in float32, then cast
    to the config's dtype.  Returns ``model``."""
    dev = resolve_device(device)
    dt = model.cfg.torch_dtype
    for name, param in list(model.named_parameters()):
        shape = tuple(param.shape)
        g = torch.Generator(device=dev).manual_seed(param_seed(seed, name))
        w = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
        if len(shape) == 1:
            w = (1.0 + 0.1 * w).to(dt)
        else:
            fan_in = shape[-1] if name == "embed" else shape[-2]
            w = (w / math.sqrt(fan_in)).to(dt)
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        setattr(owner, leaf, nn.Parameter(w, requires_grad=False))
    return model


# ---------------------------------------------------------------------------
# shapes and sharding specs
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> dict:
    """One layer's parameter shapes under the port's names (the reference's
    ``_layer_params`` tree without the stacked-layer axis)."""
    spec = cfg.attn_spec
    d, dh = cfg.d_model, spec.d_head
    hq, hkv = spec.padded_heads * dh, spec.padded_kv_heads * dh
    out = {"attn_norm": (d,), "mlp_norm": (d,), "attn.wq": (d, hq),
           "attn.wk": (d, hkv), "attn.wv": (d, hkv), "attn.wo": (hq, d)}
    if cfg.qkv_bias:
        out.update({"attn.bq": (hq,), "attn.bk": (hkv,), "attn.bv": (hkv,)})
    if cfg.qk_norm:
        out.update({"attn.q_norm": (dh,), "attn.k_norm": (dh,)})
    if cfg.is_moe:
        e, f = cfg.moe_spec.padded_experts, cfg.moe_spec.d_ff
        out.update({"moe.router": (d, e), "moe.w_gate": (e, d, f),
                    "moe.w_up": (e, d, f), "moe.w_down": (e, f, d)})
    else:
        out.update({"mlp.w_gate": (d, cfg.d_ff), "mlp.w_up": (d, cfg.d_ff),
                    "mlp.w_down": (cfg.d_ff, d)})
    return out


def abstract_params(cfg: TransformerConfig) -> dict:
    """{parameter name: ``meta`` tensor} with the reference's shapes (per
    layer) and the config's dtype, in a `Transformer`'s state-dict order;
    allocates nothing."""
    meta = lambda shape: torch.empty(shape, dtype=cfg.torch_dtype,
                                     device="meta")
    out = {"embed": meta((cfg.padded_vocab, cfg.d_model)),
           "final_norm": meta((cfg.d_model,)),
           "unembed": meta((cfg.d_model, cfg.padded_vocab))}
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": meta(v)
                    for k, v in _layer_shapes(cfg).items()})
    return out


def _spec_map(cfg: TransformerConfig, top: dict, layer: dict) -> dict:
    """Name -> ShardSpec from the top-level specs and one layer's (its
    entries without the stacked-layer axis), in `abstract_params`' order."""
    out = dict(top)
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": ShardSpec.of(*layer[k])
                    for k in _layer_shapes(cfg)})
    return out


def _attn_extras(cfg: TransformerConfig, bias, norm) -> dict:
    out = {}
    if cfg.qkv_bias:
        out.update({"attn.bq": bias[0], "attn.bk": bias[1],
                    "attn.bv": bias[2]})
    if cfg.qk_norm:
        out.update({"attn.q_norm": norm, "attn.k_norm": norm})
    return out


_S = ShardSpec.of


def param_specs(cfg: TransformerConfig, *, fsdp_axis="data",
                tp_axis="model") -> dict:
    """Training layout, 2D FSDP x TP (the reference's ``param_specs``):
    projections split on their input over ``fsdp_axis`` and their output
    over ``tp_axis`` (``wo`` the other way), experts over ``tp_axis``."""
    f, m = fsdp_axis, tp_axis
    layer = {"attn_norm": (None,), "mlp_norm": (None,),
             "attn.wq": (f, m), "attn.wk": (f, m), "attn.wv": (f, m),
             "attn.wo": (m, f),
             **_attn_extras(cfg, ((m,), (m,), (m,)), (None,))}
    if cfg.is_moe:
        layer.update({"moe.router": (None, None), "moe.w_gate": (m, f, None),
                      "moe.w_up": (m, f, None), "moe.w_down": (m, None, f)})
    else:
        layer.update({"mlp.w_gate": (f, m), "mlp.w_up": (f, m),
                      "mlp.w_down": (m, f)})
    return _spec_map(cfg, {"embed": _S(m, f), "final_norm": _S(None),
                           "unembed": _S(f, m)}, layer)


def decode_param_specs(cfg: TransformerConfig, *, tp_axis="model") -> dict:
    """Serving layout (the reference's ``decode_param_specs``): every
    projection split on its input (contraction) dimension over
    ``tp_axis``; experts whole, each expert matrix split on its input."""
    m = tp_axis
    layer = {"attn_norm": (None,), "mlp_norm": (None,),
             "attn.wq": (m, None), "attn.wk": (m, None),
             "attn.wv": (m, None), "attn.wo": (m, None),
             **_attn_extras(cfg, ((None,),) * 3, (None,))}
    if cfg.is_moe:
        layer.update({"moe.router": (None, None),
                      "moe.w_gate": (None, m, None),
                      "moe.w_up": (None, m, None),
                      "moe.w_down": (None, m, None)})
    else:
        layer.update({"mlp.w_gate": (m, None), "mlp.w_up": (m, None),
                      "mlp.w_down": (m, None)})
    return _spec_map(cfg, {"embed": _S(None, m), "final_norm": _S(None),
                           "unembed": _S(m, None)}, layer)


def fsdp_param_specs(cfg: TransformerConfig, axes=("data", "model")) -> dict:
    """Pure FSDP (the reference's ``fsdp_param_specs``): every weight
    split over all of ``axes`` on one dimension, no tensor parallelism."""
    fs = tuple(axes)
    layer = {"attn_norm": (None,), "mlp_norm": (None,),
             "attn.wq": (fs, None), "attn.wk": (fs, None),
             "attn.wv": (fs, None), "attn.wo": (fs, None),
             **_attn_extras(cfg, ((None,),) * 3, (None,))}
    if cfg.is_moe:
        layer.update({"moe.router": (fs, None), "moe.w_gate": (None, fs, None),
                      "moe.w_up": (None, fs, None),
                      "moe.w_down": (None, None, fs)})
    else:
        layer.update({"mlp.w_gate": (fs, None), "mlp.w_up": (fs, None),
                      "mlp.w_down": (None, fs)})
    return _spec_map(cfg, {"embed": _S(fs, None), "final_norm": _S(None),
                           "unembed": _S(fs, None)}, layer)


def expert_parallel_specs(cfg: TransformerConfig, *,
                          ep_axis="model") -> dict:
    """The ``shard_a2a`` MoE path's layout (the reference's
    ``moe_fwd_sharded`` in-specs): the expert weights split on the expert
    axis over ``ep_axis``, every other weight (the router too) whole."""
    out = {}
    for name, shape in abstract_params(cfg).items():
        expert = name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down") \
            and ".moe." in name
        out[name] = _S(ep_axis) if expert else _S(*([None] * shape.dim()))
    return out


def cache_specs(cfg: TransformerConfig, *, batch_axes=("data",),
                tp_axis="model") -> dict:
    """KV cache layout (the reference's ``cache_specs``): batch over
    ``batch_axes``, head_dim over ``tp_axis``; the port's cache keeps the
    reference's (n_layers, B, max_len, kv_heads, d_head) layout."""
    kv = _S(None, batch_axes, None, None, tp_axis)
    return {"k": kv, "v": kv, "len": _S()}


def shard_params(model: nn.Module, mesh, specs: dict) -> nn.Module:
    """Replace every parameter of ``model`` by this rank's slice of it
    under ``specs`` (name -> ShardSpec covering every parameter), in
    place; returns ``model``."""
    names = dict(model.named_parameters())
    if set(names) != set(specs):
        raise ValueError(f"specs and parameters differ: "
                         f"{sorted(set(names) ^ set(specs))[:4]}")
    for name, param in names.items():
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        local = local_slice(param.detach(), mesh, specs[name])
        setattr(owner, leaf, nn.Parameter(local,
                                          requires_grad=param.requires_grad))
    return model


# ---------------------------------------------------------------------------
# GPipe training over a pipeline axis
# ---------------------------------------------------------------------------

def _stage_range(cfg: TransformerConfig, mesh, axis: str) -> range:
    n_stages = mesh_lib.axes_size(mesh, (axis,))
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")
    per = cfg.n_layers // n_stages
    stage = mesh_lib.axes_position(mesh, (axis,))
    return range(stage * per, (stage + 1) * per)


def pipeline_stage(model: "Transformer", mesh, axis: str = "pod"
                   ) -> "Transformer":
    """Keep only this rank's stage of ``model``'s layers (layers
    ``[s·L/S, (s+1)·L/S)`` for position s of S along ``axis``), in place;
    returns ``model``.  Embed, final norm and unembed stay on every rank."""
    model.layers = nn.ModuleList(_stage_blocks(model, mesh, axis))
    return model


def _stage_blocks(model: "Transformer", mesh, axis: str) -> list:
    """This rank's stage's `Block`s of a model holding all layers or
    that stage's."""
    own = _stage_range(model.cfg, mesh, axis)
    if len(model.layers) == model.cfg.n_layers:
        return [model.layers[i] for i in own]
    if len(model.layers) == len(own):
        return list(model.layers)
    raise ValueError(f"the model holds {len(model.layers)} layers, neither "
                     f"all nor a stage's {len(own)}")


def _data_axes(cfg: TransformerConfig, mesh, axis: str, mb: int) -> tuple:
    """The batch axes besides ``axis`` that split each microbatch (when
    they divide it, as the reference's ``mb_spec``), else ()."""
    rest = tuple(a for a in (cfg.batch_axes or ()) if a != axis)
    if rest and mb % mesh_lib.axes_size(mesh, rest) == 0:
        return rest
    return ()


def _microbatches(t: torch.Tensor, n_micro: int, mesh, data: tuple):
    """(B, S) -> (n_micro, this rank's share of mb, S)."""
    b, s = t.shape
    t = t.reshape(n_micro, b // n_micro, s)
    if not data:
        return t
    per = t.shape[1] // mesh_lib.axes_size(mesh, data)
    pos = mesh_lib.axes_position(mesh, data)
    return t[:, pos * per:(pos + 1) * per]


def _summed_in_backward(params: dict, mesh, axes: tuple) -> dict:
    if not axes:
        return params
    return {k: mesh_lib.all_reduce_bwd(p, mesh, axes)
            for k, p in params.items()}


def _block_call(blk: Block, params: dict, x, cfg: TransformerConfig,
                positions) -> torch.Tensor:
    out, _, _ = torch.func.functional_call(blk, params, (x, cfg, positions))
    return out


def pipeline_forward(model: "Transformer", tokens, *, mesh, n_micro: int = 8,
                     axis: str = "pod") -> tuple:
    """GPipe training forward (the reference's ``pipeline_forward``):
    tokens (B, S), the same on every rank, in ``n_micro`` microbatches
    through the stages of ``axis`` (`pipeline_apply`); each microbatch's
    batch dim splits over the config's other batch axes when they divide
    it, and every other axis (TP too) replicates.  Embed and unembed run
    outside the pipeline, replicated over ``axis``.  ``model`` holds all
    layers or this rank's stage (`pipeline_stage`).

    Returns (logits (n_micro, this rank's share of mb, S, padded_vocab),
    the split batch axes).  The parameters enter through
    ``launch.mesh.all_reduce_bwd`` where their gradients come out partial,
    so after a backward every rank holds the one-process gradient of every
    parameter it holds: a stage's layers summed over the split batch axes
    (each data rank sees its own tokens), ``embed`` over ``axis`` and those
    axes (only stage 0 feeds it), ``final_norm`` and ``unembed`` over the
    split batch axes (every stage computes the head of its data shard).
    Ranks that differ in the other axes hold the same values."""
    cfg = model.cfg
    tokens = model._tokens(tokens)
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    blocks = _stage_blocks(model, mesh, axis)
    data = _data_axes(cfg, mesh, axis, b // n_micro)
    embed = _summed_in_backward({"e": model.embed}, mesh, (axis,) + data)
    head = _summed_in_backward({"norm": model.final_norm,
                                "unembed": model.unembed}, mesh, data)
    stage_params = [_summed_in_backward(dict(blk.named_parameters()), mesh,
                                        data) for blk in blocks]
    x = embed["e"][_microbatches(tokens, n_micro, mesh, data)]
    positions = torch.arange(s, device=model.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()

    def stage_fn(h):
        for blk, params in zip(blocks, stage_params):
            if remat:
                h = checkpoint.checkpoint(_block_call, blk, params, h, cfg,
                                          positions, use_reentrant=False)
            else:
                h = _block_call(blk, params, h, cfg, positions)
        return h

    out = pipeline_apply(stage_fn, x, mesh=mesh, axis=axis)
    out = layers.rms_norm(out, head["norm"])
    return torch.matmul(out, head["unembed"]), data


def pipeline_loss(model: "Transformer", tokens, targets, *, mesh,
                  n_micro: int = 8, axis: str = "pod") -> torch.Tensor:
    """The reference's ``pipeline_loss_fn``: mean next-token NLL over every
    token of the global batch (no MoE aux term), the same on every rank;
    gradients as `pipeline_forward` says."""
    logits, data = pipeline_forward(model, tokens, mesh=mesh,
                                    n_micro=n_micro, axis=axis)
    logits = logits.float()
    mask = torch.arange(logits.shape[-1], device=logits.device) < \
        model.cfg.vocab
    logits = torch.where(mask, logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = _microbatches(model._tokens(targets), n_micro, mesh, data)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    loss = nll.sum() / model._tokens(targets).numel()
    return mesh_lib.all_reduce_fwd(loss, mesh, data) if data else loss


__all__ = ["TransformerConfig", "DeepseekV2Config", "Block", "Transformer",
           "param_seed", "init_by_name", "abstract_params",
           "param_specs", "decode_param_specs", "fsdp_param_specs",
           "expert_parallel_specs", "cache_specs", "shard_params",
           "pipeline_stage", "pipeline_forward", "pipeline_loss"]
