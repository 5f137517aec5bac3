"""Shared transformer building blocks.

Counterpart of ``repro/models/layers.py``:

  * parameters live in ``nn.Module``s under the reference's names (``wq wk
    wv wo [bq bk bv] [q_norm k_norm]``, ``w_gate w_up w_down``), in the
    reference's (in, out) layouts, so a reference parameter tree loads as
    it is (`repro_torch.convert`);
  * attention is GQA with optional qk-norm / qkv-bias; consecutive query
    heads share a KV head.  The tensor-parallel head padding
    (`AttentionSpec.padded_heads` / ``padded_kv_heads`` /
    ``kv_head_source``) is the reference's arithmetic; at ``tp_pad_to = 1``
    it is the identity;
  * full-sequence attention is the reference's online softmax over KV
    chunks, in plain PyTorch (pure JAX there, no Pallas kernel); the
    projections are plain matrix products;
  * DeepSeek-V2's multi-head latent attention (`MlaAttention`, with YaRN
    rope on its decoupled rope dimensions) has no counterpart in the
    reference; ``rag_bench/reference/deepseek_v2.py`` is its plain
    reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def make_param(shape, scale: float, generator: torch.Generator,
               device: torch.device, dtype=torch.float32) -> nn.Parameter:
    """normal x scale, drawn in float32 from ``generator`` on its own
    device and then moved to ``device`` (the reference's ``make_param``,
    from another random stream); on ``meta`` an empty tensor, nothing
    drawn."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                            requires_grad=False)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return nn.Parameter(w.to(device=device, dtype=dtype), requires_grad=False)


def make_ones(shape, device: torch.device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=dtype, device=device),
                        requires_grad=False)


def make_zeros(shape, device: torch.device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Mean square in float32, normalized x cast back to x's type, then
    times ``scale``."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(d_head: int, theta: float = 500_000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 500_000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    the two halves of the head dim (not interleaved pairs)."""
    return rotate_halves(x, positions, rope_freqs(x.shape[-1], theta,
                                                  x.device))


def rotate_halves(x: torch.Tensor, positions: torch.Tensor,
                  freqs: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """`apply_rope` at the inverse frequencies ``freqs`` (D/2,), cos and
    sin times ``mscale``; computed in float32, returned in x's type."""
    angles = positions[..., :, None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# YaRN rope and multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """``rope_scaling`` of type "yarn" in DeepSeek-V2's config."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1·mscale·ln(factor) + 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, scaling: Optional[YarnScaling],
               device=None) -> torch.Tensor:
    """Inverse frequencies (dim/2,) of YaRN: the plain rope's where a
    pair turns more than ``beta_fast`` times over the original context,
    divided by ``factor`` where it turns fewer than ``beta_slow`` times,
    blended linearly between (the modeling file's
    ``DeepseekV2YarnRotaryEmbedding``); the plain rope's with no
    scaling."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    if scaling is None:
        return extra
    inter = 1.0 / (scaling.factor * theta ** exps)

    def turns_dim(turns):
        return (dim * math.log(scaling.original_max_position
                               / (turns * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(turns_dim(scaling.beta_fast)), 0)
    high = min(math.ceil(turns_dim(scaling.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp                  # 1 where the plain rope is kept
    return inter * (1 - keep) + extra * keep


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                     freqs: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """DeepSeek-V2's ``apply_rotary_pos_emb``: the pairs (0, 1), (2, 3),
    ... of the last axis are first laid out as evens then odds, then
    rotated as halves; the result keeps that layout (q and k alike, so
    their dot products are the modeling file's)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return rotate_halves(x, positions, freqs, mscale)


@dataclasses.dataclass(frozen=True)
class MlaSpec:
    """Multi-head latent attention with no q compression (``q_lora_rank``
    null): q is a direct projection."""
    d_model: int
    n_heads: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    rope_theta: float = 10_000.0
    rope_scaling: Optional[YarnScaling] = None

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    def softmax_scale(self) -> float:
        """q_head_dim^-1/2, times mscale(factor, mscale_all_dim)^2 under
        YaRN."""
        scale = self.q_head_dim ** -0.5
        y = self.rope_scaling
        if y is not None and y.mscale_all_dim:
            m = yarn_mscale(y.factor, y.mscale_all_dim)
            scale = scale * m * m
        return scale

    def rope_mscale(self) -> float:
        """The factor on cos and sin: mscale(factor, mscale) over
        mscale(factor, mscale_all_dim) (1 for DeepSeek-V2-Lite)."""
        y = self.rope_scaling
        if y is None:
            return 1.0
        return yarn_mscale(y.factor, y.mscale) / yarn_mscale(
            y.factor, y.mscale_all_dim)


class MlaAttention(nn.Module):
    """Latent attention's projections in (in, out) layouts: ``wq`` (d,
    H·(nope+rope)), ``wkv_a`` (d, latent+rope) (the modeling file's
    ``kv_a_proj_with_mqa``), ``kv_norm`` (latent) (``kv_a_layernorm``),
    ``wkv_b`` (latent, H·(nope+v)), each head's k block then its v block,
    and ``wo`` (H·v, d)."""

    def __init__(self, spec: MlaSpec, generator: torch.Generator,
                 device: torch.device, dtype=torch.float32):
        super().__init__()
        self.spec = spec
        h, r = spec.n_heads, spec.kv_lora_rank
        scale = 1.0 / math.sqrt(spec.d_model)
        self.wq = make_param((spec.d_model, h * spec.q_head_dim), scale,
                             generator, device, dtype)
        self.wkv_a = make_param((spec.d_model, r + spec.qk_rope_dim), scale,
                                generator, device, dtype)
        self.kv_norm = make_ones((r,), device, dtype)
        self.wkv_b = make_param(
            (r, h * (spec.qk_nope_dim + spec.v_head_dim)),
            1.0 / math.sqrt(r), generator, device, dtype)
        self.wo = make_param((h * spec.v_head_dim, spec.d_model),
                             1.0 / math.sqrt(h * spec.v_head_dim), generator,
                             device, dtype)
        self._freqs = None

    def rope_freqs(self, device) -> torch.Tensor:
        """The YaRN inverse frequencies on ``device``, computed once."""
        if self._freqs is None or self._freqs.device != device:
            s = self.spec
            self._freqs = yarn_freqs(s.qk_rope_dim, s.rope_theta,
                                     s.rope_scaling, device)
        return self._freqs

    def forward(self, x, *, positions, causal=True, cache=None,
                kv_chunk=1024):
        return mla_fwd(self, x, self.spec, positions=positions,
                       causal=causal, cache=cache)


def mla_fwd(p: MlaAttention, x: torch.Tensor, spec: MlaSpec, *,
            positions: torch.Tensor, causal: bool = True,
            cache=None) -> tuple:
    """Returns (out, (latent, k_pe)): the normed latent (B, S, latent)
    and the roped k_pe (B, S, rope) of this segment, or with ``cache =
    (latent_cache, kpe_cache, cache_len)`` the caches with them written
    at ``cache_len`` (in place; an int or a 0-d device tensor), attending
    over the whole cache with the positions after the segment masked.

    Without a cache (prefill, training) k and v are expanded per head and
    attended by SDPA over q·k of nope+rope dimensions; with one (decode)
    the attention is absorbed: q_nope goes through kv_b's k block into
    the latent space, scores against the cached latent plus k_pe, and the
    latent output comes back through kv_b's v block, so only the latent
    and k_pe are ever cached."""
    b, s, _ = x.shape
    h, r = spec.n_heads, spec.kv_lora_rank
    dn, dr, dv = spec.qk_nope_dim, spec.qk_rope_dim, spec.v_head_dim
    freqs = p.rope_freqs(x.device)
    m = spec.rope_mscale()
    q = torch.matmul(x, p.wq).reshape(b, s, h, dn + dr)
    q_nope, q_pe = torch.split(q, [dn, dr], dim=-1)
    q_pe = rope_interleaved(q_pe, positions, freqs, m)
    latent, k_pe = torch.split(torch.matmul(x, p.wkv_a), [r, dr], dim=-1)
    latent = rms_norm(latent, p.kv_norm)
    k_pe = rope_interleaved(k_pe[:, :, None, :], positions, freqs, m)[:, :, 0]
    scale = spec.softmax_scale()

    if cache is None:
        kv = torch.matmul(latent, p.wkv_b).reshape(b, s, h, dn + dv)
        k_nope, v = torch.split(kv, [dn, dv], dim=-1)
        qh = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        kh = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)],
                       dim=-1).transpose(1, 2)
        out = F.scaled_dot_product_attention(qh, kh, v.transpose(1, 2),
                                             is_causal=causal, scale=scale)
        out = out.transpose(1, 2).reshape(b, s, h * dv)
        return torch.matmul(out, p.wo), (latent, k_pe)

    c_cache, pe_cache, n = cache
    at = n + torch.arange(s, device=x.device)
    c_cache.index_copy_(1, at, latent.to(c_cache.dtype))
    pe_cache.index_copy_(1, at, k_pe.to(pe_cache.dtype))
    t = c_cache.shape[1]
    wkv_b = p.wkv_b.reshape(r, h, dn + dv)
    # (H, B·S, nope) @ (H, nope, latent): q_nope in the latent space
    q_lat = torch.matmul(q_nope.reshape(b * s, h, dn).transpose(0, 1),
                         wkv_b[:, :, :dn].permute(1, 2, 0))
    q_lat = q_lat.transpose(0, 1).reshape(b, s * h, r)
    scores = (torch.matmul(q_lat, c_cache.transpose(1, 2))
              + torch.matmul(q_pe.reshape(b, s * h, dr),
                             pe_cache.transpose(1, 2))).float() * scale
    later = torch.arange(t, device=x.device)[None, :] > at[:, None]
    scores = scores.reshape(b, s, h, t).masked_fill(
        later[None, :, None, :], -torch.inf).reshape(b, s * h, t)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.matmul(probs, c_cache)                   # (B, S·H, latent)
    # (H, B·S, latent) @ (H, latent, v): back through kv_b's v block
    out = torch.matmul(o_lat.reshape(b * s, h, r).transpose(0, 1),
                       wkv_b[:, :, dn:].transpose(0, 1))
    out = out.transpose(0, 1).reshape(b, s, h * dv)
    return torch.matmul(out, p.wo), (c_cache, pe_cache)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0, kv_chunk: int = 1024,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention, O(S) memory in KV length.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] (decode: Skv_cached).
    ``kv_len``: optional valid-length mask for cache decoding.

    KV is padded to whole chunks and the pad masked, as in the reference,
    except that a KV shorter than one chunk is one chunk of its own length
    (the reference pads it to ``kv_chunk``: the masked pad adds exact zeros
    to every sum, and at the embedder's 32 tokens it would be 97% of the
    attention's work).
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d).float()
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    kv_chunk = min(kv_chunk, skv)
    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(b, n_chunks, kv_chunk, hkv, d)
    vc = v.reshape(b, n_chunks, kv_chunk, hkv, d)

    q_pos = q_offset + torch.arange(sq, device=dev)
    limit = kv_len if kv_len is not None else skv
    m = torch.full((b, sq, hkv, group), -torch.inf, device=dev)
    l = torch.zeros((b, sq, hkv, group), device=dev)
    o = torch.zeros((b, sq, hkv, group, d), device=dev)
    for c in range(n_chunks):
        # scores: (B, Sq, Hkv, G, C)
        s = torch.einsum("bqhgd,bchd->bqhgc", qg, kc[:, c].float()) * scale
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = (kv_pos[None, :] < limit).expand(sq, kv_chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhgc,bchd->bqhgd", p, vc[:, c].float())
        o = o * corr[..., None] + pv
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int = 0, kv_len: Optional[int] = None,
                     causal: bool = True) -> torch.Tensor:
    """Unchunked attention for decode (q_len small)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d).float()
    s = torch.einsum("bqhgd,bshd->bqhgs", qg, k.float()) / math.sqrt(d)
    kv_pos = torch.arange(skv, device=q.device)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    mask = (kv_pos[None, :] < (kv_len if kv_len is not None else skv)
            ).expand(sq, skv)
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgs,bshd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    # tensor-parallel padding (see module docstring); 1 = no padding
    tp_pad_to: int = 1

    @property
    def padded_heads(self) -> int:
        return -(-self.n_heads // self.tp_pad_to) * self.tp_pad_to

    @property
    def padded_kv_heads(self) -> int:
        """KV heads after TP padding.

        If no q-padding was needed and the rounded-up KV count divides the q
        count, consecutive replication (the Megatron GQA-TP trick) preserves
        the q->kv grouping.  Otherwise padding q heads changes the grouping
        arithmetic and we MHA-ize (one kv head per padded q head).
        """
        if self.tp_pad_to == 1:
            return self.n_kv_heads
        cand = max(self.n_kv_heads, self.tp_pad_to)
        cand = -(-cand // self.tp_pad_to) * self.tp_pad_to
        if self.padded_heads == self.n_heads and self.padded_heads % cand == 0:
            return cand
        return self.padded_heads

    def kv_head_source(self) -> np.ndarray:
        """Source original-kv-head index for each padded kv head (for
        checkpoint import and equivalence tests)."""
        group = self.n_heads // self.n_kv_heads
        pk = self.padded_kv_heads
        if pk == self.padded_heads:  # MHA-ized
            j = np.minimum(np.arange(pk), self.n_heads - 1)
            return j // group
        rep = pk // self.n_kv_heads
        return np.arange(pk) // rep


class Attention(nn.Module):
    """GQA projections under the reference's parameter names: ``wq``
    (d_model, hq·d), ``wk``/``wv`` (d_model, hkv·d), ``wo`` (hq·d,
    d_model), optional ``bq bk bv`` (zeros) and ``q_norm k_norm`` (ones)."""

    def __init__(self, spec: AttentionSpec, generator: torch.Generator,
                 device: torch.device, dtype=torch.float32):
        super().__init__()
        self.spec = spec
        hq, hkv, d = spec.padded_heads, spec.padded_kv_heads, spec.d_head
        scale = 1.0 / math.sqrt(spec.d_model)
        mk = lambda shape: make_param(shape, scale, generator, device, dtype)
        self.wq = mk((spec.d_model, hq * d))
        self.wk = mk((spec.d_model, hkv * d))
        self.wv = mk((spec.d_model, hkv * d))
        self.wo = mk((hq * d, spec.d_model))
        if spec.qkv_bias:
            self.bq = make_zeros((hq * d,), device, dtype)
            self.bk = make_zeros((hkv * d,), device, dtype)
            self.bv = make_zeros((hkv * d,), device, dtype)
        if spec.qk_norm:
            self.q_norm = make_ones((d,), device, dtype)
            self.k_norm = make_ones((d,), device, dtype)

    def forward(self, x, *, positions, causal=True, cache=None,
                kv_chunk=1024):
        return attention_fwd(self, x, self.spec, positions=positions,
                             causal=causal, cache=cache, kv_chunk=kv_chunk)


def attention_fwd(p: Attention, x: torch.Tensor, spec: AttentionSpec, *,
                  positions: torch.Tensor, causal: bool = True, cache=None,
                  kv_chunk: int = 1024) -> tuple:
    """Returns (out, new_kv) — new_kv is the (k, v) for this segment, or
    with ``cache = (k_cache, v_cache, cache_len)`` the caches with this
    segment written at ``cache_len`` (in place; decode attends causally
    over them).  ``cache_len`` may be an int or a 0-d device tensor (a
    step captured in a CUDA graph)."""
    b, s, _ = x.shape
    hq, hkv, d = spec.padded_heads, spec.padded_kv_heads, spec.d_head
    q = torch.matmul(x, p.wq)
    k = torch.matmul(x, p.wk)
    v = torch.matmul(x, p.wv)
    if spec.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, hq, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)
    if spec.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)

    if cache is not None:
        ck, cv, cache_len = cache
        if isinstance(cache_len, torch.Tensor):
            at = cache_len + torch.arange(s, device=x.device)
            ck.index_copy_(1, at, k.to(ck.dtype))
            cv.index_copy_(1, at, v.to(cv.dtype))
        else:
            ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        out = direct_attention(q, ck, cv, q_offset=cache_len,
                               kv_len=cache_len + s, causal=True)
        new_kv = (ck, cv)
    else:
        out = chunked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk)
        new_kv = (k, v)
    out = out.reshape(b, s, hq * d)
    return torch.matmul(out, p.wo), new_kv


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

class Mlp(nn.Module):
    """SwiGLU under the reference's names: ``w_gate``/``w_up`` (d_model,
    d_ff), ``w_down`` (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator,
                 device: torch.device, dtype=torch.float32):
        super().__init__()
        scale = 1.0 / math.sqrt(d_model)
        self.w_gate = make_param((d_model, d_ff), scale, generator, device,
                                 dtype)
        self.w_up = make_param((d_model, d_ff), scale, generator, device,
                               dtype)
        self.w_down = make_param((d_ff, d_model), 1.0 / math.sqrt(d_ff),
                                 generator, device, dtype)

    def forward(self, x):
        return mlp_fwd(self, x)


def mlp_fwd(p: Mlp, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(torch.matmul(x, p.w_gate))
    u = torch.matmul(x, p.w_up)
    return torch.matmul(g * u, p.w_down)


# ---------------------------------------------------------------------------
# dense stacks (the GNN and recsys models' MLPs)
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """``x @ w + b`` under the reference's ``_mlp_params`` entry names:
    ``w`` (d_in, d_out) drawn at 1/sqrt(d_in), ``b`` zeros."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator,
                 device: torch.device, dtype=torch.float32):
        super().__init__()
        self.w = make_param((d_in, d_out), 1.0 / math.sqrt(d_in), generator,
                            device, dtype)
        self.b = make_zeros((d_out,), device, dtype)

    def forward(self, x):
        return torch.matmul(x, self.w) + self.b


def dense_stack(dims, generator: torch.Generator, device: torch.device,
                dtype=torch.float32) -> nn.ModuleList:
    """`Dense` layers dims[0] -> dims[1] -> ... (the reference's
    ``_mlp_params``; state-dict names ``{i}.w``, ``{i}.b``)."""
    return nn.ModuleList(Dense(dims[i], dims[i + 1], generator, device, dtype)
                         for i in range(len(dims) - 1))


def stack_fwd(stack: nn.ModuleList, x: torch.Tensor, act,
              final_act: bool = False) -> torch.Tensor:
    """The reference's ``_mlp``: ``act`` between the layers (and after the
    last with ``final_act``)."""
    for i, layer in enumerate(stack):
        x = layer(x)
        if i < len(stack) - 1 or final_act:
            x = act(x)
    return x


__all__ = [
    "make_param", "make_zeros", "make_ones", "rms_norm", "rope_freqs",
    "apply_rope", "rotate_halves", "chunked_attention", "direct_attention",
    "AttentionSpec", "Attention", "attention_fwd", "YarnScaling",
    "yarn_mscale", "yarn_freqs", "rope_interleaved", "MlaSpec",
    "MlaAttention", "mla_fwd", "Mlp", "mlp_fwd", "Dense", "dense_stack",
    "stack_fwd",
]
