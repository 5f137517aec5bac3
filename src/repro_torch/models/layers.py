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
    projections are plain matrix products.
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
    from another random stream)."""
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
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., :, None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
    over them)."""
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


__all__ = [
    "make_param", "make_zeros", "make_ones", "rms_norm", "rope_freqs",
    "apply_rope", "chunked_attention", "direct_attention", "AttentionSpec",
    "Attention", "attention_fwd", "Mlp", "mlp_fwd",
]
