"""The plain reference of DeepSeek-V2 (``modeling_deepseek.py`` of
deepseek-ai/DeepSeek-V2-Lite, with its ``config.json`` keys): a full
causal forward pass in plain PyTorch, one layer at a time, no cache, no
batching across a layer's products, no kernel of the port.

The weights are those of the served model, redrawn from the seed: every
tensor of the port's model is drawn from its own generator seeded by
`param_seed` (the seed and the tensor's name), with the scale of
`draw`, rounded to the served dtype, and used here in the compute dtype.
`Weights` gives them one layer at a time, under the modeling file's
module names and in (in, out) layouts (``x @ w``), so a layer can be
redrawn when it is needed and freed after.

Departures from the modeling file, none of which changes the result in
float32:

* rope's cos and sin are computed in float32 and the rotation is done in
  float32 (the modeling file caches them in the activations' dtype);
* attention is computed per sequence over blocks of queries, each block's
  scores in float32 (the modeling file computes all scores at once in the
  activations' dtype, then a float32 softmax);
* the MoE computes each expert's rows as the modeling file's
  ``moe_infer`` does, over every token of the batch at once;
* the logits are computed only at the positions asked for."""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence

import torch
from torch.nn import functional as F

VOCAB_PAD = 512          # the served embedding and head hold the vocab
                         # rounded up to a multiple of this
QUERY_BLOCK = 1024


def param_seed(seed: int, name: str) -> int:
    """The 63-bit seed of the served tensor ``name``: the first 8 bytes of
    BLAKE2b over ``"<seed>/<name>"``, little-endian, shifted right once."""
    digest = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def draw(seed: int, name: str, shape: Sequence[int], device,
         dtype: torch.dtype) -> torch.Tensor:
    """The served tensor ``name``: a vector is 1 + 0.1 x normal (the
    norms); a matrix or a stack of them is normal x 1/sqrt(its input
    width, shape[-2]), the embedding (vocab, d) normal x 1/sqrt(d); drawn
    in float32 on ``device`` and rounded to ``dtype`` (the served one)."""
    shape = tuple(shape)
    g = torch.Generator(device=device).manual_seed(param_seed(seed, name))
    w = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    if len(shape) == 1:
        return (1.0 + 0.1 * w).to(dtype)
    fan_in = shape[-1] if name == "embed" else shape[-2]
    return (w / math.sqrt(fan_in)).to(dtype)


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // VOCAB_PAD) * VOCAB_PAD


def layer_shapes(cfg: dict, i: int) -> Dict[str, tuple]:
    """{modeling-file name: (served tensor name, shape)} of layer ``i``."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    r, dn = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    dr, dv = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    p = f"layers.{i}."
    out = {
        "input_layernorm": (p + "attn_norm", (d,)),
        "post_attention_layernorm": (p + "mlp_norm", (d,)),
        "q_proj": (p + "attn.wq", (d, h * (dn + dr))),
        "kv_a_proj_with_mqa": (p + "attn.wkv_a", (d, r + dr)),
        "kv_a_layernorm": (p + "attn.kv_norm", (r,)),
        "kv_b_proj": (p + "attn.wkv_b", (r, h * (dn + dv))),
        "o_proj": (p + "attn.wo", (h * dv, d)),
    }
    if i < cfg["first_k_dense_replace"]:
        f = cfg["intermediate_size"]
        out.update({"gate_proj": (p + "mlp.w_gate", (d, f)),
                    "up_proj": (p + "mlp.w_up", (d, f)),
                    "down_proj": (p + "mlp.w_down", (f, d))})
    else:
        e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        fs = f * cfg["n_shared_experts"]
        out.update({"gate": (p + "moe.router", (d, e)),
                    "experts.gate_proj": (p + "moe.w_gate", (e, d, f)),
                    "experts.up_proj": (p + "moe.w_up", (e, d, f)),
                    "experts.down_proj": (p + "moe.w_down", (e, f, d)),
                    "shared_experts.gate_proj": (p + "moe.shared.w_gate",
                                                 (d, fs)),
                    "shared_experts.up_proj": (p + "moe.shared.w_up",
                                               (d, fs)),
                    "shared_experts.down_proj": (p + "moe.shared.w_down",
                                                 (fs, d))})
    return out


def outer_shapes(cfg: dict) -> Dict[str, tuple]:
    d, vp = cfg["hidden_size"], padded_vocab(cfg)
    return {"embed_tokens": ("embed", (vp, d)), "norm": ("final_norm", (d,)),
            "lm_head": ("unembed", (d, vp))}


class Weights:
    """The served model's tensors redrawn from ``seed`` on ``device``:
    rounded to ``served`` (its dtype), returned in ``compute``."""

    def __init__(self, cfg: dict, seed: int, device, *,
                 served=torch.bfloat16, compute=torch.float32):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.served, self.compute = served, compute

    def _get(self, table: dict) -> Dict[str, torch.Tensor]:
        return {k: draw(self.seed, name, shape, self.device,
                        self.served).to(self.compute)
                for k, (name, shape) in table.items()}

    def outer(self) -> Dict[str, torch.Tensor]:
        return self._get(outer_shapes(self.cfg))

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return self._get(layer_shapes(self.cfg, i))


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps):
    """``DeepseekV2RMSNorm``: the mean square in float32."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_inv_freq(cfg: dict, device) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies (or the
    plain rope's without ``rope_scaling``)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** ar)
    rs = cfg.get("rope_scaling")
    if rs is None:
        return freq_extra
    factor = rs["factor"]
    freq_inter = 1.0 / (factor * base ** ar)
    orig = rs["original_max_position_embeddings"]

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs is not None and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, cfg: dict
                 ) -> torch.Tensor:
    """``apply_rotary_pos_emb`` on x (..., T, H, dim): the interleaved
    pairs laid out as halves, then ``x·cos + rotate_half(x)·sin``, with
    cos and sin of ``cat(freqs, freqs)`` times the YaRN ratio."""
    rs = cfg.get("rope_scaling")
    m = 1.0 if rs is None else (yarn_get_mscale(rs["factor"], rs["mscale"])
                                / yarn_get_mscale(rs["factor"],
                                                  rs["mscale_all_dim"]))
    freqs = torch.outer(positions.float(), rope_inv_freq(cfg, x.device))
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = (emb.cos() * m)[:, None, :]
    sin = (emb.sin() * m)[:, None, :]
    d = x.shape[-1]
    xf = x.float().reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2)
    xf = xf.reshape(x.shape)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def attention(x: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    """``DeepseekV2Attention`` of one sequence x (T, d), causal, with the
    keys and values expanded per head."""
    t = x.shape[0]
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    pos = torch.arange(t, device=x.device)
    q = (x @ w["q_proj"]).reshape(t, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = x @ w["kv_a_proj_with_mqa"]
    latent, k_pe = ckv[:, :r], ckv[:, r:]
    kv = (rms_norm(latent, w["kv_a_layernorm"], cfg["rms_norm_eps"])
          @ w["kv_b_proj"]).reshape(t, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe = apply_rotary(q_pe, pos, cfg)
    k_pe = apply_rotary(k_pe[:, None, :], pos, cfg)
    qh = torch.cat([q_nope, q_pe], dim=-1).transpose(0, 1)       # (H, T, 192)
    kh = torch.cat([k_nope, k_pe.expand(t, h, dr)], dim=-1).transpose(0, 1)
    vh = v.transpose(0, 1)                                        # (H, T, dv)
    scale = softmax_scale(cfg)
    out = torch.empty((h, t, dv), dtype=x.dtype, device=x.device)
    for lo in range(0, t, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, t)
        s = (qh[:, lo:hi] @ kh[:, :hi].transpose(1, 2)).float() * scale
        mask = pos[:hi][None, :] > pos[lo:hi][:, None]
        s = s.masked_fill(mask, -torch.inf)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        out[:, lo:hi] = p @ vh[:, :hi]
    return out.transpose(0, 1).reshape(t, h * dv) @ w["o_proj"]


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(x: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    """``DeepseekV2MoE`` at inference over tokens x (N, d): the gate
    (float32 logits, a softmax over every expert, the top k, not
    renormalised, times the routed scale), each expert's rows in turn,
    the outputs weighted and summed over k in float32, then the shared
    experts."""
    k = cfg["num_experts_per_tok"]
    logits = x.float() @ w["gate"].float()
    scores = torch.softmax(logits, dim=-1)
    topk_w, topk_i = torch.topk(scores, k, dim=-1, sorted=False)
    if cfg["norm_topk_prob"]:
        topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
    topk_w = topk_w * cfg["routed_scaling_factor"]
    counts = torch.bincount(topk_i.reshape(-1),
                            minlength=cfg["n_routed_experts"]).tolist()
    idxs = topk_i.reshape(-1).argsort()
    sorted_tokens = x[idxs // k]
    outs, lo = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(swiglu(sorted_tokens[lo:lo + n],
                               w["experts.gate_proj"][e],
                               w["experts.up_proj"][e],
                               w["experts.down_proj"][e]))
            lo += n
    outs = torch.cat(outs)
    new_x = torch.empty_like(outs)
    new_x[idxs] = outs
    y = (new_x.reshape(x.shape[0], k, -1).float()
         * topk_w[..., None]).sum(dim=1).to(x.dtype)
    return y + swiglu(x, w["shared_experts.gate_proj"],
                      w["shared_experts.up_proj"],
                      w["shared_experts.down_proj"])


def forward(cfg: dict, weights, tokens: torch.Tensor,
            at: torch.Tensor) -> torch.Tensor:
    """Logits (R, len(at), vocab) in float32 of the sequences ``tokens``
    (R, T) at positions ``at``; the weights' ``compute`` dtype is the
    activations' (``weights.layer(i)`` is called once for each layer, in
    order)."""
    eps = cfg["rms_norm_eps"]
    outer = weights.outer()
    x = outer["embed_tokens"][tokens.long()]
    head = {k: outer[k] for k in ("norm", "lm_head")}
    del outer
    r, t, d = x.shape
    for i in range(cfg["num_hidden_layers"]):
        w = weights.layer(i)
        h = rms_norm(x, w["input_layernorm"], eps)
        x = x + torch.stack([attention(h[j], w, cfg) for j in range(r)])
        h = rms_norm(x, w["post_attention_layernorm"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, w["gate_proj"], w["up_proj"], w["down_proj"])
        else:
            x = x + moe(h.reshape(r * t, d), w, cfg).reshape(r, t, d)
        del w, h
    x = rms_norm(x[:, at], head["norm"], eps)
    return (x @ head["lm_head"]).float()[..., :cfg["vocab_size"]]


def greedy(cfg: dict, weights, prompts: torch.Tensor,
           answer_len: int) -> tuple:
    """The reference in a generator's place: ``answer_len`` greedy tokens
    for each prompt (R, S), one full forward pass a token (no cache).
    Returns (tokens (R, answer_len) int64, their logits (R, answer_len)
    float32)."""
    seq = prompts.long()
    toks, logits = [], []
    for _ in range(answer_len):
        lg = forward(cfg, weights, seq,
                     torch.tensor([seq.shape[1] - 1], device=seq.device))[:, 0]
        nxt = torch.argmax(lg, dim=-1)
        toks.append(nxt)
        logits.append(lg.gather(1, nxt[:, None])[:, 0])
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    return torch.stack(toks, 1), torch.stack(logits, 1)


def compare(cfg: dict, weights, prompts: torch.Tensor, tokens: torch.Tensor,
            logits: torch.Tensor) -> dict:
    """The check's two numbers for served answers ``tokens`` (R, A) with
    their logits (R, A), teacher-forced: the prompts and answers through
    the reference, its logits at the A positions that chose them.
    ``token_gap``: the widest gap of the reference's logit of a served
    token below its best; ``logit_err``: the largest |served logit − the
    reference's logit of that token|."""
    s, a = prompts.shape[1], tokens.shape[1]
    seq = torch.cat([prompts.long(), tokens[:, :-1].long()], dim=1)
    at = torch.arange(s - 1, s + a - 1, device=prompts.device)
    ref = forward(cfg, weights, seq, at)                      # (R, A, vocab)
    chosen = ref.gather(2, tokens.long()[..., None])[..., 0]
    return dict(token_gap=float((ref.amax(dim=-1) - chosen).max()),
                logit_err=float((logits.float() - chosen).abs().max()))
