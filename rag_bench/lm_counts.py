"""The yardstick of the LM generator's shares: DeepSeek-V2's model FLOPs
and least bytes for a prefill and a decode step, from its ``config.json``
keys and the batch's shapes.

FLOPs are 2 a multiply-add of the model's products: every projection of
every token (q, kv_a, kv_b, o; the dense layer's SwiGLU; in a MoE layer
the router, the top-k experts' SwiGLUs and the shared one), the head on
each position whose logits are used, and the attention counted expanded,
per head, whatever path computes it: q·k over nope + rope dimensions and
p·v over v's, causal, so the share reads the same work whatever
implements it.  A decode step's least bytes (bfloat16 weights and cache)
are the weights it has to read once (attention, the dense layer, each
MoE layer's router, shared experts and the experts its tokens touched,
the head, the embedding rows) and the latent cache: the positions before
it read, its own written.  Peaks: `counts.HBM_BYTES_S` and the H100's
dense bfloat16 rate."""

from __future__ import annotations

BF16_FLOPS_S = 989.4e12       # H100 SXM, dense bfloat16
WEIGHT_BYTES = 2              # bfloat16 weights and cache


def _attn_params(c: dict) -> int:
    d, h, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
            + h * dv * d)


def _moe_layers(c: dict) -> int:
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


def _shared_params(c: dict) -> int:
    return 3 * c["hidden_size"] * c["moe_intermediate_size"] * \
        c["n_shared_experts"]


def _expert_params(c: dict) -> int:
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def token_flops(c: dict) -> float:
    """The products of one token through every layer (no head, no
    attention core)."""
    d = c["hidden_size"]
    dense = c["first_k_dense_replace"] * 3 * d * c["intermediate_size"]
    moe = _moe_layers(c) * (d * c["n_routed_experts"]
                            + c["num_experts_per_tok"] * _expert_params(c)
                            + _shared_params(c))
    return 2.0 * (c["num_hidden_layers"] * _attn_params(c) + dense + moe)


def _core(c: dict) -> int:
    """Per attended (query, key) pair, one layer: q·k and p·v per head."""
    return 2 * c["num_attention_heads"] * (
        c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])


def head_flops(c: dict) -> float:
    return 2.0 * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: dict, lanes: int, prompt_len: int) -> float:
    """``lanes`` prompts of ``prompt_len``: every token's products, the
    causal attention, the head on each prompt's last position."""
    s = prompt_len
    attn = c["num_hidden_layers"] * _core(c) * s * (s + 1) / 2
    return lanes * (s * token_flops(c) + attn + head_flops(c))


def decode_flops(c: dict, lanes: int, ctx: float) -> float:
    """One decode step of ``lanes`` rows, each attending ``ctx`` positions
    (its own included)."""
    attn = c["num_hidden_layers"] * _core(c) * ctx
    return lanes * (token_flops(c) + attn + head_flops(c))


def decode_bytes(c: dict, lanes: int, ctx: float, touched: float) -> float:
    """One decode step's least bytes, ``touched`` the mean distinct routed
    experts a MoE layer read."""
    d, v = c["hidden_size"], c["vocab_size"]
    weights = (c["num_hidden_layers"] * _attn_params(c)
               + c["first_k_dense_replace"] * 3 * d * c["intermediate_size"]
               + _moe_layers(c) * (d * c["n_routed_experts"]
                                   + _shared_params(c)
                                   + touched * _expert_params(c))
               + d * v + lanes * d)
    latent = c["kv_lora_rank"] + c["qk_rope_head_dim"]
    cache = c["num_hidden_layers"] * lanes * latent * ctx
    return WEIGHT_BYTES * (weights + cache)
