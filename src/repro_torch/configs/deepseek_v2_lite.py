"""deepseek-v2-lite [moe, mla]: 27L d_model=2048 16H, latent attention
(kv_lora_rank 512, q direct, q·k over 128 + 64 rope, v 128, YaRN factor
40), layer 0 a dense SwiGLU of 10944, layers 1-26 MoE of 64 experts of
1408 (top-6 of a softmax, not renormalised) + 2 shared, vocab 102400
[hf:deepseek-ai/DeepSeek-V2-Lite].

No counterpart in the JAX package, which has no latent attention, and
not in `registry` (whose entries equal the reference's).  `from_hf` reads
the published ``config.json`` keys and refuses any setting the port does
not implement."""
from repro_torch.models.layers import YarnScaling
from repro_torch.models.transformer import DeepseekV2Config

HF_CONFIG = {
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "greedy", "v_head_dim": 128, "vocab_size": 102400,
}

# what the port implements of the keys that choose a mechanism
_SUPPORTED = {"attention_bias": False, "hidden_act": "silu",
              "moe_layer_freq": 1, "norm_topk_prob": False,
              "q_lora_rank": None, "rms_norm_eps": 1e-06,
              "scoring_func": "softmax", "tie_word_embeddings": False,
              "topk_method": "greedy"}


def from_hf(c: dict, *, name: str = "deepseek-v2-lite",
            dtype: str = "bfloat16") -> DeepseekV2Config:
    """A `DeepseekV2Config` from DeepSeek-V2's ``config.json`` keys;
    raises ValueError on a setting the port does not implement."""
    for key, want in _SUPPORTED.items():
        if c.get(key, want) != want:
            raise ValueError(f"{key}={c[key]!r} is not implemented "
                             f"(only {want!r})")
    rs = c.get("rope_scaling")
    if rs is not None and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling type {rs.get('type')!r}: only yarn")
    yarn = None if rs is None else YarnScaling(
        factor=rs["factor"],
        original_max_position=rs["original_max_position_embeddings"],
        beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
        mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"])
    return DeepseekV2Config(
        name=name, n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"],
        d_head=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        rope_theta=float(c["rope_theta"]), moe_experts=c["n_routed_experts"],
        moe_top_k=c["num_experts_per_tok"],
        moe_d_ff=c["moe_intermediate_size"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], rope_scaling=yarn,
        first_dense_layers=c["first_k_dense_replace"],
        moe_shared_d_ff=c["moe_intermediate_size"] * (c["n_shared_experts"]
                                                      or 0) or None,
        routed_scaling=float(c["routed_scaling_factor"]), dtype=dtype,
        remat=False)


CONFIG = from_hf(HF_CONFIG)

# the CPU tests' size: 1 dense + 2 MoE layers, 8 experts top-3, latent 32
REDUCED_HF = {**HF_CONFIG, "num_hidden_layers": 3, "hidden_size": 64,
              "intermediate_size": 96, "moe_intermediate_size": 32,
              "n_routed_experts": 8, "num_experts_per_tok": 3,
              "num_attention_heads": 4, "num_key_value_heads": 4,
              "kv_lora_rank": 32, "qk_nope_head_dim": 16,
              "qk_rope_head_dim": 8, "v_head_dim": 16, "vocab_size": 512}
REDUCED = from_hf(REDUCED_HF, name="deepseek-v2-lite-smoke", dtype="float32")
