"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

Counterpart of ``repro/configs/qwen3_moe_30b_a3b.py``, field for field."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=768, vocab=151936, d_head=128, qk_norm=True,
    rope_theta=1_000_000.0, moe_experts=128, moe_top_k=8, moe_d_ff=768,
    tp=16)

REDUCED = TransformerConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=1024, d_head=32, qk_norm=True, moe_experts=8, moe_top_k=2,
    moe_d_ff=96, dtype="float32", remat=False, kv_chunk=64)
