"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite]. 24 heads / 40 experts are
not divisible by 16 -> heads pad to 32 (KV MHA-izes), experts pad to 48.

Counterpart of ``repro/configs/granite_moe_3b_a800m.py``, field for field."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155, d_head=64, rope_theta=10_000.0,
    moe_experts=40, moe_top_k=8, moe_d_ff=512, tp=16)

REDUCED = TransformerConfig(
    name="granite-moe-smoke", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=64, vocab=1024, d_head=16, moe_experts=5, moe_top_k=2, moe_d_ff=64,
    dtype="float32", remat=False, kv_chunk=64)
