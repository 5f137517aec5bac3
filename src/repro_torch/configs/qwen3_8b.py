"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
qk_norm + GQA [hf:Qwen/Qwen3-8B].

Counterpart of ``repro/configs/qwen3_8b.py``, field for field."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, d_head=128, qk_norm=True,
    rope_theta=1_000_000.0, tp=16)

REDUCED = TransformerConfig(
    name="qwen3-8b-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=1024, d_head=32, qk_norm=True, dtype="float32",
    remat=False, kv_chunk=64)
