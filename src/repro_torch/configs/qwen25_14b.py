"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias [hf:Qwen/Qwen2.5-14B]. 40 heads are not divisible by
the 16-way TP axis -> heads pad to 48 and KV MHA-izes (DESIGN.md).

Counterpart of ``repro/configs/qwen25_14b.py``, field for field."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, d_head=128, qkv_bias=True,
    rope_theta=1_000_000.0, tp=16)

REDUCED = TransformerConfig(
    name="qwen2.5-14b-smoke", n_layers=2, d_model=320, n_heads=10,
    n_kv_heads=2, d_ff=640, vocab=1024, d_head=32, qkv_bias=True,
    dtype="float32", remat=False, kv_chunk=64)
