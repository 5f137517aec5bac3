"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
GQA + 128k vocab [arXiv:2407.21783].

Counterpart of ``repro/configs/llama3_8b.py``, field for field."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, d_head=128, rope_theta=500_000.0, tp=16)

REDUCED = TransformerConfig(
    name="llama3-8b-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=1024, d_head=32, dtype="float32", remat=False, kv_chunk=64)
