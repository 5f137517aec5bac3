"""dien [recsys]: embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru [arXiv:1809.03672]."""
from repro_torch.models.recsys import DienConfig

CONFIG = DienConfig(name="dien", embed_dim=18, seq_len=100, gru_dim=108,
                    mlp=(200, 80), item_vocab=500_000)

REDUCED = DienConfig(name="dien-smoke", embed_dim=8, seq_len=12, gru_dim=16,
                     mlp=(20, 8), item_vocab=500)
