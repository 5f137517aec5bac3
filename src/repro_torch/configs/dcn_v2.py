"""dcn-v2 [recsys]: n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512 interaction=cross [arXiv:2008.13535]."""
from repro_torch.models.recsys import DcnV2Config

CONFIG = DcnV2Config(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                     n_cross_layers=3, mlp=(1024, 1024, 512),
                     vocab_per_field=100_000)

REDUCED = DcnV2Config(name="dcn-v2-smoke", n_dense=4, n_sparse=6, embed_dim=8,
                      n_cross_layers=2, mlp=(32, 16), vocab_per_field=100)
