"""two-tower-retrieval [recsys]: embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval [RecSys'19 YouTube].
This is the RemoteRAG-native arch: its candidate index plugs directly into
the private retrieval protocol."""
from repro_torch.models.recsys import TwoTowerConfig

CONFIG = TwoTowerConfig(name="two-tower-retrieval", embed_dim=256,
                        tower_mlp=(1024, 512, 256), user_vocab=1_000_000,
                        item_vocab=1_000_000, n_user_feats=8, n_item_feats=4)

REDUCED = TwoTowerConfig(name="two-tower-smoke", embed_dim=16,
                         tower_mlp=(32, 16), user_vocab=500, item_vocab=500,
                         n_user_feats=3, n_item_feats=2)
