"""fm [recsys]: n_sparse=39 embed_dim=10 interaction=fm-2way
pairwise <vi,vj>xi xj via the O(nk) sum-square trick [Rendle ICDM'10]."""
from repro_torch.models.recsys import FmConfig

CONFIG = FmConfig(name="fm", n_sparse=39, embed_dim=10,
                  vocab_per_field=100_000)

REDUCED = FmConfig(name="fm-smoke", n_sparse=5, embed_dim=4,
                   vocab_per_field=100)
