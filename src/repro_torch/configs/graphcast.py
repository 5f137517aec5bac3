"""graphcast [gnn]: 16L d_hidden=512 mesh_refinement=6 aggregator=sum
n_vars=227 — encoder-processor-decoder mesh GNN [arXiv:2212.12794].
d_feat is shape-dependent (per assigned graph shape set)."""
from repro_torch.models.gnn import GnnConfig

CONFIG = GnnConfig(name="graphcast", n_layers=16, d_hidden=512,
                   mesh_refinement=6, aggregator="sum", n_vars=227)

REDUCED = GnnConfig(name="graphcast-smoke", n_layers=3, d_hidden=32,
                    d_feat=16, n_vars=8, dtype="float32", remat=False)
