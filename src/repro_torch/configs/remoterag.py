"""remoterag — the paper's own service config: N=1e6 documents, n=768
embeddings (gtr-t5-base), k=5, k'=160 (the Table-4 operating point).

Counterpart of ``repro/configs/remoterag.py``, with the port's
`RlweParams`."""
from repro_torch.crypto.rlwe import RlweParams

RLWE = RlweParams()
N_DOCS = 10 ** 6
DIM = 768
K = 5
KPRIME = 160
