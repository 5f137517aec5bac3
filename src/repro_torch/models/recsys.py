"""RecSys archs: FM, two-tower retrieval, DIEN (AUGRU), DCN-v2 (counterpart
of ``repro/models/recsys.py``).

The shared substrate is the sparse-embedding layer: `embedding_lookup`
(one id a row) and `embedding_bag` (multi-hot bags summed or averaged by
``index_add``) over row-sharded tables (`table_spec`, the TBE layout on
the mesh's "model" axis).  Embedding gradients are dense, as in the
reference.  Two-tower's candidate scoring is the RemoteRAG workload: its
item embeddings index into `repro_torch.retrieval` and its user tower's
output is the private query (``examples/recsys_retrieval.py``).

Each model is an ``nn.Module`` holding the reference's parameter tree
under its names (a list entry ``i`` is ``{i}``; DCN-v2's stacked cross
layers are ``cross.{i}``), drawn from an explicit ``torch.Generator`` at
the reference's scales; `repro_torch.convert.recsys_params` loads a
reference tree.  Methods map onto the reference's functions: ``forward``
(``fm_forward``, ``dien_forward``, ``dcnv2_forward``), ``loss`` (``*_loss``),
and on `TwoTower` ``user_embedding``, ``item_embedding``, ``loss``
(``twotower_loss``) and ``score_candidates``.  Parameters are built with
``requires_grad`` off; a trainer turns it on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import ShardSpec
from repro_torch.models import layers

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """Plain per-id lookup: (...,) ids -> (..., d)."""
    return table[torch.as_tensor(ids, device=table.device).long()]


def embedding_bag(table: torch.Tensor, ids, segment_ids, num_bags: int, *,
                  mode: str = "sum") -> torch.Tensor:
    """Multi-hot bag reduce: ids/segment_ids (nnz,) -> (num_bags, d)."""
    seg = torch.as_tensor(segment_ids, device=table.device).long()
    rows = embedding_lookup(table, ids)
    out = torch.zeros((num_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device).index_add(0, seg, rows)
    if mode == "mean":
        cnt = torch.zeros(num_bags, dtype=table.dtype,
                          device=table.device).index_add(
            0, seg, torch.ones(seg.shape[0], dtype=table.dtype,
                               device=table.device))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _table(vocab: int, dim: int, generator, device, dtype) -> nn.Parameter:
    return layers.make_param((vocab, dim), 1.0 / math.sqrt(dim), generator,
                             device, dtype)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def _setup(module: nn.Module, cfg, generator, device) -> tuple:
    module.cfg = cfg
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    return gen, resolve_device(device), _DTYPES[cfg.dtype]


class _Recsys(nn.Module):
    """Shared helpers: the device, ids and dense inputs moved onto it,
    the BCE loss over ``forward``'s logits."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.device).long()

    def _bce_loss(self, logits, labels) -> torch.Tensor:
        labels = torch.as_tensor(labels, device=self.device).float()
        return torch.mean(_bce(logits.float(), labels))


# ---------------------------------------------------------------------------
# FM  (Rendle ICDM'10): O(nk) sum-square pairwise interactions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FmConfig:
    name: str = "fm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 100_000
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class Fm(_Recsys):
    """``table`` (F·V, k), ``linear`` (F·V, 1), ``bias`` ()."""

    def __init__(self, cfg: FmConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        gen, dev, dt = _setup(self, cfg, generator, device)
        v = cfg.n_sparse * cfg.vocab_per_field
        self.table = _table(v, cfg.embed_dim, gen, dev, dt)
        self.linear = _table(v, 1, gen, dev, dt)
        self.bias = layers.make_zeros((), dev, dt)

    def forward(self, sparse_ids) -> torch.Tensor:
        """sparse_ids: (B, n_sparse) globally-offset ids -> logits (B,)."""
        ids = self._ids(sparse_ids)
        emb = self.table[ids]                                  # (B, F, k)
        lin = self.linear[ids][..., 0].sum(-1)
        s = emb.sum(dim=1)                                     # (B, k)
        inter = 0.5 * (torch.square(s)
                       - torch.square(emb).sum(dim=1)).sum(-1)
        return self.bias + lin + inter

    def loss(self, sparse_ids, labels) -> torch.Tensor:
        return self._bce_loss(self.forward(sparse_ids), labels)


# ---------------------------------------------------------------------------
# Two-tower retrieval (YouTube RecSys'19)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    user_vocab: int = 1_000_000
    item_vocab: int = 1_000_000
    n_user_feats: int = 8
    n_item_feats: int = 4
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class TwoTower(_Recsys):
    """``user_table``, ``item_table`` (vocab, embed_dim), ``user_mlp`` and
    ``item_mlp`` (n_feats·embed_dim -> tower_mlp, ReLU between)."""

    def __init__(self, cfg: TwoTowerConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        gen, dev, dt = _setup(self, cfg, generator, device)
        self.user_table = _table(cfg.user_vocab, cfg.embed_dim, gen, dev, dt)
        self.item_table = _table(cfg.item_vocab, cfg.embed_dim, gen, dev, dt)
        self.user_mlp = layers.dense_stack(
            (cfg.n_user_feats * cfg.embed_dim,) + tuple(cfg.tower_mlp), gen,
            dev, dt)
        self.item_mlp = layers.dense_stack(
            (cfg.n_item_feats * cfg.embed_dim,) + tuple(cfg.tower_mlp), gen,
            dev, dt)

    def _tower(self, table, stack, feats) -> torch.Tensor:
        e = table[self._ids(feats)]
        x = layers.stack_fwd(stack, e.reshape(e.shape[0], -1), F.relu)
        # the reference adds 1e-6 after the norm, not inside it
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)

    def user_embedding(self, user_feats) -> torch.Tensor:
        """user_feats (B, n_user_feats) ids -> unit-norm (B, d)."""
        return self._tower(self.user_table, self.user_mlp, user_feats)

    def item_embedding(self, item_feats) -> torch.Tensor:
        """item_feats (B, n_item_feats) ids -> unit-norm (B, d)."""
        return self._tower(self.item_table, self.item_mlp, item_feats)

    def forward(self, user_feats, item_feats) -> torch.Tensor:
        """Per-pair scores <user, item> (B,) (the serving cells' step)."""
        return (self.user_embedding(user_feats)
                * self.item_embedding(item_feats)).sum(-1)

    def loss(self, user_feats, item_feats,
             temperature: float = 0.05) -> torch.Tensor:
        """In-batch sampled softmax (the reference's ``twotower_loss``)."""
        u = self.user_embedding(user_feats)
        i = self.item_embedding(item_feats)
        logits = torch.matmul(u, i.T) / temperature
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.mean(torch.diagonal(logp))

    def score_candidates(self, user_feats, cand_embeddings) -> torch.Tensor:
        """retrieval_cand: one query batch against the candidates' tower
        outputs, one product (no loop)."""
        u = self.user_embedding(user_feats)
        return torch.matmul(u, torch.as_tensor(cand_embeddings,
                                               device=self.device).T)


# ---------------------------------------------------------------------------
# DIEN (AUGRU interest evolution)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DienConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: Sequence[int] = (200, 80)
    item_vocab: int = 500_000
    dtype: str = "float32"
    unroll: int = 1            # the reference's scan knob; a loop here

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class Gru(nn.Module):
    """``wz``, ``wr``, ``wh`` (d_in + d_h, d_h), drawn at
    1/sqrt(d_in + d_h), no biases."""

    def __init__(self, d_in: int, d_h: int, generator, device, dtype):
        super().__init__()
        s = 1.0 / math.sqrt(d_in + d_h)
        mk = lambda: layers.make_param((d_in + d_h, d_h), s, generator,
                                       device, dtype)
        self.wz = mk()
        self.wr = mk()
        self.wh = mk()


def _gru_cell(p: Gru, h, x, att=None):
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(torch.matmul(hx, p.wz))
    r = torch.sigmoid(torch.matmul(hx, p.wr))
    hh = torch.tanh(torch.matmul(torch.cat([x, r * h], dim=-1), p.wh))
    if att is not None:           # AUGRU: attention scales the update gate
        z = z * att[:, None]
    return (1 - z) * h + z * hh


class Dien(_Recsys):
    """``item_table`` (vocab, k), ``gru1`` (k -> H), ``augru`` (H -> H),
    ``mlp`` (H + 2k -> mlp -> 1, ReLU between)."""

    def __init__(self, cfg: DienConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        gen, dev, dt = _setup(self, cfg, generator, device)
        self.item_table = _table(cfg.item_vocab, cfg.embed_dim, gen, dev, dt)
        self.gru1 = Gru(cfg.embed_dim, cfg.gru_dim, gen, dev, dt)
        self.augru = Gru(cfg.gru_dim, cfg.gru_dim, gen, dev, dt)
        self.mlp = layers.dense_stack(
            (cfg.gru_dim + 2 * cfg.embed_dim,) + tuple(cfg.mlp) + (1,), gen,
            dev, dt)

    def forward(self, hist_ids, target_ids) -> torch.Tensor:
        """hist_ids (B, S), target_ids (B,) -> logits (B,)."""
        cfg = self.cfg
        hist = self.item_table[self._ids(hist_ids)]            # (B, S, k)
        target = self.item_table[self._ids(target_ids)]        # (B, k)
        b, s = hist.shape[:2]
        h = torch.zeros((b, cfg.gru_dim), dtype=cfg.torch_dtype,
                        device=self.device)
        steps = []
        for t in range(s):              # one GRU cell a step, kept
            h = _gru_cell(self.gru1, h, hist[:, t])
            steps.append(h)
        interests = torch.stack(steps, dim=1)                  # (B, S, H)
        # attention of the target on the interests, softmax in float32
        proj = interests[..., :cfg.embed_dim]
        att = torch.softmax(torch.einsum("bsh,bh->bs", proj, target).float(),
                            dim=-1).to(cfg.torch_dtype)
        h = torch.zeros_like(h)
        for t in range(s):
            h = _gru_cell(self.augru, h, interests[:, t], att=att[:, t])
        feats = torch.cat([h, target, hist.mean(dim=1)], dim=-1)
        return layers.stack_fwd(self.mlp, feats, F.relu)[:, 0]

    def loss(self, hist_ids, target_ids, labels) -> torch.Tensor:
        return self._bce_loss(self.forward(hist_ids, target_ids), labels)


# ---------------------------------------------------------------------------
# DCN-v2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DcnV2Config:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: Sequence[int] = (1024, 1024, 512)
    vocab_per_field: int = 100_000
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def d_in(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


class DcnV2(_Recsys):
    """``table`` (F·V, k), ``cross.{i}`` (d_in x d_in and d_in: the
    reference's stacked ``cross`` leaves, one `layers.Dense` a layer),
    ``deep`` (d_in -> mlp, ReLU after every layer), ``head`` (d_in +
    mlp[-1] -> 1)."""

    def __init__(self, cfg: DcnV2Config, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        gen, dev, dt = _setup(self, cfg, generator, device)
        d = cfg.d_in
        self.table = _table(cfg.n_sparse * cfg.vocab_per_field,
                            cfg.embed_dim, gen, dev, dt)
        self.cross = nn.ModuleList(layers.Dense(d, d, gen, dev, dt)
                                   for _ in range(cfg.n_cross_layers))
        self.deep = layers.dense_stack((d,) + tuple(cfg.mlp), gen, dev, dt)
        self.head = layers.dense_stack((d + cfg.mlp[-1], 1), gen, dev, dt)

    def forward(self, dense, sparse_ids) -> torch.Tensor:
        """dense (B, n_dense) float; sparse_ids (B, n_sparse) -> logits
        (B,)."""
        emb = self.table[self._ids(sparse_ids)]
        dense = torch.as_tensor(dense, device=self.device)
        x0 = torch.cat([dense.to(self.cfg.torch_dtype),
                        emb.reshape(emb.shape[0], -1)], dim=-1)
        xc = x0
        for layer in self.cross:
            xc = x0 * layer(xc) + xc
        xd = layers.stack_fwd(self.deep, x0, F.relu, final_act=True)
        return layers.stack_fwd(self.head, torch.cat([xc, xd], -1),
                                F.relu)[:, 0]

    def loss(self, dense, sparse_ids, labels) -> torch.Tensor:
        return self._bce_loss(self.forward(dense, sparse_ids), labels)


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def table_spec(tp_axis: str = "model") -> ShardSpec:
    """Row-sharded embedding tables (the TBE layout)."""
    return ShardSpec.of(tp_axis, None)


MODELS = {"fm": Fm, "two-tower-retrieval": TwoTower, "dien": Dien,
          "dcn-v2": DcnV2}


__all__ = [
    "embedding_lookup", "embedding_bag",
    "FmConfig", "Fm", "TwoTowerConfig", "TwoTower",
    "DienConfig", "Gru", "Dien", "DcnV2Config", "DcnV2",
    "table_spec", "MODELS",
]
