"""GraphCast-style encode-process-decode GNN (counterpart of
``repro/models/gnn.py``; assigned arch: graphcast).

Message passing scatters over an explicit edge list (src, dst): the
reference's ``jax.ops.segment_sum`` is ``index_add`` here.  Float
scatter-adds sum in an order of their own, on the card from run to run
too (float atomics), so the port equals the reference within a
tolerance, not bit for bit; under ``torch.use_deterministic_algorithms``
PyTorch takes its deterministic scatter path.

`Gnn` holds the encoder (d_feat -> d -> d), the edge encoder (2d -> d),
``n_layers`` processor layers (edge MLP 3d -> d -> d, node MLP 2d -> d ->
d) and the decoder (d -> d -> n_vars), SiLU between the layers of each
MLP.  The reference stacks the processor layers along a leading
(n_layers,) axis and scans them; the port keeps one module per layer
(``layers.{i}.edge_mlp.0.w``), and `repro_torch.convert.gnn_params`
splits a reference tree's stacked leaves into them.  With ``cfg.remat``
and autograd recording, each layer is checkpointed
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
layer).  ``Gnn.forward`` and ``Gnn.loss`` are the reference's ``forward``
and ``loss_fn``.  Parameters are built with ``requires_grad`` off; a
trainer turns it on (``model.requires_grad_(True)``).

`build_csr` and `sample_fanout` are the reference's host-side neighbour
sampler, copied (numpy): the same ``np.random.Generator`` gives the same
subgraph bit for bit.

RemoteRAG applicability: none (no query/corpus structure); the arch runs
without the paper's technique.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class GnnConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    d_feat: int = 227          # input feature dim
    n_vars: int = 227          # output variables
    mesh_refinement: int = 6   # metadata (icosahedral level in the paper)
    aggregator: str = "sum"
    dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: int = 1       # the reference's scan knob; a loop here

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class GraphBatch(NamedTuple):
    node_feats: torch.Tensor    # (V, d_feat)
    edge_src: torch.Tensor      # (E,) int32
    edge_dst: torch.Tensor      # (E,) int32
    targets: torch.Tensor       # (V, n_vars)


class ProcessorLayer(nn.Module):
    """``edge_mlp`` (3d -> d -> d) and ``node_mlp`` (2d -> d -> d)."""

    def __init__(self, d: int, generator, device, dtype):
        super().__init__()
        self.edge_mlp = layers.dense_stack((3 * d, d, d), generator, device,
                                           dtype)
        self.node_mlp = layers.dense_stack((2 * d, d, d), generator, device,
                                           dtype)


def _process(layer: ProcessorLayer, h, e, msg_in, dst, deg):
    """One processor step (the reference's ``apply``): the edge update,
    its scatter-sum (a mean with ``deg``) onto the destination nodes,
    the node update; returns (h, e)."""
    e_new = e + layers.stack_fwd(layer.edge_mlp, msg_in, F.silu)
    agg = torch.zeros((h.shape[0], e_new.shape[1]), dtype=e_new.dtype,
                      device=e_new.device).index_add(0, dst, e_new)
    if deg is not None:
        agg = agg / deg[:, None]
    h_new = h + layers.stack_fwd(layer.node_mlp, torch.cat([h, agg], -1),
                                 F.silu)
    return h_new, e_new


class Gnn(nn.Module):
    """Parameters ``encoder.{0,1}``, ``edge_encoder.0``,
    ``layers.{i}.{edge_mlp,node_mlp}.{0,1}`` and ``decoder.{0,1}``, each a
    `layers.Dense` (``w``, ``b``), drawn from ``generator`` in that order
    at the reference's scales."""

    def __init__(self, cfg: GnnConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        d, dt = cfg.d_hidden, cfg.torch_dtype
        self.cfg = cfg
        self.encoder = layers.dense_stack((cfg.d_feat, d, d), gen, dev, dt)
        self.edge_encoder = layers.dense_stack((2 * d, d), gen, dev, dt)
        self.layers = nn.ModuleList(ProcessorLayer(d, gen, dev, dt)
                                    for _ in range(cfg.n_layers))
        self.decoder = layers.dense_stack((d, d, cfg.n_vars), gen, dev, dt)

    @property
    def device(self) -> torch.device:
        return self.decoder[0].w.device

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """Encode-process-decode; returns (V, n_vars) predictions in the
        config's dtype."""
        cfg, dev = self.cfg, self.device
        dt = cfg.torch_dtype
        src = torch.as_tensor(batch.edge_src, device=dev).long()
        dst = torch.as_tensor(batch.edge_dst, device=dev).long()
        feats = torch.as_tensor(batch.node_feats, device=dev).to(dt)
        h = layers.stack_fwd(self.encoder, feats, F.silu)
        e = layers.stack_fwd(self.edge_encoder,
                             torch.cat([h[src], h[dst]], -1), F.silu)
        deg = None
        if cfg.aggregator == "mean":
            # degrees counted in the config's dtype, as the reference does
            deg = torch.zeros(h.shape[0], dtype=dt, device=dev).index_add(
                0, dst, torch.ones(dst.shape[0], dtype=dt, device=dev))
            deg = torch.clamp(deg, min=1.0)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            # the message input is built outside the checkpointed step, as
            # the reference builds it outside its jax.checkpoint
            msg_in = torch.cat([h[src], h[dst], e], -1)
            if remat:
                h, e = checkpoint.checkpoint(_process, layer, h, e, msg_in,
                                             dst, deg, use_reentrant=False)
            else:
                h, e = _process(layer, h, e, msg_in, dst, deg)
        return layers.stack_fwd(self.decoder, h, F.silu)

    def loss(self, batch: GraphBatch) -> torch.Tensor:
        """Mean squared error in float32 (the reference's ``loss_fn``)."""
        pred = self.forward(batch).float()
        tgt = torch.as_tensor(batch.targets, device=self.device).float()
        return torch.mean(torch.square(pred - tgt))


def abstract_params(cfg: GnnConfig) -> dict:
    """{parameter name: ``meta`` tensor} with the reference's shapes (per
    layer) and the config's dtype, in `Gnn`'s state-dict order; allocates
    nothing."""
    return dict(Gnn(cfg, device="meta").named_parameters())


# ---------------------------------------------------------------------------
# neighbour sampler (host-side, for minibatch_lg): the reference's, copied
# ---------------------------------------------------------------------------

def build_csr(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int):
    """In-neighbour CSR: for each dst node, its src list."""
    order = np.argsort(edge_dst, kind="stable")
    sorted_src = edge_src[order]
    counts = np.bincount(edge_dst, minlength=n_nodes)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return offsets, sorted_src


def sample_fanout(rng: np.random.Generator, offsets, nbrs,
                  seed_nodes: np.ndarray, fanouts):
    """GraphSAGE-style layered fanout sampling -> one merged subgraph.

    Returns (the union of sampled nodes' global ids, local src ids, local
    dst ids); the caller attaches real features/targets by global id.
    """
    frontier = np.unique(seed_nodes)
    nodes = [frontier]
    src_list, dst_list = [], []
    for f in fanouts:
        new = []
        for u in frontier:
            lo, hi = offsets[u], offsets[u + 1]
            if hi == lo:
                continue
            cand = nbrs[lo:hi]
            take = cand if hi - lo <= f else rng.choice(cand, f, replace=False)
            for s in take:
                src_list.append(s)
                dst_list.append(u)
            new.append(take)
        frontier = np.unique(np.concatenate(new)) if new else np.array([], np.int64)
        nodes.append(frontier)
    all_nodes = np.unique(np.concatenate(nodes))
    local = {g: i for i, g in enumerate(all_nodes)}
    src = np.array([local[s] for s in src_list], np.int32)
    dst = np.array([local[d] for d in dst_list], np.int32)
    return all_nodes, src, dst


__all__ = ["GnnConfig", "GraphBatch", "ProcessorLayer", "Gnn",
           "abstract_params", "build_csr", "sample_fanout"]
