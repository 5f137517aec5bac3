"""Architecture registry: ``--arch <id>`` -> config + shapes + cell function.

Counterpart of ``repro/configs/registry.py``: the five LMs, the GNN, the
four recsys models and the RemoteRAG service config, each with its
reduced config, its shape set (`repro_torch.configs.shapes`) and its cell
function (`repro_torch.configs.families`).  ``ASSIGNED`` is every arch but
the service's own; `cells` builds an arch's cells over a mesh given as a
shape and axis names (`families.MeshShape`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

from repro_torch.configs import (dcn_v2, dien, families, fm,
                                 granite_moe_3b_a800m, graphcast, llama3_8b,
                                 qwen25_14b, qwen3_8b, qwen3_moe_30b_a3b,
                                 remoterag, shapes, two_tower_retrieval)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str                  # "lm" | "gnn" | "recsys" | "rag"
    config: object
    reduced: object
    shapes: Dict[str, object]
    build_cell: Callable         # (config, shape, mesh, **kw) -> families.Cell

    def scan_trip_count(self) -> int:
        """Trip count of the dominant scan (for roofline extrapolation);
        0 = no scan."""
        if self.family in ("lm", "gnn"):
            return self.config.n_layers
        if self.arch_id == "dien":
            return self.config.seq_len
        return 0


def _lm(arch_id, mod):
    return ArchEntry(arch_id, "lm", mod.CONFIG, mod.REDUCED,
                     shapes.LM_SHAPES, families.lm_cell)


def _gnn(arch_id, mod):
    return ArchEntry(arch_id, "gnn", mod.CONFIG, mod.REDUCED,
                     shapes.GNN_SHAPES, families.gnn_cell)


def _recsys(arch_id, mod):
    return ArchEntry(
        arch_id, "recsys", mod.CONFIG, mod.REDUCED, shapes.RECSYS_SHAPES,
        lambda cfg, shp, mesh, **kw: families.recsys_cell(
            arch_id, cfg, shp, mesh, **kw))


REGISTRY: Dict[str, ArchEntry] = {
    "llama3-8b": _lm("llama3-8b", llama3_8b),
    "qwen3-8b": _lm("qwen3-8b", qwen3_8b),
    "qwen2.5-14b": _lm("qwen2.5-14b", qwen25_14b),
    "qwen3-moe-30b-a3b": _lm("qwen3-moe-30b-a3b", qwen3_moe_30b_a3b),
    "granite-moe-3b-a800m": _lm("granite-moe-3b-a800m", granite_moe_3b_a800m),
    "graphcast": _gnn("graphcast", graphcast),
    "fm": _recsys("fm", fm),
    "two-tower-retrieval": _recsys("two-tower-retrieval", two_tower_retrieval),
    "dien": _recsys("dien", dien),
    "dcn-v2": _recsys("dcn-v2", dcn_v2),
    "remoterag": ArchEntry(
        "remoterag", "rag", remoterag.RLWE, remoterag.RLWE,
        shapes.REMOTERAG_SHAPES,
        lambda cfg, shp, mesh, **kw: families.remoterag_cell(
            shp, mesh, cfg, **kw)),
}

ASSIGNED = [a for a in REGISTRY if a != "remoterag"]


def get(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(REGISTRY)}")
    return REGISTRY[arch_id]


def cells(arch_id: str, mesh, shape_names: Sequence[str] = ()) -> list:
    """``arch_id``'s cells over ``mesh`` (`families.MeshShape`), one per
    shape of ``shape_names`` (all of the arch's by default)."""
    entry = get(arch_id)
    names = shape_names or list(entry.shapes)
    return [entry.build_cell(entry.config, entry.shapes[s], mesh)
            for s in names]


__all__ = ["ArchEntry", "REGISTRY", "ASSIGNED", "get", "cells"]
