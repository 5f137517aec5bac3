"""Architecture registry: ``--arch <id>`` -> config + reduced config + shapes.

Counterpart of ``repro/configs/registry.py`` for what the port runs: the
five LMs and the RemoteRAG service config.  `ArchEntry` has no
``build_cell``: the reference's cell builders (``families.py``) lower a
step onto a device mesh and wait for the multi-device slice (ROADMAP
queue 1, item 2); the GNN and recsys entries come with their models
(ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (granite_moe_3b_a800m, llama3_8b, qwen25_14b,
                                 qwen3_8b, qwen3_moe_30b_a3b, remoterag,
                                 shapes)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str                  # "lm" | "rag" (the port's families)
    config: object
    reduced: object
    shapes: Dict[str, object]

    def scan_trip_count(self) -> int:
        """Trip count of the dominant scan (layers of an LM); 0 = none."""
        return self.config.n_layers if self.family == "lm" else 0


def _lm(arch_id, mod):
    return ArchEntry(arch_id, "lm", mod.CONFIG, mod.REDUCED, shapes.LM_SHAPES)


REGISTRY: Dict[str, ArchEntry] = {
    "llama3-8b": _lm("llama3-8b", llama3_8b),
    "qwen3-8b": _lm("qwen3-8b", qwen3_8b),
    "qwen2.5-14b": _lm("qwen2.5-14b", qwen25_14b),
    "qwen3-moe-30b-a3b": _lm("qwen3-moe-30b-a3b", qwen3_moe_30b_a3b),
    "granite-moe-3b-a800m": _lm("granite-moe-3b-a800m", granite_moe_3b_a800m),
    "remoterag": ArchEntry("remoterag", "rag", remoterag.RLWE,
                           remoterag.RLWE, shapes.REMOTERAG_SHAPES),
}


def get(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["ArchEntry", "REGISTRY", "get"]
