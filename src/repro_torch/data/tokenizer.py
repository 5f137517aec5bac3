"""Deterministic hash tokenizer (no external vocab files).

Counterpart of ``repro/data/tokenizer.py`` (pure Python, copied): words map
to stable ids via FNV-1a over their UTF-8 bytes, so both packages give the
same ids for the same text.  Special ids: 0=pad, 1=bos, 2=eos, 3=unk;
hashed ids start at 4.
"""

from __future__ import annotations

from typing import List

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
RESERVED = 4


def _fnv1a(token: str) -> int:
    h = 0xCBF29CE484222325
    for b in token.encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    def __init__(self, vocab_size: int = 32768):
        if vocab_size <= RESERVED:
            raise ValueError(f"vocab_size {vocab_size} <= {RESERVED} "
                             f"reserved ids")
        self.vocab_size = vocab_size

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [RESERVED + _fnv1a(w) % (self.vocab_size - RESERVED)
               for w in text.lower().split()]
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def encode_batch(self, texts, seq_len: int) -> np.ndarray:
        """Pad/truncate to (len(texts), seq_len) int32 with pad=0; a
        truncated row keeps its BOS."""
        out = np.zeros((len(texts), seq_len), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[:seq_len]
            out[i, : len(ids)] = ids
        return out


__all__ = ["HashTokenizer", "PAD", "BOS", "EOS", "UNK", "RESERVED"]
