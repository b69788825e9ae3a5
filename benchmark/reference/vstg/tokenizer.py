"""The grounding model's text tokenization without vocabulary files: the
FNV-1a word-hash tokenizer (RoBERTa's special ids) and the static-length
batch encoding, written after the port's ``data/tokenizer.py``."""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

BOS_ID, PAD_ID, EOS_ID = 0, 1, 2


class HashTokenizer:
    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        ids = [BOS_ID]
        for w in re.findall(r"\w+|[^\s\w]", text.lower()):
            h = 2166136261
            for ch in w.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(4 + h % (self.vocab_size - 4))
        ids.append(EOS_ID)
        return ids


def batch_encode(tokenizer, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """[V, max_len] ids and True = token mask; a long text keeps its
    leading tokens and ends with EOS."""
    ids = np.full((len(texts), max_len), PAD_ID, dtype=np.int32)
    mask = np.zeros((len(texts), max_len), dtype=bool)
    for i, t in enumerate(texts):
        toks = tokenizer.encode(t)
        if len(toks) > max_len:
            toks = toks[: max_len - 1] + [EOS_ID]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = True
    return ids, mask
