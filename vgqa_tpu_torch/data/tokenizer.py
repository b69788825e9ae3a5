"""Host-side text tokenization for the grounding model (a copy of
``vgqa_tpu/data/tokenizer.py``: the port imports nothing of the JAX package).

The reference calls HF ``RobertaTokenizerFast`` inside the model's forward
(the reference's vgqa/core/language/bert.py:50,65). TPU-natively, tokenization
is a host preprocessing step producing static [V, L] id/mask arrays.

Two implementations:

* :class:`ByteLevelBPETokenizer` — a from-scratch GPT-2/RoBERTa byte-level
  BPE. Loads ``vocab.json`` + ``merges.txt`` (the standard HF asset format)
  from ``MODEL.TEXT_MODEL.VOCAB_DIR`` and reproduces roberta-base ids.
* :class:`HashTokenizer` — deterministic stand-in used when no vocab assets
  exist on disk (this environment has no network access). Same interface and
  special-token layout, so the rest of the stack is asset-agnostic.
"""

from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

# RoBERTa special token ids
BOS_ID = 0   # <s>
PAD_ID = 1   # <pad>
EOS_ID = 2   # </s>
UNK_ID = 3   # <unk>

# GPT-2/RoBERTa pre-tokenization. HF's canonical pattern (regex module) is
#   's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
# stdlib-re translation: [^\W\d_] = \p{L}; \d = \p{N} (decimal subset);
# underscore is routed to the punctuation class like HF does. Mixed
# alphanumerics ("2nd", "covid19") therefore split letters/digits exactly
# like roberta-base (tests/test_tokenizer.py asserts parity vs the regex
# module's canonical pattern).
_GPT2_SPLIT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+"
)


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte->unicode map (avoids unprintable bytes)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ByteLevelBPETokenizer:
    """From-scratch byte-level BPE (GPT-2 algorithm) with RoBERTa specials."""

    def __init__(self, vocab_dir: str):
        with open(os.path.join(vocab_dir, "vocab.json")) as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(vocab_dir, "merges.txt"), encoding="utf-8") as f:
            merges = [
                tuple(line.split())
                for line in f.read().split("\n")
                if line and not line.startswith("#version")
            ]
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = [BOS_ID]
        for chunk in _GPT2_SPLIT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder.get(piece, UNK_ID))
        ids.append(EOS_ID)
        return ids


class HashTokenizer:
    """Deterministic whitespace/punct tokenizer mapping words to hashed ids.

    Stand-in with the same interface/special ids as the BPE tokenizer, used
    when no vocab assets are present. Ids land in [4, vocab_size)."""

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        ids = [BOS_ID]
        for w in re.findall(r"\w+|[^\s\w]", text.lower()):
            h = 2166136261
            for ch in w.encode("utf-8"):  # FNV-1a, stable across runs
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(4 + h % (self.vocab_size - 4))
        ids.append(EOS_ID)
        return ids


def build_tokenizer(vocab_dir: str = "", vocab_size: int = 50265):
    if vocab_dir and os.path.exists(os.path.join(vocab_dir, "vocab.json")):
        return ByteLevelBPETokenizer(vocab_dir)
    return HashTokenizer(vocab_size)


def batch_encode(
    tokenizer, texts: Sequence[str], max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize to static [V, max_len] ids + True=valid mask.

    Truncation keeps the leading tokens and always terminates with EOS,
    mirroring fixed MAX_QUERY_LEN padding (reference defaults.py:6)."""
    v = len(texts)
    ids = np.full((v, max_len), PAD_ID, dtype=np.int32)
    mask = np.zeros((v, max_len), dtype=bool)
    for i, t in enumerate(texts):
        toks = tokenizer.encode(t)
        if len(toks) > max_len:
            toks = toks[: max_len - 1] + [EOS_ID]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = True
    return ids, mask
