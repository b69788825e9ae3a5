"""SentencePiece BPE tokenizer (dependency-free reader + encoder): a copy of
``vgqa_tpu/qa/sp_tokenizer.py`` (the port imports nothing of the JAX package).

InternLM2-family checkpoints ship a SentencePiece ``tokenizer.model``
(protobuf ModelProto); the ``sentencepiece`` library is not available in
this environment, so this module parses the proto directly (varint wire
format — only the `pieces` field is needed) and implements BPE encoding
with byte fallback:

* text is pre-tokenized by replacing spaces with the U+2581 marker,
* adjacent pieces are merged greedily by piece score (SP-BPE semantics),
* characters outside the vocab fall back to <0xXX> byte pieces.

decode() inverts both steps, so chat round-trips exactly.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

SPACE = "▁"

# SentencePiece piece types
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_model_proto(data: bytes):
    """Extract (piece, score, type) triples from a ModelProto blob."""
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            length, pos = _read_varint(data, pos)
            sub = data[pos : pos + length]
            pos += length
            piece, score, ptype = "", 0.0, NORMAL
            spos = 0
            while spos < len(sub):
                stag, spos = _read_varint(sub, spos)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    slen, spos = _read_varint(sub, spos)
                    piece = sub[spos : spos + slen].decode("utf-8", "replace")
                    spos += slen
                elif sfield == 2 and swire == 5:
                    (score,) = struct.unpack("<f", sub[spos : spos + 4])
                    spos += 4
                elif sfield == 3 and swire == 0:
                    ptype, spos = _read_varint(sub, spos)
                else:  # skip unknown subfield
                    spos = _skip(sub, spos, swire)
            pieces.append((piece, score, ptype))
        else:
            pos = _skip(data, pos, wire)
    return pieces


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        length, pos = _read_varint(buf, pos)
        pos += length
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


class SentencePieceBPE:
    """BPE encode/decode over a parsed SentencePiece vocabulary."""

    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            pieces = parse_model_proto(f.read())
        self.id_to_piece = [p for p, _, _ in pieces]
        self.piece_to_id: Dict[str, int] = {
            p: i for i, (p, _, _) in enumerate(pieces)
        }
        self.scores = [s for _, s, _ in pieces]
        self.types = [t for _, _, t in pieces]
        self.byte_ids: Dict[int, int] = {}
        for i, (p, _, t) in enumerate(pieces):
            if t == BYTE and p.startswith("<0x") and p.endswith(">"):
                self.byte_ids[int(p[3:-1], 16)] = i
        self.unk_id = next(
            (i for i, t in enumerate(self.types) if t == UNKNOWN), 0
        )
        self.vocab_size = len(pieces)
        # chat special tokens (InternLM2 layout when present)
        self.BOS = self.piece_to_id.get("<s>", 1)
        self.EOS = self.piece_to_id.get("</s>", 2)
        self.PAD = self.piece_to_id.get("<unk>", 0)
        self.IM_START = self.piece_to_id.get("<|im_start|>", self.BOS)
        self.IM_END = self.piece_to_id.get("<|im_end|>", self.EOS)
        self.IMG_CONTEXT = self.piece_to_id.get("<IMG_CONTEXT>", self.unk_id)
        self.IMG_START = self.piece_to_id.get("<img>", self.IM_START)
        self.IMG_END = self.piece_to_id.get("</img>", self.IM_END)

    def _encode_word(self, word: str) -> List[int]:
        symbols = list(word)
        if not symbols:
            return []
        while True:
            best_score, best_i = None, -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                pid = self.piece_to_id.get(merged)
                if pid is not None:
                    s = self.scores[pid]
                    if best_score is None or s > best_score:
                        best_score, best_i = s, i
            if best_i < 0:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        ids: List[int] = []
        for sym in symbols:
            pid = self.piece_to_id.get(sym)
            if pid is not None:
                ids.append(pid)
            else:  # byte fallback
                for b in sym.encode("utf-8"):
                    ids.append(self.byte_ids.get(b, self.unk_id))
        return ids

    def encode(self, text: str) -> List[int]:
        text = SPACE + text.replace(" ", SPACE)
        return self._encode_word(text)

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", "replace"))
                byte_buf.clear()

        for i in ids:
            if not 0 <= i < self.vocab_size:
                continue
            if self.types[i] == BYTE:
                byte_buf.append(int(self.id_to_piece[i][3:-1], 16))
                continue
            flush()
            if self.types[i] in (CONTROL, UNKNOWN):
                continue
            out.append(self.id_to_piece[i])
        flush()
        return "".join(out).replace(SPACE, " ").lstrip(" ")
