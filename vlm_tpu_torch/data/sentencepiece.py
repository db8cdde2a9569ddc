"""Pure-Python SentencePiece model loader + encoder/decoder.

The port's own copy of ``vlm_tpu/data/sentencepiece.py``, held equal to it by
``tests/test_torch_shared_layers.py``.

Real Gemma/LLaMA checkpoints ship a ``tokenizer.model`` (a serialized
SentencePiece ``ModelProto``). The reference reaches it through HF
``AutoProcessor``; this module loads it with ZERO dependencies — no
``sentencepiece`` binding, no ``transformers`` — so generation works from a
bare checkpoint directory in zero-egress environments.

Implements the inference subset that matters for decoding and prompt
encoding:

- minimal protobuf wire-format reader for ``ModelProto`` (pieces with
  piece/score/type, trainer_spec ids + model_type + byte_fallback,
  normalizer_spec whitespace handling);
- **unigram** encoding (Viterbi over piece log-probs, the SentencePiece
  default) and **BPE** encoding (highest-score adjacent merge, ties to the
  left — scores in SP BPE models are ``-merge_rank``);
- byte fallback (``<0xXX>`` pieces) for out-of-vocabulary characters;
- decoding with control-piece skipping, byte-piece assembly and ``▁``
  whitespace restoration.

Normalization: when the model ships a ``precompiled_charsmap`` (the
NormalizerSpec's compiled NFKC rule trie), it is applied exactly — the
Darts-clone double-array is decoded and longest-prefix replacement runs
byte-for-byte like sentencepiece's ``Normalizer::NormalizePrefix``. When the
charsmap is absent but the normalizer name requests NFKC (``nmt_nfkc``,
the SentencePiece default), ``unicodedata.normalize("NFKC", …)`` is used —
a close approximation (the nmt ruleset additionally folds some control
characters to space) validated against NFKC goldens in
tests/test_sentencepiece.py.
"""

from __future__ import annotations

import dataclasses
import struct
import sys
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

WS = "▁"  # ▁ — SentencePiece's escaped whitespace

# SentencePiece.Type enum
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2
_UNK_PENALTY = 10.0


# ------------------------- protobuf wire reader -------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 0x7
        if wire == 0:                                  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:                                # 64-bit
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:                                # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:                                # 32-bit
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


@dataclasses.dataclass
class Piece:
    text: str
    score: float
    type: int = NORMAL


@dataclasses.dataclass
class SPModel:
    pieces: List[Piece]
    model_type: int = UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    byte_fallback: bool = False
    add_dummy_prefix: bool = True
    escape_whitespaces: bool = True
    remove_extra_whitespaces: bool = True
    normalizer_name: str = ""
    precompiled_charsmap: bytes = b""


def parse_model_proto(data: bytes) -> SPModel:
    """Parse a serialized sentencepiece ``ModelProto``."""
    pieces: List[Piece] = []
    model = SPModel(pieces=pieces)

    for field, wire, val in _fields(data):
        if field == 1 and wire == 2:                   # SentencePiece
            text, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    text = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(Piece(text, score, ptype))
        elif field == 2 and wire == 2:                 # TrainerSpec
            for f2, w2, v2 in _fields(val):
                if f2 == 3 and w2 == 0:
                    model.model_type = v2
                elif f2 == 35 and w2 == 0:
                    model.byte_fallback = bool(v2)
                elif f2 == 40 and w2 == 0:
                    model.unk_id = v2
                elif f2 == 41 and w2 == 0:
                    model.bos_id = _signed(v2)
                elif f2 == 42 and w2 == 0:
                    model.eos_id = _signed(v2)
                elif f2 == 43 and w2 == 0:
                    model.pad_id = _signed(v2)
        elif field == 3 and wire == 2:                 # NormalizerSpec
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    model.normalizer_name = v2.decode("utf-8")
                elif f2 == 2 and w2 == 2:
                    model.precompiled_charsmap = bytes(v2)
                elif f2 == 3 and w2 == 0:
                    model.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    model.remove_extra_whitespaces = bool(v2)
                elif f2 == 5 and w2 == 0:
                    model.escape_whitespaces = bool(v2)
    return model


# ------------------------- charsmap normalizer -------------------------

class PrecompiledCharsMap:
    """The NormalizerSpec's compiled rule table: a Darts-clone double-array
    trie over UTF-8 byte sequences plus a pool of replacement strings.
    Blob layout (sentencepiece ``DecodePrecompiledCharsMap``):
    ``[uint32 LE trie_size][trie units][normalized-string pool]``; trie
    values are byte offsets of NUL-terminated replacements in the pool."""

    def __init__(self, blob: bytes):
        import array as _array
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap blob too short")
        trie_size = struct.unpack("<I", blob[:4])[0]
        if 4 + trie_size > len(blob) or trie_size % 4:
            raise ValueError("corrupt precompiled_charsmap header")
        units = _array.array("I")
        units.frombytes(blob[4:4 + trie_size])
        if sys.byteorder != "little":
            units.byteswap()   # big-endian hosts: units are LE on disk
        self._units = units
        self._pool = blob[4 + trie_size:]

    # Darts-clone DoubleArrayUnit accessors (darts.h)
    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def _longest_match(self, data: bytes, start: int) -> Optional[Tuple[int, int]]:
        """Longest common-prefix trie match of ``data[start:]``.
        Returns (matched_byte_len, pool_offset) or None."""
        units = self._units
        n = len(units)
        node_pos = 0
        unit = units[0]
        node_pos ^= self._offset(unit)
        best = None
        for i in range(start, len(data)):
            c = data[i]
            node_pos ^= c
            if node_pos >= n:
                break
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:   # label mismatch
                break
            node_pos ^= self._offset(unit)
            if (unit >> 8) & 1:            # has_leaf
                if node_pos >= n:          # truncated/corrupt blob: the
                    break                  # leaf offset points past the
                                           # units array (same guard as
                                           # the label read above)
                best = (i - start + 1, units[node_pos] & 0x7FFFFFFF)
        return best

    def _replacement(self, offset: int) -> str:
        end = self._pool.find(b"\0", offset)
        end = len(self._pool) if end < 0 else end
        return self._pool[offset:end].decode("utf-8", errors="replace")

    def normalize(self, text: str) -> str:
        """Longest-prefix rule replacement over the UTF-8 bytes, unmatched
        characters pass through (sentencepiece ``Normalizer::Normalize``
        without the space handling, which the tokenizer applies after)."""
        data = text.encode("utf-8")
        out: List[str] = []
        i = 0
        n = len(data)
        while i < n:
            m = self._longest_match(data, i)
            if m is not None:
                length, off = m
                out.append(self._replacement(off))
                i += length
            else:
                # consume one UTF-8 character unchanged
                step = 1
                first = data[i]
                if first >= 0xF0:
                    step = 4
                elif first >= 0xE0:
                    step = 3
                elif first >= 0xC0:
                    step = 2
                out.append(data[i:i + step].decode("utf-8",
                                                   errors="replace"))
                i += step
        return "".join(out)


def _signed(v: int) -> int:
    """int32 fields (ids can be -1) arrive as 64-bit varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ------------------------- tokenizer -------------------------

class SentencePieceTokenizer:
    """Encode/decode against a parsed SentencePiece model."""

    def __init__(self, model: SPModel):
        self.model = model
        self._piece_to_id: Dict[str, int] = {}
        self._byte_to_id: Dict[int, int] = {}
        for i, p in enumerate(model.pieces):
            # first occurrence wins (duplicate pieces are not expected)
            self._piece_to_id.setdefault(p.text, i)
            if p.type == BYTE:
                self._byte_to_id[int(p.text[1:-1], 16)] = i
        self._max_piece_len = max((len(p.text) for p in model.pieces
                                   if p.type in (NORMAL, USER_DEFINED)),
                                  default=1)
        self.unk_id = model.unk_id
        self.bos_id = model.bos_id
        self.eos_id = model.eos_id
        self.pad_id = model.pad_id if model.pad_id >= 0 else 0
        self.vocab_size = len(model.pieces)
        # Character normalization (see module docstring): exact charsmap
        # replay when the model ships one; unicodedata NFKC when the spec
        # merely names an nfkc ruleset; identity otherwise.
        self._charsmap: Optional[PrecompiledCharsMap] = None
        self._use_nfkc = False
        self._use_casefold = False
        if model.precompiled_charsmap:
            self._charsmap = PrecompiledCharsMap(model.precompiled_charsmap)
        elif "nfkc" in model.normalizer_name.lower():
            self._use_nfkc = True
            # "nfkc_cf"/"nmt_nfkc_cf" rulesets case-fold after NFKC.
            self._use_casefold = "_cf" in model.normalizer_name.lower()

    @classmethod
    def from_file(cls, path) -> "SentencePieceTokenizer":
        return cls(parse_model_proto(Path(path).read_bytes()))

    # ---------------- normalization ----------------
    def _normalize(self, text: str) -> str:
        m = self.model
        if self._charsmap is not None:
            text = self._charsmap.normalize(text)
        elif self._use_nfkc:
            text = unicodedata.normalize("NFKC", text)
            if self._use_casefold:
                text = text.casefold()
        if m.remove_extra_whitespaces:
            text = " ".join(text.split()) if text.strip() else text.strip()
        if m.add_dummy_prefix and text:
            text = " " + text
        if m.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    def _score(self, piece: str) -> Optional[float]:
        i = self._piece_to_id.get(piece)
        if i is None:
            return None
        p = self.model.pieces[i]
        if p.type in (CONTROL, UNUSED):
            return None       # control pieces never match raw text
        return p.score

    # ---------------- encoding ----------------
    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        s = self._normalize(text)
        if self.model.model_type == BPE:
            toks = self._encode_bpe(s)
        else:
            toks = self._encode_unigram(s)
        ids: List[int] = []
        for t in toks:
            i = self._piece_to_id.get(t)
            if i is not None and self.model.pieces[i].type != CONTROL:
                ids.append(i)
            elif self.model.byte_fallback and self._byte_to_id:
                ids.extend(self._byte_to_id.get(b, self.unk_id)
                           for b in t.encode("utf-8"))
            else:
                ids.append(self.unk_id)
        if add_bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        if add_eos and self.eos_id >= 0:
            ids = ids + [self.eos_id]
        return ids

    def _encode_unigram(self, s: str) -> List[str]:
        """Viterbi segmentation maximizing the sum of piece log-probs.
        Unknown characters cost ``unk_score - kUnkPenalty``."""
        if not s:
            return []
        n = len(s)
        unk_score = self.model.pieces[self.unk_id].score - _UNK_PENALTY \
            if 0 <= self.unk_id < len(self.model.pieces) else -20.0
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            # single-char fallback (unk) keeps the lattice connected
            limit = min(n, i + self._max_piece_len)
            matched_single = False
            for j in range(i + 1, limit + 1):
                sc = self._score(s[i:j])
                if sc is None:
                    continue
                if j == i + 1:
                    matched_single = True
                cand = best[i] + sc
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, s[i:j])
            if not matched_single:
                cand = best[i] + unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, s[i:i + 1])
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece)
            j = i
        return out[::-1]

    def _encode_bpe(self, s: str) -> List[str]:
        """Merge the adjacent pair with the highest merged-piece score
        (SP BPE stores scores as -merge_rank), ties to the leftmost."""
        symbols = list(s)
        while len(symbols) > 1:
            best_idx, best_score = -1, None
            for i in range(len(symbols) - 1):
                sc = self._score(symbols[i] + symbols[i + 1])
                if sc is not None and (best_score is None or sc > best_score):
                    best_idx, best_score = i, sc
            if best_idx < 0:
                break
            symbols[best_idx:best_idx + 2] = [symbols[best_idx] +
                                              symbols[best_idx + 1]]
        return symbols

    # ---------------- decoding ----------------
    def decode(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.model.pieces):
                continue
            p = self.model.pieces[i]
            if p.type == BYTE:
                byte_buf.append(int(p.text[1:-1], 16))
                continue
            flush()
            if p.type in (CONTROL, UNUSED):
                continue
            if p.type == UNKNOWN:
                parts.append(" ⁇ ")  # sentencepiece's unk surface
                continue
            parts.append(p.text)
        flush()
        text = "".join(parts)
        if self.model.escape_whitespaces:
            text = text.replace(WS, " ")
        if self.model.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text
