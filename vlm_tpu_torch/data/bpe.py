"""Dependency-free byte-level BPE tokenizer (GPT-2 family): the port's own
copy of ``vlm_tpu/data/bpe.py``, held equal to it by
``tests/test_torch_shared_layers.py``.

OPT, BLIP-2's decoder, ships a GPT-2 byte-level BPE tokenizer. This reader
loads its on-disk formats with no transformers/tokenizers dependency:

- the classic GPT-2 file pair ``vocab.json`` + ``merges.txt`` (plus
  ``tokenizer_config.json`` / ``special_tokens_map.json`` /
  ``added_tokens.json`` for special ids), and
- the HF ``tokenizer.json`` single-file serialization of a BPE model with a
  ByteLevel pre-tokenizer.

Semantics matched (the original is parity-tested against the ``tokenizers``
library in ``tests/test_bpe.py``):

- GPT-2 byte→printable-unicode alphabet (every byte gets a dedicated char,
  so BPE operates on lossless visible strings);
- the GPT-2 pre-tokenization regex
  ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
  (via the ``regex`` module when importable, else a pure-Python scanner
  with identical semantics — fuzz-tested for equality);
- rank-ordered merge loop per pre-token, with a cache.
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→unicode-char table: printable ASCII and
    Latin-1 symbols map to themselves; the remaining bytes map to chars
    256+ so every byte has a visible, non-whitespace representative."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_ENC = bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

try:  # the regex module ships with transformers installs; optional here
    import regex as _regex
    _GPT2_PAT = _regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
        r"""|\s+(?!\S)|\s+""")
except ImportError:  # pragma: no cover - exercised via the fallback tests
    _regex = None
    _GPT2_PAT = None


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _pretokenize_fallback(text: str) -> List[str]:
    """Pure-Python scanner with the GPT-2 pattern's semantics: ordered
    alternation of contractions, optionally-space-prefixed letter/number/
    symbol runs, then whitespace (a run before content yields its last
    char to prefix the next token — the ``\\s+(?!\\S)`` backtrack)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            for suf in _CONTRACTIONS:
                if text.startswith(suf, i):
                    out.append(suf)
                    i += len(suf)
                    break
            else:
                # "other"-class run starting at the apostrophe
                k = i
                while (k < n and not text[k].isspace()
                       and not _is_letter(text[k])
                       and not _is_number(text[k])):
                    k += 1
                out.append(text[i:k])
                i = k
            continue
        j = i
        if c == " " and i + 1 < n and not text[i + 1].isspace():
            j = i + 1
            c = text[j]
        if _is_letter(c):
            k = j
            while k < n and _is_letter(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if _is_number(c):
            k = j
            while k < n and _is_number(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if not c.isspace():
            k = j
            while (k < n and not text[k].isspace()
                   and not _is_letter(text[k]) and not _is_number(text[k])):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # whitespace run; if content follows, leave its last char behind
        k = i
        while k < n and text[k].isspace():
            k += 1
        if k < n and k - i > 1:
            k -= 1
        out.append(text[i:k])
        i = k
    return out


def pretokenize(text: str) -> List[str]:
    if _GPT2_PAT is not None:
        return _GPT2_PAT.findall(text)
    return _pretokenize_fallback(text)


def _get_pairs(word: Tuple[str, ...]):
    return set(zip(word, word[1:]))


class ByteLevelBPE:
    """Byte-level BPE encoder/decoder over a loaded vocab + merge table.

    ``vocab`` maps token strings (in the byte→unicode alphabet) to ids;
    ``merges`` is the rank-ordered merge list. ``added_tokens`` maps raw
    token strings (NOT byte-mapped, e.g. ``"</s>"``) to ids; those marked
    special are skipped by :meth:`decode`.
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Iterable[Tuple[str, str]],
                 *, bos_id: int = 0, eos_id: int = 2, pad_id: int = 1,
                 unk_id: Optional[int] = None,
                 added_tokens: Optional[Dict[str, int]] = None,
                 special_ids: Optional[Iterable[int]] = None,
                 add_prefix_space: bool = False):
        self._vocab = dict(vocab)
        self._ranks = {tuple(m): i for i, m in enumerate(merges)}
        self._inv = {i: t for t, i in self._vocab.items()}
        self._added = dict(added_tokens or {})
        self._inv_added = {i: t for t, i in self._added.items()}
        self._cache: Dict[str, Tuple[str, ...]] = {}
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.unk_id = unk_id
        self._special_ids = set(special_ids or ())
        self._special_ids |= {bos_id, eos_id, pad_id}
        if unk_id is not None:
            self._special_ids.add(unk_id)
        self.add_prefix_space = add_prefix_space
        self.vocab_size = max(
            [len(self._vocab)] + [i + 1 for i in self._added.values()])

    # ---------------- core BPE ----------------
    def _bpe(self, token: str) -> Tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        if len(word) >= 2:
            pairs = _get_pairs(word)
            while True:
                best = min(pairs,
                           key=lambda p: self._ranks.get(p, 1 << 60))
                if best not in self._ranks:
                    break
                a, b = best
                merged: List[str] = []
                i = 0
                while i < len(word):
                    try:
                        j = word.index(a, i)
                    except ValueError:
                        merged.extend(word[i:])
                        break
                    merged.extend(word[i:j])
                    if j < len(word) - 1 and word[j + 1] == b:
                        merged.append(a + b)
                        i = j + 2
                    else:
                        merged.append(a)
                        i = j + 1
                word = tuple(merged)
                if len(word) == 1:
                    break
                pairs = _get_pairs(word)
        self._cache[token] = word
        return word

    # ---------------- public API ----------------
    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        ids: List[int] = [self.bos_id] if add_bos else []
        for piece in pretokenize(text):
            mapped = "".join(_BYTE_ENC[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                tid = self._vocab.get(sub)
                if tid is None:
                    # byte-level vocabs contain all 256 byte symbols, so
                    # this only triggers on truncated vocab files
                    for ch in sub:
                        cid = self._vocab.get(ch, self.unk_id)
                        if cid is not None:
                            ids.append(cid)
                else:
                    ids.append(tid)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                data = bytes(_BYTE_DEC[ch] for ch in "".join(buf)
                             if ch in _BYTE_DEC)
                out.append(data.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            if i in self._special_ids:
                continue
            added = self._inv_added.get(i)
            if added is not None:
                # added tokens hold raw text, not byte-mapped strings
                flush()
                out.append(added)
                continue
            tok = self._inv.get(i)
            if tok is not None:
                buf.append(tok)
        flush()
        return "".join(out)


# ---------------- file loaders ----------------

def _specials_from_config(path: Path) -> Dict[str, str]:
    """Special-token strings from tokenizer_config.json /
    special_tokens_map.json (either plain strings or AddedToken dicts)."""
    found: Dict[str, str] = {}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        f = path / name
        if not f.exists():
            continue
        try:
            cfg = json.loads(f.read_text())
        except (OSError, ValueError):
            continue
        for key in ("bos_token", "eos_token", "pad_token", "unk_token"):
            v = cfg.get(key)
            if isinstance(v, dict):
                v = v.get("content")
            if isinstance(v, str) and key not in found:
                found[key] = v
    return found


def _resolve_special_ids(lookup: Dict[str, int],
                         specials: Dict[str, str]) -> Dict[str, int]:
    """Map special-token strings to ids, with GPT-2/OPT-convention
    defaults when the config files are silent."""
    def find(*names):
        for nm in names:
            if nm in lookup:
                return lookup[nm]
        return None

    eos = (lookup.get(specials.get("eos_token", ""))
           if specials.get("eos_token") else None)
    if eos is None:
        eos = find("</s>", "<|endoftext|>")
    bos = (lookup.get(specials.get("bos_token", ""))
           if specials.get("bos_token") else None)
    if bos is None:
        bos = find("<s>") if find("<s>") is not None else eos
    pad = (lookup.get(specials.get("pad_token", ""))
           if specials.get("pad_token") else None)
    if pad is None:
        pad = find("<pad>") if find("<pad>") is not None else eos
    unk = (lookup.get(specials.get("unk_token", ""))
           if specials.get("unk_token") else None)
    if unk is None:
        unk = find("<unk>")
    out = {}
    if bos is not None:
        out["bos_id"] = bos
    if eos is not None:
        out["eos_id"] = eos
    if pad is not None:
        out["pad_id"] = pad
    if unk is not None:
        out["unk_id"] = unk
    return out


def load_bpe_dir(path: str) -> ByteLevelBPE:
    """Load a byte-level BPE tokenizer from a checkpoint directory holding
    either ``tokenizer.json`` (BPE model) or ``vocab.json`` +
    ``merges.txt``. Raises ``FileNotFoundError``/``ValueError`` when
    neither format is present/parseable."""
    p = Path(path)
    tj = p / "tokenizer.json"
    if tj.exists():
        return load_tokenizer_json(str(tj))
    vocab_f, merges_f = p / "vocab.json", p / "merges.txt"
    if not (vocab_f.exists() and merges_f.exists()):
        raise FileNotFoundError(
            f"no tokenizer.json or vocab.json+merges.txt under {path}")
    vocab = json.loads(vocab_f.read_text(encoding="utf-8"))
    merges: List[Tuple[str, str]] = []
    for line in merges_f.read_text(encoding="utf-8").splitlines():
        if not line or line.startswith("#version"):
            continue
        parts = line.split(" ")
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
    added: Dict[str, int] = {}
    at = p / "added_tokens.json"
    if at.exists():
        try:
            added = {str(k): int(v)
                     for k, v in json.loads(at.read_text()).items()}
        except (OSError, ValueError):
            added = {}
    lookup = dict(vocab)
    lookup.update(added)
    ids = _resolve_special_ids(lookup, _specials_from_config(p))
    return ByteLevelBPE(vocab, merges, added_tokens=added, **ids)


def load_tokenizer_json(path: str) -> ByteLevelBPE:
    """Load the HF single-file ``tokenizer.json`` serialization (BPE model
    with a ByteLevel pre-tokenizer)."""
    f = Path(path)
    data = json.loads(f.read_text(encoding="utf-8"))
    model = data.get("model") or {}
    if model.get("type") != "BPE":
        raise ValueError(
            f"tokenizer.json model type {model.get('type')!r} is not BPE")
    vocab = model["vocab"]
    raw_merges = model.get("merges", [])
    merges: List[Tuple[str, str]] = []
    for m in raw_merges:
        if isinstance(m, str):
            a, b = m.split(" ", 1)
            merges.append((a, b))
        else:
            merges.append((m[0], m[1]))
    added: Dict[str, int] = {}
    special_ids = set()
    for t in data.get("added_tokens", []):
        added[t["content"]] = int(t["id"])
        if t.get("special"):
            special_ids.add(int(t["id"]))
    # prefix-space behavior from the serialized pre-tokenizer (GPT-2/OPT
    # default: False)
    pre = data.get("pre_tokenizer") or {}
    pres = pre.get("pretokenizers", [pre]) if pre else []
    add_prefix = any(pt.get("type") == "ByteLevel"
                     and pt.get("add_prefix_space", False)
                     for pt in pres if isinstance(pt, dict))
    lookup = dict(vocab)
    lookup.update(added)
    ids = _resolve_special_ids(lookup, _specials_from_config(f.parent))
    return ByteLevelBPE(vocab, merges, added_tokens=added,
                        special_ids=special_ids,
                        add_prefix_space=add_prefix, **ids)


__all__ = ["ByteLevelBPE", "bytes_to_unicode", "pretokenize",
           "load_bpe_dir", "load_tokenizer_json"]
