"""Tokenizer abstraction: HF tokenizers when weights/vocab are available
locally, and a deterministic byte-level fallback otherwise.

The port's own copy of ``vlm_tpu/data/tokenizer.py``, held equal to it by
``tests/test_torch_shared_layers.py``, for the tokenizers the zero-shot
path loads: the byte-level fallback, a SentencePiece ``tokenizer.model``
(Gemma, LLaMA) through the pure-Python reader, the byte-level BPE files of
OPT checkpoints through the pure-Python reader (:mod:`.bpe`), and a local
HF tokenizer.

The reference loads tokenizers implicitly through ``AutoProcessor``
(`reference/models/base_model.py:31`). Here tokenization is explicit:
generation operates on ids; the model adapters own prompt templates.

The byte fallback exists because this framework must be fully functional —
tests, benchmarks, multi-chip dry-runs — without any pretrained artifacts
(zero-egress environments). It is NOT a quality substitute: real checkpoints
ship their own tokenizer files, which :func:`load_tokenizer` picks up.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = False) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 3..258 are bytes 0..255.

    Specials: 0=pad, 1=bos, 2=eos. Deterministic, lossless, vocab 259 —
    fits the ``"test"`` model configs (vocab 512).
    """
    vocab_size = 259

    def __init__(self, bos_id: int = 1, eos_id: int = 2, pad_id: int = 0):
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 3 for i in ids
                     if 3 <= int(i) < 259)
        return data.decode("utf-8", errors="replace")


class SPTokenizer:
    """Loads a SentencePiece ``tokenizer.model`` with the pure-Python reader
    (:mod:`.sentencepiece`) — no transformers/sentencepiece
    dependency. This is what real Gemma/LLaMA checkpoint directories ship."""

    def __init__(self, model_file: str):
        from .sentencepiece import SentencePieceTokenizer
        self._sp = SentencePieceTokenizer.from_file(model_file)
        self.bos_id = self._sp.bos_id if self._sp.bos_id >= 0 else 1
        self.eos_id = self._sp.eos_id if self._sp.eos_id >= 0 else 2
        self.pad_id = self._sp.pad_id

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        return self._sp.encode(text, add_bos=add_bos)

    def decode(self, ids: Sequence[int]) -> str:
        return self._sp.decode(ids)


class HFTokenizer:
    """Wraps a local HF tokenizer (no hub access — local files only)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id \
            if self._tok.bos_token_id is not None else 1
        self.eos_id = self._tok.eos_token_id \
            if self._tok.eos_token_id is not None else 2
        self.pad_id = (self._tok.pad_token_id
                       if self._tok.pad_token_id is not None else 0)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(model_path: Optional[str] = None,
                   *, bos_id: int = 1, eos_id: int = 2,
                   pad_id: int = 0) -> Tokenizer:
    """Tokenizer from ``model_path`` (or ``$VLM_TPU_TOKENIZER``): HF
    tokenizer files when transformers can load them, else a raw
    SentencePiece ``tokenizer.model`` via the dependency-free reader
    (Vicuna/Gemma checkpoints), else byte-level BPE files via the
    dependency-free reader (:mod:`.bpe`, OPT/GPT-2 checkpoints:
    ``vocab.json``+``merges.txt`` or a BPE ``tokenizer.json``), else the
    byte-level fallback (with a WARN: only for genuinely missing files)."""
    path = model_path or os.getenv("VLM_TPU_TOKENIZER")
    if path and not Path(path).exists():
        # An explicitly requested tokenizer that is missing must not
        # degrade silently: byte-tokenized prompts produce garbage-quality
        # generations that still "run".
        print(f"[WARN] tokenizer path {path!r} does not exist; "
              f"using byte fallback", file=sys.stderr)
    if path and Path(path).exists():
        p = Path(path)
        sp_file = p if p.is_file() and p.suffix == ".model" else \
            p / "tokenizer.model"
        errors = []
        try:
            return HFTokenizer(str(p))
        except Exception as e:
            errors.append(f"transformers: {e}")
        if sp_file.exists():
            try:
                return SPTokenizer(str(sp_file))
            except Exception as e:
                errors.append(f"sentencepiece: {e}")
        try:
            from .bpe import load_bpe_dir, load_tokenizer_json
            if p.is_file():
                return load_tokenizer_json(str(p))
            return load_bpe_dir(str(p))
        except FileNotFoundError:
            pass    # no BPE files present — not an error for SP dirs
        except Exception as e:
            errors.append(f"byte-level BPE: {e}")
        print(f"[WARN] no loadable tokenizer at {path!r} "
              f"({'; '.join(errors)}); using byte fallback",
              file=sys.stderr)
    return ByteTokenizer(bos_id=bos_id, eos_id=eos_id, pad_id=pad_id)
