"""Tokenizer wrapper: cached HF tokenizers + an offline byte fallback.

Capability parity with the reference's ``api/tokenizer.py:8-48``:
process-wide instance cache with a lock, memoized encode/decode, batch
helpers, pad=eos. Adds a dependency-free ``byte`` tokenizer so the
engine, tests, and servers run with zero network access (HF hub pulls
are impossible in the target environment).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence

_CACHE: Dict[str, "Tokenizer"] = {}
_LOCK = threading.Lock()


class ByteTokenizer:
    """Reversible byte-level tokenizer: token = byte value (+specials).

    vocab: 0..255 bytes, 256 = BOS, 257 = EOS, 258 = PAD.
    """

    vocab_size = 259
    bos_token_id = 256
    eos_token_id = 257
    pad_token_id = 258

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class Tokenizer:
    """Uniform facade over HF tokenizers and the byte fallback."""

    def __init__(self, name_or_path: str = "byte"):
        self.name = name_or_path
        if name_or_path == "byte":
            self._tok = ByteTokenizer()
            self.eos_token_id = ByteTokenizer.eos_token_id
            self.pad_token_id = ByteTokenizer.pad_token_id
            self.vocab_size = ByteTokenizer.vocab_size
        else:
            from transformers import AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(name_or_path)
            if self._tok.pad_token is None:       # reference: pad = eos
                self._tok.pad_token = self._tok.eos_token
            self.eos_token_id = self._tok.eos_token_id
            self.pad_token_id = self._tok.pad_token_id
            self.vocab_size = len(self._tok)

    # memoized single-string paths (reference: lru_cache(4096))
    @functools.lru_cache(maxsize=4096)
    def _encode_cached(self, text: str) -> tuple:
        if isinstance(self._tok, ByteTokenizer):
            return tuple(self._tok.encode(text))
        return tuple(self._tok.encode(text, add_special_tokens=False))

    def encode(self, text: str) -> List[int]:
        return list(self._encode_cached(text))

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        if isinstance(self._tok, ByteTokenizer):
            return self._tok.decode(ids)
        return self._tok.decode(list(ids),
                                skip_special_tokens=skip_special_tokens)

    def decode_token(self, token_id: int) -> str:
        """Single-token decode for streaming output."""
        return self.decode([token_id])

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def decode_batch(self, batches: Sequence[Sequence[int]]) -> List[str]:
        return [self.decode(b) for b in batches]


def get_tokenizer(name_or_path: str = "byte") -> Tokenizer:
    """Process-wide cached tokenizer instances (thread-safe)."""
    with _LOCK:
        if name_or_path not in _CACHE:
            _CACHE[name_or_path] = Tokenizer(name_or_path)
        return _CACHE[name_or_path]
