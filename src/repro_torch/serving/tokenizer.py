"""Byte-level tokenizer (copy of ``repro/serving/tokenizer.py``).

Tokens 0..255 are raw bytes; the remainder of the vocab is reserved for
specials.  Deterministic and reversible."""

from __future__ import annotations


class ByteTokenizer:
    def __init__(self, vocab_size: int):
        if vocab_size < 258:
            raise ValueError("byte tokenizer needs >= 258 ids")
        self.vocab_size = vocab_size
        self.bos = 256
        self.eos = 257

    def encode(self, text: str, *, add_bos=True) -> list[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.bos] if add_bos else []) + ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")
