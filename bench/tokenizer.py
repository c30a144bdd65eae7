"""The vocabulary the benchmark serves with: the port's byte encoding of
prompts, and a reading of served ids that shows every id.

The port's ``ByteTokenizer`` reads only the 256 byte ids back as text and
drops every other id.  The cells' vocabulary has 50304 ids and seeded
random weights, so nearly every served token would read as nothing, every
call's text would be the same, and a call handed another call's output
could not be told from a sound one.  This tokenizer, handed to
``LocalEngineBackend`` as its ``tokenizer``, encodes a prompt as the byte
tokenizer does (a BOS, 256, then the UTF-8 bytes, so prompt lengths stay
a function of the text's bytes) and reads each served id as three ASCII
characters, its number in base 64: any two different runs of ids read as
different text.
"""

from __future__ import annotations

DIGITS = ("0123456789abcdefghijklmnopqrstuvwxyz"
          "ABCDEFGHIJKLMNOPQRSTUVWXYZ-_")
WIDTH = 3           # characters an id reads as: 64 ** 3 > every vocabulary
BOS, EOS = 256, 257


def encode(text: str) -> list[int]:
    """A prompt's ids: the BOS, then its UTF-8 bytes."""
    return [BOS] + list(text.encode("utf-8", errors="replace"))


def read_ids(ids) -> str:
    """Each id as WIDTH base-64 characters, most significant first."""
    out = []
    for i in ids:
        i = int(i)
        for shift in range(WIDTH - 1, -1, -1):
            out.append(DIGITS[(i >> (6 * shift)) & 63])
    return "".join(out)


class IdTokenizer:
    """The tokenizer ``LocalEngineBackend`` takes: ``encode`` and
    ``decode`` as above."""

    def __init__(self, vocab_size: int):
        if not 258 <= vocab_size <= len(DIGITS) ** WIDTH:
            raise ValueError(f"vocabulary of {vocab_size} ids: 258 to "
                             f"{len(DIGITS) ** WIDTH}")
        self.vocab_size = vocab_size
        self.bos, self.eos = BOS, EOS

    def encode(self, text: str) -> list[int]:
        return encode(text)

    def decode(self, ids) -> str:
        return read_ids(ids)
