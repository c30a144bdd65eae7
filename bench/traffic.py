"""The one traffic generator: it reads a mix file (``mixes/<name>.json``)
and makes, from the seed alone, the inputs of every program the cell
runs.

Text is ASCII, so under the byte encoding of prompts
(``tokenizer.IdTokenizer``) one character is one token (and the tokenizer
adds a BOS).  A program's calls, their prompt lengths and their
``max_tokens`` are functions of the seed alone: the programs fold each
model output into a later prompt only after cutting or padding it to a
fixed number of bytes (``programs.fit_text``), and decoding is greedy
with no stop token.

Every seed gets the same sizes: document lengths are dealt in blocks of
``clients`` programs, evenly spaced over the mix's range and shuffled by
the seed, so a block's work is the same whatever the seed.
"""

from __future__ import annotations

import numpy as np

ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", dtype=np.uint8)

# SeedSequence tags: one stream a purpose
_CELL, _STREAM, _WARM, _LENGTHS = 0, 1, 2, 3


def _rng(seed, *tags):
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


def text(rng, n: int) -> str:
    """``n`` ASCII characters: lowercase words."""
    return ALPHABET[rng.integers(0, len(ALPHABET), size=n)].tobytes() \
        .decode("ascii")


class Traffic:
    """Program instances of one mix for one seed: ``warm()`` for set-up,
    ``instance(i)`` for the i-th program of the measured stream.  Each is
    ``(kind, args)``, ``args`` the program's positional arguments after
    its id."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        cell = _rng(seed, _CELL)
        m = mix
        if m["program"] == "mapreduce":
            self.instruction = text(cell, m["instruction_tokens"])
            self.combine_instruction = text(cell,
                                            m["combine_instruction_tokens"])
        elif m["program"] == "agent":
            self.system = text(cell, m["system_tokens"])
        else:
            raise ValueError(f"program {m['program']!r}: mapreduce or agent")

    def _doc_lengths(self, block: int) -> list:
        m = self.mix
        lo, hi = m["doc_tokens"]
        n = m["clients"] * m["fan_out"]
        lengths = np.rint(np.linspace(lo, hi, n)).astype(int)
        return [int(x) for x in
                _rng(self.seed, _LENGTHS, block).permutation(lengths)]

    def _mapreduce(self, rng, lengths) -> tuple:
        m = self.mix
        docs = tuple(text(rng, n) for n in lengths)
        return ("mapreduce", (self.instruction, docs,
                              self.combine_instruction, m["summary_tokens"],
                              m["summary_bytes"], m["combine_tokens"]))

    def _agent(self, rng) -> tuple:
        m = self.mix
        task = text(rng, m["task_tokens"])
        observations = tuple(text(rng, m["observation_tokens"])
                             for _ in range(m["turns"] - 1))
        return ("agent", (self.system + task, observations, m["turns"],
                          m["action_tokens"], m["action_bytes"]))

    def instance(self, i: int) -> tuple:
        """The i-th program of the stream (i counts from 0)."""
        rng = _rng(self.seed, _STREAM, i)
        if self.mix["program"] == "agent":
            return self._agent(rng)
        per = self.mix["fan_out"]
        block, at = divmod(i, self.mix["clients"])
        lengths = self._doc_lengths(block)[at * per:(at + 1) * per]
        return self._mapreduce(rng, lengths)

    def warm(self) -> list:
        """Programs that set-up runs before the clients start: one whose
        documents span the mix's range of lengths (every prefill chunk
        shape the stream uses), or one agent session."""
        rng = _rng(self.seed, _WARM)
        if self.mix["program"] == "agent":
            return [self._agent(rng)]
        lo, hi = self.mix["doc_tokens"]
        lengths = [int(x) for x in np.rint(
            np.linspace(lo, hi, self.mix["fan_out"]))]
        return [self._mapreduce(rng, lengths)]

