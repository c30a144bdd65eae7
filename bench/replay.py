"""The runtime check: each program the window ran, run again as plain
sequential Python (``sequential_mode``: the program's own function body,
every call made in program order) over the call outputs the window
produced.  Its result and its ordered ``report`` effects must equal what
PopPy gave.  Each call's output text must also be the reading of the
tokens the engine served for it (``tokenizer.IdTokenizer``: three
characters an id, so every served id shows; the prompt's tokens a BOS,
256, and its UTF-8 bytes)."""

from __future__ import annotations

from collections import defaultdict, deque

from .tokenizer import encode, read_ids


class ReplayBackend:
    """Answers each ``llm`` call with the output the window gave the call
    of the same prompt and ``max_tokens`` (in the order they came)."""

    def __init__(self, outputs):
        self.outputs = defaultdict(deque)
        for key, out in outputs:
            self.outputs[key].append(out)
        self.missing = 0

    async def generate(self, prompt, *, max_tokens, temperature=0.0,
                       stop=None, **_):
        queue = self.outputs.get((prompt, max_tokens))
        if not queue:
            self.missing += 1
            return ""
        return queue.popleft()


def text_mismatches(outputs, requests) -> int:
    """Outputs ((prompt, max_tokens), text) that are not the reading of
    the tokens served for their prompt (``requests``: (prompt tokens,
    served tokens))."""
    served = defaultdict(list)
    for prompt, out in requests:
        served[tuple(prompt)].append(read_ids(out))
    return sum(text not in served.get(tuple(encode(prompt)), ())
               for (prompt, _), text in outputs)


def mismatches(records, outputs, requests=()) -> int:
    """Programs of ``records`` (each with ``kind``, ``pid``, ``args``,
    ``result`` and ``lines``) whose sequential replay over ``outputs``
    ((prompt, max_tokens), text) gives another result or other effects,
    plus calls the window never answered, plus outputs that are not the
    reading of the engine's tokens (``text_mismatches``)."""
    from repro_torch.core import sequential_mode
    from repro_torch.core.ai import use_dispatcher

    from .programs import make_programs

    effects = {}
    programs = make_programs(effects)
    backend = ReplayBackend(outputs)
    bad = 0
    with use_dispatcher(backend), sequential_mode():
        for rec in records:
            result = programs[rec.kind](rec.pid, *rec.args)
            if result != rec.result or effects.get(rec.pid, []) != rec.lines:
                bad += 1
    return bad + backend.missing + text_mismatches(outputs, requests)
