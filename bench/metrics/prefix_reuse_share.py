"""Prompt tokens the prefix cache served ÷ all prompt tokens admitted in
the host window (the engine's ``prefill_tokens_reused`` and
``prefill_tokens_computed`` counters)."""


def read(obs):
    reused = obs.engine.get("prefill_tokens_reused", 0)
    total = reused + obs.engine.get("prefill_tokens_computed", 0)
    if total <= 0:
        return None
    return reused / total
