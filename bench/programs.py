"""The program kinds a mix can name, written against the port's PopPy
(``repro_torch.core``) as a user writes them.

- ``mapreduce``: the paper's fan-out (program A, skeleton-of-thought):
  one ``summarize`` call a document, each summary ``report``-ed in
  order, then one ``combine`` call over the summaries.  The calls are
  independent, so the runtime dispatches them all at once.
- ``agent``: a ReAct-style tool agent: turn t prompts with the shared
  system prompt, the task, and the earlier turns' actions and tool
  observations; each action is ``report``-ed.  Every call depends on the
  one before: nothing to parallelise.

A model output enters a later prompt only through :func:`fit_text`, cut
or padded to a fixed number of UTF-8 bytes, so what a program asks of
the engine does not depend on what the model decoded.
"""

from __future__ import annotations


def fit_text(text: str, n: int) -> str:
    """``text`` cut or padded with '.' to exactly ``n`` UTF-8 bytes (a
    character the cut would split is dropped)."""
    head = text.encode("utf-8")[:n].decode("utf-8", errors="ignore")
    return head + "." * (n - len(head.encode("utf-8")))


def make_programs(effects: dict) -> dict:
    """{kind: @poppy program}; each program's ``report`` lines land in
    ``effects[pid]`` as (step, text), in program order."""
    from repro_torch.core import poppy, sequential, unordered
    from repro_torch.core.ai import llm

    fit = unordered(returns_immutable=True, offload="inline")(fit_text)

    @sequential(offload="inline")
    def report(pid, step, line):
        effects.setdefault(pid, []).append((step, line))

    @poppy
    def mapreduce(pid, instruction, docs, combine_instruction,
                  summary_tokens, summary_bytes, combine_tokens):
        summaries = ""
        for i in range(len(docs)):
            s = fit(llm(instruction + docs[i], max_tokens=summary_tokens),
                    summary_bytes)
            report(pid, i, s)
            summaries = summaries + s
        overall = llm(combine_instruction + summaries,
                      max_tokens=combine_tokens)
        report(pid, len(docs), overall)
        return overall

    @poppy
    def agent(pid, prefix, observations, turns, action_tokens,
              action_bytes):
        history = ""
        action = ""
        for t in range(turns):
            action = fit(llm(prefix + history, max_tokens=action_tokens),
                         action_bytes)
            report(pid, t, action)
            if t + 1 < turns:
                history = history + action + observations[t]
        return action

    return {"mapreduce": mapreduce, "agent": agent}
