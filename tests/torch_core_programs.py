"""PopPy programs for the port's parity tests: one for each part of the
runtime the apps of ``benchmarks/apps`` leave out (effect domains, queue-time
batching, branch speculation, ``first_success``, thread and process offload,
unpacking, failures, the fallback of a program outside the fragment).  Written against ``repro.core`` as the reference's
tests write them; ``helpers_torch.load_under`` loads this file under either
package, so each program runs on one package's symbols throughout.

``RUNS`` maps a name to a function that runs its program (under its own
context: ``batching()``, ``speculation()``, an offload policy) and returns
the result; ``OUT`` holds the ordered output of every ``emit``.  ``race``
runs on its own: its ``first_success`` arguments are closures, whose reprs
differ between standard Python and PopPy.
"""

import time
import warnings

from repro.core import (
    ExternalCallError,
    batching,
    first_success,
    offload_policy,
    poppy,
    readonly,
    sequential,
    speculation,
    unordered,
)
from repro.core.ai import MemoryStore, http, http_post, llm, llm_sync

OUT = []
CELL = {"v": 0}
memory = MemoryStore("agents")


def reset():
    OUT.clear()
    CELL["v"] = 0
    memory.clear()


@sequential
def emit(line):
    OUT.append(line)
    return None


@sequential(effects=("cell",))
def bump(k):
    CELL["v"] += k
    return CELL["v"]


@readonly(effects=("cell",))
def peek_cell():
    return CELL["v"]


@unordered
def blocking_upper(text):
    time.sleep(0.01)
    return str(text).upper()


@unordered(offload="process", returns_immutable=True)
def digest(text):
    """Pure Python, CPU-bound: run in a worker process."""
    h = 0
    for ch in text:
        h = (h * 131 + ord(ch)) % 1_000_000_007
    return h


@sequential
def fails(x):
    raise ValueError(f"bad input {x}")


@unordered
async def add3(a, b=0, c=0):
    return a + b + c


# -- a fan-out and its combine (``examples/serve_llm.py``'s program)


@poppy
def summarize(n):
    summaries = tuple()
    for i in range(n):
        s = llm(f"summarize document {i}", max_tokens=8)
        emit(f"doc {i}: {s}")
        summaries += (s,)
    overall = llm(f"combine: {summaries}"[:64], max_tokens=6)
    emit(f"combined: {overall}")
    return overall


# -- effect domains: per-session memory, a readonly window, per-host HTTP


@poppy
def effects(n):
    for i in range(n):
        note = llm(f"note {i}", max_tokens=4)
        memory.append(f"s{i % 2}", note)
        bump(i)
    seen = peek_cell()
    got = http("https://a.example/items", seen)
    posted = http_post("https://b.example/log", got)
    emit(f"{memory.size('s0')} {memory.size('s1')} {seen}")
    return (memory.read("s0"), memory.read("s1"), posted)


# -- queue-time batching: a fan-out of batchable calls


@poppy
def fan_out(n):
    outs = tuple()
    for i in range(n):
        outs += (llm(f"item {i}", max_tokens=3),)
    emit(f"{outs}")
    return outs


# -- branch speculation: the branch depends on an LLM's answer


@poppy
def branchy(q):
    verdict = llm(f"yes or no: {q}", max_tokens=2)
    if len(verdict) % 2 == 0:
        answer = llm(f"even branch for {q}", max_tokens=4)
    else:
        answer = llm(f"odd branch for {q}", max_tokens=4)
    emit(answer)
    return answer


# -- first_success: redundant rollouts race


@poppy
def race(q):
    best = first_success(
        lambda: llm(f"try-a {q}", max_tokens=48),
        lambda: llm(f"try-b {q}", max_tokens=4),
    )
    emit(best)
    return best


# -- offload: blocking externals on threads, one in a worker process


@poppy
def offloaded(words):
    ups = tuple()
    for w in words:
        ups += (blocking_upper(w),)
    summary = llm_sync(f"summarize {ups}", max_tokens=6)
    emit(summary)
    return (ups, digest(summary))


# -- unpacking into externals and internal functions


@poppy
def inner(a, b, c=10):
    return add3(a, b, c=c)


@poppy
def unpack(xs, kw):
    first = add3(*xs)
    second = add3(xs[0], **kw)
    third = inner(*xs[:2], **kw)
    emit(f"{first} {second} {third}")
    return (first, second, third)


# -- failures: an external that raises surfaces as ExternalCallError


@poppy
def failing(x):
    a = llm(f"before {x}", max_tokens=3)
    emit(a)
    b = fails(a)
    emit(b)
    return b


def run_failing():
    """The raised error's cause: standard Python raises the external's own
    error, PopPy an ``ExternalCallError`` from it."""
    try:
        failing("z")
    except (ExternalCallError, ValueError) as e:
        cause = e.__cause__ if isinstance(e, ExternalCallError) else e
        return f"{type(cause).__name__}: {cause}"
    return "no error"


# -- outside the fragment (``break``): PoppyCompileError, and the
# program falls back to sequential execution


@poppy
def with_break(n):
    notes = tuple()
    for i in range(n):
        if i == 3:
            break
        notes += (llm(f"note {i}", max_tokens=3),)
    emit(f"{notes}")
    return notes


def run_fallback():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return (with_break(5), with_break.compiles)


def run_batched():
    with batching():
        return fan_out(6)


def run_speculated():
    with speculation():
        return branchy("is water wet?")


def run_offloaded():
    with offload_policy(mode="thread", process_workers=1):
        return offloaded(("alpha", "beta", "gamma"))


RUNS = {
    "summarize": lambda: summarize(4),
    "effects": lambda: effects(4),
    "fan_out": lambda: fan_out(6),
    "batched": run_batched,
    "speculated": run_speculated,
    "offloaded": run_offloaded,
    "unpack": lambda: unpack((1, 2, 3), {"c": 5}),
    "failing": run_failing,
    "fallback": run_fallback,
}
