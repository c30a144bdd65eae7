"""Backend hooks (the port's copy of part of ``repro/core/ai.py``).

:class:`Backend` is the interface every LLM/embedding backend implements;
``set/get/use_backend`` bind the ambient backend and
``set/get/use_dispatcher`` the ambient ``repro_torch.dispatch.Dispatcher``
in this package's own contextvars.  The annotated components (``llm``,
``embed``, …) and the reference's ``SimulatedBackend`` are not copied:
with no backend bound, :func:`get_backend` raises instead of falling back
to a simulated model.

The port's ``Dispatcher`` binds itself here while it calls a backend, so
:func:`ambient_dispatch_stats` inside a backend resolves to the dispatcher
that routed the call even when the caller bound it through the
reference's ``use_dispatcher``.
"""

from __future__ import annotations

import asyncio
import contextvars


class Backend:
    """Interface for LLM/embedding backends.

    The batch methods accept list payloads and return one result per
    element *in order*; an entry may be an ``Exception`` instance, failing
    only that element.  The defaults fan a batch out to the single-call
    methods concurrently — a backend with true server-side batching (one
    admission per batch) overrides them.
    """

    async def generate(self, prompt: str, *, max_tokens: int,
                       temperature: float, stop) -> str:
        raise NotImplementedError

    async def embed(self, text: str) -> tuple:
        raise NotImplementedError

    async def generate_batch(self, prompts, *, max_tokens: int,
                             temperature: float, stop) -> list:
        return list(await asyncio.gather(
            *(self.generate(p, max_tokens=max_tokens,
                            temperature=temperature, stop=stop)
              for p in prompts),
            return_exceptions=True))

    async def embed_batch(self, texts) -> list:
        return list(await asyncio.gather(
            *(self.embed(t) for t in texts), return_exceptions=True))


_backend: contextvars.ContextVar[Backend | None] = contextvars.ContextVar(
    "repro_torch_ai_backend", default=None)


def set_backend(b: Backend):
    _backend.set(b)


def get_backend() -> Backend:
    b = _backend.get()
    if b is None:
        raise RuntimeError(
            "no backend bound: bind one with use_backend() or set_backend() "
            "(the port has no simulated fallback model)")
    return b


class use_backend:
    """Context manager binding the ambient LLM/embed backend."""

    def __init__(self, b: Backend):
        self.b = b

    def __enter__(self):
        self._tok = _backend.set(self.b)
        return self.b

    def __exit__(self, *exc):
        _backend.reset(self._tok)
        return False


# ---------------------------------------------------------------------------
# dispatch layer (repro_torch.dispatch)
#
# The default is the *trivial* dispatcher: a single logical replica
# resolving the ambient `use_backend` backend per call, with every
# production feature off — byte-identical to calling the backend directly.

_dispatcher: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_ai_dispatcher", default=None)
_default_dispatcher = None


def set_dispatcher(d):
    _dispatcher.set(d)


def get_dispatcher():
    d = _dispatcher.get()
    if d is not None:
        return d
    # module-level (not contextvar) default: get_dispatcher() may first run
    # inside a task whose context copy would discard the set()
    global _default_dispatcher
    if _default_dispatcher is None:
        from repro_torch.dispatch import Dispatcher
        _default_dispatcher = Dispatcher()
    return _default_dispatcher


def ambient_dispatch_stats():
    """The ``DispatchStats`` of the dispatcher ambient at the call site.
    Backends use this to flow backend-side observations (e.g. the serving
    engine's shared-prefix admission counters) into the same stats
    surface the dispatcher reports — the backend is *called by* the
    dispatcher, which binds itself in this contextvar around the call, so
    it resolves to the dispatcher that routed the call."""
    return get_dispatcher().stats


class use_dispatcher:
    """Route component calls in this context through ``d`` (a
    ``repro_torch.dispatch.Dispatcher``)."""

    def __init__(self, d):
        self.d = d

    def __enter__(self):
        self._tok = _dispatcher.set(self.d)
        return self.d

    def __exit__(self, *exc):
        _dispatcher.reset(self._tok)
        return False
