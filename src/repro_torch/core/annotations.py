"""PopPy user-facing annotations (paper §4).

* ``@poppy`` — marks *internal* code (the expressive Python fragment).
  Calling a decorated function runs it under the opportunistic engine; its
  external calls execute early/in parallel as the annotations allow.
* ``@unordered`` / ``@readonly`` / ``@sequential`` — mark *external* code
  with its reordering class.  Unannotated externals default to sequential.
* ``sequential_mode()`` — context manager forcing standard Python execution
  (used as the differential-testing baseline and by ``fig7`` overhead runs).

If a function does not fit the supported fragment, ``@poppy`` falls back to
treating it as a sequential external (paper §4.1) and records why.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
import warnings

from . import registry
from .engine import current_runtime, run_poppy, run_poppy_async
from .errors import PoppyCompileError
from .frontend import compile_function
from .lower import lower_function
from .trace import current_trace, safe_repr

_plain_mode: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "poppy_plain_mode", default=False)


class sequential_mode:
    """Force standard sequential Python execution of @poppy functions."""

    def __enter__(self):
        self._tok = _plain_mode.set(True)
        return self

    def __exit__(self, *exc):
        _plain_mode.reset(self._tok)
        return False


def in_sequential_mode() -> bool:
    return _plain_mode.get()


class PoppyFn:
    """A compiled internal function."""

    __poppy_internal__ = True

    def __init__(self, fn, *, strict=False):
        functools.update_wrapper(self, fn)
        self.original = fn
        self.strict = strict
        self._lfunc = None
        self._bezoar = None
        self._compile_error = None
        self._compiled = False

    # -- compilation (lazy, cached) ------------------------------------------

    def _compile(self):
        if self._compiled:
            return
        self._compiled = True
        try:
            self._bezoar = compile_function(self.original)
            self._lfunc = lower_function(self._bezoar, self.original)
        except PoppyCompileError as e:
            if self.strict:
                raise
            self._compile_error = e
            warnings.warn(
                f"@poppy: {self.original.__qualname__} is outside the "
                f"supported fragment ({e}); falling back to sequential "
                "external execution", stacklevel=2)

    @property
    def lfunc(self):
        self._compile()
        if self._lfunc is None:
            raise self._compile_error
        return self._lfunc

    @property
    def bezoar(self):
        self._compile()
        if self._bezoar is None:
            raise self._compile_error
        return self._bezoar

    @property
    def compiles(self) -> bool:
        self._compile()
        return self._lfunc is not None

    # -- calling ------------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        if in_sequential_mode():
            return self.original(*args, **kwargs)
        if current_runtime() is not None:
            # invoked *from external code* during an opportunistic run
            # (e.g. as a callback): execute sequentially — its own external
            # calls still trace through their wrappers.
            return self.original(*args, **kwargs)
        self._compile()
        if self._lfunc is None:
            return self.original(*args, **kwargs)  # fragment fallback
        return run_poppy(self, args, kwargs)

    async def async_call(self, *args, **kwargs):
        if in_sequential_mode():
            return self.original(*args, **kwargs)
        self._compile()
        if self._lfunc is None:
            return self.original(*args, **kwargs)
        return await run_poppy_async(self, args, kwargs)

    def __repr__(self):
        return f"<@poppy {self.original.__qualname__}>"


def poppy(fn=None, *, strict=False):
    """Mark a function as internal PopPy code."""
    if fn is None:
        return lambda f: PoppyFn(f, strict=strict)
    return PoppyFn(fn, strict=strict)


# ---------------------------------------------------------------------------
# external annotations


def _external(info_factory):
    def deco(fn):
        info = info_factory(fn)

        def record(args, kwargs):
            tr = current_trace()
            if tr is not None and current_runtime() is None:
                cls = info.cls if info.cls is not None else \
                    info.classify(args, kwargs, ())
                effs = registry.effect_keys(info, args, kwargs) \
                    or (registry.STAR,)
                tr.record_direct(info.name, cls,
                                 args_repr=safe_repr((args, kwargs)),
                                 effects=effs)

        # The engine never calls this wrapper — it dispatches
        # __poppy_dispatch__ directly.  The wrapper serves standard
        # sequential Python, resolving its target *per call* so the dispatch
        # target is swappable (ai.use_sync_clients swaps an async component
        # for its blocking twin under both plain and PopPy execution).
        # Async targets called with no loop running are driven to completion
        # — blocking-call semantics, the paper's baseline; called from async
        # external code (a loop is running) they return the coroutine to be
        # awaited.
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            record(args, kwargs)
            target = wrapper.__poppy_dispatch__
            if registry.is_async_callable(target):
                try:
                    asyncio.get_running_loop()
                except RuntimeError:
                    return asyncio.run(target(*args, **kwargs))
            return target(*args, **kwargs)

        wrapper.__poppy_external__ = info
        wrapper.__poppy_dispatch__ = fn
        return wrapper
    return deco


def _sig_params(fn):
    """Parameter names, for binding named effects-template fields
    (``{session}``) to positional arguments.  Best effort."""
    try:
        return tuple(inspect.signature(fn).parameters)
    except (ValueError, TypeError):
        return None


def _static_info(cls_name, offload=None, effects=None, imm_result=False,
                 batchable=None, predictor=None, deadline_ms=None):
    return lambda fn: registry.ExternalInfo(
        cls=cls_name, name=registry.callable_name(fn), offload=offload,
        effects=effects, params=_sig_params(fn), imm_result=imm_result,
        batchable=batchable, predictor=predictor, deadline_ms=deadline_ms)


def _static_annotation(cls_name, fn, offload, effects=None,
                       returns_immutable=False, batchable=None,
                       predictor=None, deadline_ms=None):
    deco = _external(_static_info(cls_name, offload=offload, effects=effects,
                                  imm_result=returns_immutable,
                                  batchable=batchable, predictor=predictor,
                                  deadline_ms=deadline_ms))
    return deco if fn is None else deco(fn)


def batch_handler(wrapper):
    """Attach the batched implementation to a ``batchable=`` external::

        @unordered(batchable=(64, 25.0))
        async def embed(text): ...

        @batch_handler(embed)
        async def _embed_batch(calls):
            # calls: [(pos_tuple, kw_dict), ...] — fully resolved arguments
            return await backend.embed_batch([p[0] for p, _ in calls])

    The handler must be async and return one result per call *in order*;
    an entry may be an ``Exception`` instance to fail only that element's
    placeholder.  A ``batchable=`` component without a handler never
    batches (its calls dispatch singly).
    """
    info = getattr(wrapper, "__poppy_external__", None)
    if info is None or info.batchable is None:
        raise TypeError("batch_handler requires an external annotated "
                        "with batchable=")

    def deco(fn):
        if not registry.is_async_callable(fn):
            raise TypeError("batch handler must be an async callable")
        info.batchable.handler = fn
        return fn

    return deco


def unordered(fn=None, *, offload=None, effects=None,
              returns_immutable=False, batchable=None, predictor=None,
              deadline_ms=None):
    """External call that may execute in any order (stateless externals,
    pure operations on immutable data).

    ``offload`` picks where a *synchronous* external executes under the
    engine: ``"thread"`` (the default for sync externals) dispatches it on
    the runtime's thread-pool executor so blocking calls overlap;
    ``"inline"`` keeps it on the event-loop thread (for cheap calls, or
    thread-affine clients).

    ``effects`` declares the call's effect domains (DESIGN.md §2.2) — a
    tuple of keys (entries may be per-call templates like
    ``"memory:{session}"``) or a callable ``(args, kwargs) -> keys | None``.
    Ordered calls (``@readonly``/``@sequential``) keyed to disjoint domains
    run in parallel; the default ``None`` is the global domain ``"*"``.

    ``returns_immutable`` declares the result a core builtin immutable
    (str/tuple/int/…): downstream operators over the still-pending result
    (f-strings, accumulators) then classify at queue time, keeping
    unrelated effect domains decoupled.

    ``batchable`` declares that concurrently pending calls may coalesce
    into one batched backend request — a ``(max_batch, max_wait_ms,
    key_fn)`` tuple / ``BatchSpec`` / ``True`` (DESIGN.md §2.3); attach
    the batched implementation with :func:`batch_handler` and enable the
    windows per scope with ``repro_torch.core.batching``.

    ``predictor`` arms predict-and-validate speculation (DESIGN.md §2.4)
    inside a ``with speculation():`` context: ``predictor(pos, kw) ->
    value | None`` is called synchronously at queue time with the
    arguments *as known so far* (entries may be ``Pending`` placeholders
    — return ``None`` to decline).  A non-``None`` guess resolves the
    call's placeholder immediately so dependents launch speculatively;
    the real call validates it, and a miss rolls the dependents back and
    re-executes them with the actual value.  The predictor must be cheap,
    deterministic-safe to discard, and — enforced — the external must be
    ``@unordered`` with ``returns_immutable=True``.

    ``deadline_ms`` caps each call's wall-clock execution (DESIGN.md §2.5):
    an attempt exceeding it is cooperatively cancelled and the call fails
    with :class:`~repro_torch.core.errors.DeadlineExceeded`.  Enforced on the
    awaitable offload paths (async / ``"thread"`` / ``"process"``) —
    ``"inline"`` externals run on the loop thread and cannot be
    interrupted."""
    return _static_annotation(registry.UNORDERED, fn, offload, effects,
                              returns_immutable, batchable, predictor,
                              deadline_ms)


def readonly(fn=None, *, offload=None, effects=None,
             returns_immutable=False, deadline_ms=None):
    """External call reorderable among other readonly calls but ordered with
    respect to sequential calls (reads of mutable state).  With ``effects``,
    the ordering applies per effect domain (see ``unordered``)."""
    return _static_annotation(registry.READONLY, fn, offload, effects,
                              returns_immutable, deadline_ms=deadline_ms)


def sequential(fn=None, *, offload=None, effects=None,
               returns_immutable=False, deadline_ms=None):
    """External call that must execute in original program order (mutation,
    I/O).  This is also the default for unannotated externals.  With
    ``effects``, program order is preserved *per effect domain* — two
    sequential calls on disjoint domains may overlap (see ``unordered``)."""
    return _static_annotation(registry.SEQUENTIAL, fn, offload, effects,
                              returns_immutable, deadline_ms=deadline_ms)


def external(fn=None, *, classify, offload=None, effects=None,
             returns_immutable=False, batchable=None, deadline_ms=None):
    """External call with a *dynamic* classifier: ``classify(args, kwargs,
    fresh_mask) -> 'unordered'|'readonly'|'sequential'``.  With
    ``batchable=``, calls that classify *unordered* may coalesce (see
    ``unordered``); ordered classifications always dispatch singly."""
    def info_factory(f):
        return registry.ExternalInfo(classify=classify,
                                     name=registry.callable_name(f),
                                     offload=offload, effects=effects,
                                     params=_sig_params(f),
                                     imm_result=returns_immutable,
                                     batchable=batchable,
                                     deadline_ms=deadline_ms)
    if fn is None:
        return _external(info_factory)
    return _external(info_factory)(fn)
