"""Reordering-class registry and dynamic classification (paper §6.1).

Every external call belongs to one of three classes:

  * ``unordered``  — may execute in any order (stateless externals, pure
    operations on immutable data).
  * ``readonly``   — reorderable among themselves, but ordered with respect
    to sequential calls (reads of mutable state).
  * ``sequential`` — must execute in original program order (mutation, I/O).

For dynamically-dispatched call sites (operators, methods) the class is
decided at *runtime* by the concurrency controller once argument types are
known — this module provides those decision rules, including the annotation
tables for Python's operators, in-place operators, core-immutable-type
methods, mutating-method tables for list/dict/set/bytearray, and common
builtins.  Unannotated callables default to ``sequential`` (paper §6.1).
"""

from __future__ import annotations

import datetime
import enum
import functools
import inspect
import string
import types

import contextvars

from .values import STAR, Pending, deep_ready, is_pending, peek

UNORDERED = "unordered"
READONLY = "readonly"
SEQUENTIAL = "sequential"

_CLASSES = (UNORDERED, READONLY, SEQUENTIAL)

# Overhead measurement (paper Fig. 7): force every external call to the
# sequential class so the run has PopPy's full runtime with zero extracted
# parallelism.
_force_sequential: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "poppy_force_sequential", default=False)


class force_sequential_annotations:
    """Context manager classifying every external sequential (Fig. 7)."""

    def __enter__(self):
        self._tok = _force_sequential.set(True)
        return self

    def __exit__(self, *exc):
        _force_sequential.reset(self._tok)
        return False


def sequential_forced() -> bool:
    return _force_sequential.get()


#: Offload modes for *synchronous* externals (async externals are always
#: awaited on the loop).  ``"thread"`` dispatches on the runtime's
#: ThreadPoolExecutor so blocking calls overlap; ``"process"`` dispatches
#: on a ProcessPoolExecutor for CPU-bound externals the GIL would
#: serialize (arguments and result must be picklable, and the target must
#: be a module-level function); ``"inline"`` executes on the event-loop
#: thread (right for sub-microsecond operators and calls that must not
#: cross threads).  ``None`` defers to the runtime default.
OFFLOAD_THREAD = "thread"
OFFLOAD_PROCESS = "process"
OFFLOAD_INLINE = "inline"
_OFFLOADS = (OFFLOAD_THREAD, OFFLOAD_PROCESS, OFFLOAD_INLINE)


class BatchSpec:
    """Batching declaration for an ``@unordered`` external (DESIGN.md §2.3).

    * ``max_batch`` — flush a window once it holds this many calls.
    * ``max_wait_ms`` — backstop deadline for a partial window.  The engine
      normally flushes much earlier, as soon as the event loop quiesces (no
      more dispatch-ready work can join the window without new external
      results arriving), so this bound matters only while the interpreter
      is still actively producing calls.
    * ``key_fn`` — ``(pos, kw) -> hashable | None``: calls batch together
      only when their keys are equal (e.g. shared decode options and the
      same backend).  ``None`` from the callable opts this one call out of
      batching.  The default (no ``key_fn``) batches every call to the
      component.
    * ``handler`` — the batched implementation, attached with
      :func:`repro_torch.core.annotations.batch_handler`: an async callable
      ``handler(calls) -> list`` taking ``[(pos_tuple, kw_dict), ...]``
      and returning one result per call *in order*; an entry may be an
      ``Exception`` instance to fail just that element.  A component
      without a handler never batches.
    """

    __slots__ = ("max_batch", "max_wait_ms", "key_fn", "handler")

    def __init__(self, max_batch=32, max_wait_ms=25.0, key_fn=None,
                 handler=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_ms is not None and max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.max_batch = int(max_batch)
        self.max_wait_ms = max_wait_ms
        self.key_fn = key_fn
        self.handler = handler


def normalize_batchable(b):
    """Accept the ``batchable=`` annotation argument in any declared form."""
    if b is None or b is False:
        return None
    if isinstance(b, BatchSpec):
        return b
    if b is True:
        return BatchSpec()
    if isinstance(b, (tuple, list)):
        return BatchSpec(*b)
    if isinstance(b, dict):
        return BatchSpec(**b)
    raise TypeError(f"batchable must be a BatchSpec, tuple, dict, or True; "
                    f"got {b!r}")


def batch_spec(fn):
    """The :class:`BatchSpec` under which calls to ``fn`` may coalesce, or
    ``None`` when ``fn`` is not batchable (unannotated, no ``batchable=``
    declaration, or no batch handler attached)."""
    info = getattr(fn, "__poppy_external__", None)
    if info is None:
        return None
    spec = info.batchable
    if spec is None or spec.handler is None:
        return None
    return spec


def batch_element_key(spec: BatchSpec, pos, kw):
    """Evaluate one call's batch key.  Returns a hashable key (``()`` when
    no ``key_fn`` is declared — every call to the component batches
    together), or ``None`` to dispatch this call singly (the ``key_fn``
    opted out, raised, or produced an unhashable value)."""
    if spec.key_fn is None:
        return ()
    try:
        key = spec.key_fn(list(pos), dict(kw))
        hash(key)
    except Exception:
        return None
    return key


class ExternalInfo:
    """Attached to external callables as ``__poppy_external__``.

    ``effects`` declares the call's *effect domains* (DESIGN.md §2.2):

      * ``None`` — the default domain ``"*"`` (orders against everything;
        today's single-chain behavior).
      * a tuple of strings — static keys; entries containing ``{field}``
        placeholders are per-call templates formatted from the argument
        named/indexed by ``field`` (``{0}``, ``{session}``).
      * a callable ``(args, kwargs) -> keys | None`` — evaluated per call;
        arguments may still be ``Pending`` placeholders (check with
        ``repro_torch.core.values.is_pending``); return ``None`` when the keys
        cannot be determined yet, and the engine conservatively degrades
        the *locking* to ``"*"`` (the trace still records the declared
        keys once arguments resolve).

    Keys must be deterministic functions of the arguments for annotated
    (wrapped) externals — the per-domain ≡_A projections compare them
    across plain-Python and PopPy runs.

    ``imm_result`` declares that the call always returns a *core builtin
    immutable* (str/tuple/int/…).  The engine then marks the result's
    placeholder with an ``imm_hint``, which lets downstream operator
    intrinsics (f-strings over an LLM answer, tuple accumulators) classify
    at queue time instead of conservatively routing every effect domain
    through themselves.  True for the entire AI component library — LLM
    answers and embeddings are strings/tuples.

    ``batchable`` declares that concurrently pending *unordered* calls to
    this external may be coalesced into one batched backend request (a
    :class:`BatchSpec`; DESIGN.md §2.3).  Accepts a ``BatchSpec``, a
    ``(max_batch, max_wait_ms, key_fn)`` tuple (trailing entries
    optional), ``True`` for defaults, or a kwargs dict.

    ``deadline_ms`` caps the call's wall-clock execution (DESIGN.md §2.5):
    an attempt exceeding it is cooperatively cancelled and the call fails
    with :class:`repro_torch.core.errors.DeadlineExceeded`.  Enforced on the
    awaitable offload paths (async / ``"thread"`` / ``"process"``);
    ``"inline"`` externals run on the loop thread and cannot be
    interrupted mid-call.
    """

    __slots__ = ("cls", "classify", "name", "offload", "effects", "params",
                 "imm_result", "batchable", "predictor", "deadline_ms")

    def __init__(self, cls=None, classify=None, name="", offload=None,
                 effects=None, params=None, imm_result=False,
                 batchable=None, predictor=None, deadline_ms=None):
        assert (cls is None) != (classify is None)
        if cls is not None:
            assert cls in _CLASSES, cls
        if offload is not None:
            assert offload in _OFFLOADS, offload
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            if deadline_ms <= 0:
                raise ValueError(
                    f"deadline_ms must be positive, got {deadline_ms}")
        if effects is not None and not callable(effects):
            effects = tuple(effects)
            assert all(isinstance(k, str) for k in effects), effects
        if predictor is not None:
            # Predict-and-validate (DESIGN.md §2.4) is only sound for
            # calls that are free to reorder and whose results are
            # immutable: the guess may flow through downstream immutable
            # glue and be discarded wholesale on a miss, but a guessed
            # mutable object could be aliased and mutated before
            # validation, which no rollback can undo.
            assert callable(predictor), predictor
            assert cls == UNORDERED, (
                f"predictor= requires an @unordered external, got {cls!r}")
            assert imm_result, "predictor= requires returns_immutable=True"
        self.cls = cls
        self.classify = classify
        self.name = name
        self.offload = offload
        self.effects = effects
        self.params = tuple(params) if params is not None else None
        self.imm_result = bool(imm_result)
        self.batchable = normalize_batchable(batchable)
        self.predictor = predictor
        self.deadline_ms = deadline_ms


def annotated_offload(fn):
    """The annotation-level offload choice for ``fn``.

    ``"inline"`` for un-annotated callables (dynamically-classified
    operators, methods, builtins — interpreter-level work that would only
    get slower on a thread), the annotation's explicit choice if one was
    made, else ``None`` (meaning: use the runtime default, which is
    ``"thread"`` for annotated sync externals — the blocking-SDK case)."""
    info = getattr(fn, "__poppy_external__", None)
    if info is None:
        return OFFLOAD_INLINE
    return info.offload


# ---------------------------------------------------------------------------
# value immutability

_IMMUTABLE_ATOMS = {
    bool, int, float, complex, str, bytes, type(None), type, range, slice,
    type(Ellipsis), type(NotImplemented), datetime.date, datetime.time,
    datetime.datetime, datetime.timedelta, datetime.timezone,
    types.FunctionType, types.BuiltinFunctionType, types.MethodType,
    types.BuiltinMethodType, types.LambdaType, functools.partial,
    types.CodeType, types.ModuleType,
}

_EXTRA_IMMUTABLE: set[type] = set()


def register_immutable_type(t: type):
    """Library hook: declare a user type immutable for classification."""
    _EXTRA_IMMUTABLE.add(t)


def _is_frozen_pydantic(v) -> bool:
    cfg = getattr(type(v), "model_config", None)
    if isinstance(cfg, dict):
        return bool(cfg.get("frozen"))
    return False


def is_immutable(v) -> bool:
    """Shallow immutability of a value (paper's core-immutable-type rule:
    tuple/frozenset count as immutable regardless of element types)."""
    t = type(v)
    if t in _IMMUTABLE_ATOMS or t in _EXTRA_IMMUTABLE:
        return True
    if t is tuple or t is frozenset:
        return True
    if isinstance(v, enum.Enum):
        return True
    if callable(v) and getattr(v, "__poppy_external__", None) is not None:
        return True
    if getattr(v, "__poppy_internal__", False):
        return True
    if _is_frozen_pydantic(v):
        return True
    return False


def is_deeply_immutable(v) -> bool:
    """Strict (recursive) immutability — used for the freshness upgrade of
    internally-constructed containers, where we must guarantee no mutable
    state is reachable."""
    t = type(v)
    if t is tuple or t is frozenset:
        return all(is_deeply_immutable(e) for e in v)
    return is_immutable(v)


def arg_immutable(v, fresh: bool) -> bool:
    """Immutability of a call argument for classification.

    ``fresh`` marks containers constructed internally by the compiled code
    whose register has exactly one consumer — unaliased, so no other code
    can observe them, and (when their contents are immutable) reordering a
    read of them is unobservable.  This is required for the paper's Fig. 2
    behavior (``value_cache |= {state}`` classifying unordered even though
    ``{state}`` is a set literal); see DESIGN.md §3.
    """
    if is_immutable(v):
        return True
    if fresh and type(v) in (list, set, dict):
        if type(v) is dict:
            return all(is_deeply_immutable(k) and is_deeply_immutable(e)
                       for k, e in v.items())
        return all(is_deeply_immutable(e) for e in v)
    return False


def _all_imm(args, fresh_mask):
    return all(arg_immutable(a, fresh_mask[i] if i < len(fresh_mask) else False)
               for i, a in enumerate(args))


# ---------------------------------------------------------------------------
# operator / intrinsic classifiers (used by stdlib.py)

def classify_binary(args, kwargs, fresh_mask):
    """All 28 unary/binary operators: both immutable → unordered; any
    mutable → readonly (prior mutations must be allowed to finish)."""
    return UNORDERED if _all_imm(args, fresh_mask) else READONLY


def classify_inplace(args, kwargs, fresh_mask):
    """All 13 in-place operators: lhs mutable → sequential (it mutates);
    rhs mutable → readonly; both immutable → unordered."""
    lhs, rhs = args[0], args[1]
    if not arg_immutable(lhs, fresh_mask[0] if fresh_mask else False):
        # in-place op on a *fresh* mutable container is still a mutation of
        # an unaliased object → arg_immutable already upgraded it if safe
        return SEQUENTIAL
    if not arg_immutable(rhs, fresh_mask[1] if len(fresh_mask) > 1 else False):
        return READONLY
    return UNORDERED


def classify_write(args, kwargs, fresh_mask):
    """Mutating writes (``py_setattr``/``py_setitem``): mirrors
    ``classify_inplace``.  The target (``args[0]``) is mutated →
    sequential; but a *fresh* target (single-consumer literal whose
    contents are immutable — ``arg_immutable``'s upgrade) is unaliased
    and unobservable, so the write orders only by its value arguments:
    any mutable value → readonly, all immutable → unordered."""
    target = args[0]
    if not arg_immutable(target, fresh_mask[0] if fresh_mask else False):
        return SEQUENTIAL
    rest = args[1:]
    rest_mask = fresh_mask[1:] if fresh_mask else ()
    return UNORDERED if _all_imm(rest, rest_mask) else READONLY


def classify_read(args, kwargs, fresh_mask):
    """Pure reads: unordered on immutable data, readonly on mutable."""
    return UNORDERED if _all_imm(args, fresh_mask) else READONLY


def classify_unordered(args, kwargs, fresh_mask):
    return UNORDERED


def classify_sequential(args, kwargs, fresh_mask):
    return SEQUENTIAL


# ---------------------------------------------------------------------------
# method tables

_MUTATING_METHODS: dict[type, frozenset] = {
    list: frozenset({
        "append", "extend", "insert", "remove", "pop", "clear", "sort",
        "reverse", "__setitem__", "__delitem__", "__iadd__", "__imul__",
    }),
    dict: frozenset({
        "__setitem__", "__delitem__", "clear", "pop", "popitem",
        "setdefault", "update", "__ior__",
    }),
    set: frozenset({
        "add", "discard", "remove", "pop", "clear", "update",
        "intersection_update", "difference_update",
        "symmetric_difference_update", "__iand__", "__ior__", "__ixor__",
        "__isub__",
    }),
    bytearray: frozenset({
        "append", "extend", "insert", "remove", "pop", "clear", "reverse",
        "__setitem__", "__delitem__", "__iadd__", "__imul__",
    }),
}

# builtins that only *read* their arguments
_READING_BUILTINS = {
    len, repr, str, format, hash, sorted, min, max, sum, any, all, abs,
    round, isinstance, issubclass, callable, id, iter, divmod, ord, chr,
    hex, oct, bin, list, tuple, set, dict, frozenset, int, float, bool,
    complex, bytes, range, enumerate, zip, map, filter, reversed, type,
    vars, dir, hasattr,
}

_SEQUENTIAL_BUILTINS = {print, input, open, next, setattr, delattr, exec,
                        eval, compile, __import__}


def exhausts_iterator(v) -> bool:
    """Iterating this value consumes it (mutation)."""
    return isinstance(v, (enumerate, zip, map, filter, reversed)) or (
        hasattr(v, "__next__"))


def classify_iter_spine(args, kwargs, fresh_mask):
    """Snapshotting an iterable for a ``for`` loop: immutable iterables are
    unordered; mutable containers are readonly reads; exhaustible iterators
    are consumed — a mutation — but one of an iterator object that, in the
    supported fragment, was created at this call site; snapshotting it at
    the readonly point keeps the underlying container read correctly
    ordered with respect to sequential mutations."""
    (v,) = args
    if exhausts_iterator(v):
        return READONLY
    return classify_read(args, kwargs, fresh_mask)


# ---------------------------------------------------------------------------
# static-unordered fast path (engine queue-time classification)
#
# Loop glue — operators on immutable accumulators (``acc += (x,)``) — is
# dynamically classified, which normally means the controller must await
# argument *spines* before it can forward any locks.  Under keyed sequence
# variables that laziness is costly: an unclassified call must
# conservatively route every domain through itself.  But when every
# argument is either a core builtin immutable or a ``Pending`` carrying an
# ``imm_hint``, the class is *statically* unordered: the engine skips the
# keyed fork entirely and threads the ordering state through unchanged.

#: Core builtin immutables: types whose operator results are themselves
#: builtin immutables and which are never exhaustible iterators.  (Shallow
#: rule: tuple/frozenset qualify regardless of element types, exactly like
#: ``is_immutable``.)  Deliberately excludes module/function/method atoms —
#: reading through those can reach arbitrary objects.
_HINT_IMM_TYPES = frozenset({
    bool, int, float, complex, str, bytes, type(None), tuple, frozenset,
    range, slice, type(Ellipsis), type(NotImplemented), datetime.date,
    datetime.time, datetime.datetime, datetime.timedelta, datetime.timezone,
})


def static_unordered(fn, pos, kw, fresh_mask):
    """Queue-time classification for dynamic intrinsics.

    Returns ``None`` unless the call is *provably* unordered from argument
    types/hints alone; otherwise returns the result ``imm_hint``
    (``info.imm_result`` — True for operator intrinsics and f-strings,
    whose results over builtin immutables are builtin immutables; False
    for reads like ``py_getitem``, whose result may be a mutable element).
    Sound by construction: the controller's dynamic classification of the
    same call necessarily agrees (every hinted argument resolves to a
    builtin immutable)."""
    if kw or _force_sequential.get():
        return None
    info = getattr(fn, "__poppy_external__", None)
    if info is None or info.classify not in _STATIC_UNORDERED_CLASSIFIERS:
        return None
    for a in pos:
        a = peek(a)
        if type(a) is Pending:
            if not a.imm_hint:
                return None
        elif type(a) not in _HINT_IMM_TYPES:
            return None
    return info.imm_result


_STATIC_UNORDERED_CLASSIFIERS = frozenset({
    classify_binary, classify_inplace, classify_read, classify_iter_spine,
    classify_unordered,
})


# ---------------------------------------------------------------------------
# effect domains (DESIGN.md §2.2)
#
# Every queued external call carries a tuple of *effect-domain keys* that
# select which per-domain lock chains it orders against.  ``("*",)`` — the
# default — joins every live domain (the paper's single-chain behavior).

_formatter = string.Formatter()


def object_domain(obj) -> str:
    """Anonymous per-object effect domain, keyed by identity.  Used for
    interpreter intrinsics and container methods: mutations/reads of one
    concrete object order among themselves but not against unrelated
    domains.  ``obj:`` keys are run-local (ids differ across runs) — only
    sound for *unwrapped* events, which the ≡_A checker never compares."""
    return f"obj:{id(obj):x}"


def _effects_obj(args, kwargs):
    """Effects callable for intrinsics whose first argument is the object
    read or written (``py_getitem``, ``py_setitem``, ``py_truth``,
    ``iter_spine``).

    Identity-keying is restricted to the four known mutable container
    types, whose spine operations provably touch only the receiver.  Any
    other mutable target keeps the global ``"*"`` domain — a custom
    ``__getitem__``/``__bool__``/``__iter__`` can run arbitrary code, so it
    must stay ordered against everything (the paper's table discipline).
    """
    target = peek(args[0]) if args else None
    if is_pending(target):
        return None
    if type(target) in _MUTATING_METHODS:  # list, dict, set, bytearray
        return (object_domain(target),)
    return (STAR,)


def _effects_obj_attr(args, kwargs):
    """Effects callable for ``py_getattr``/``py_setattr``: the target's
    identity domain, but only for plain instances — default
    ``__getattribute__``/``__setattr__`` and no descriptor under the
    attribute name — so the access provably touches only the instance
    ``__dict__``.  Properties, slots, and custom attribute hooks can run
    arbitrary code and stay on ``"*"``."""
    o = peek(args[0]) if args else None
    name = peek(args[1]) if len(args) > 1 else None
    if is_pending(o) or is_pending(name):
        return None
    t = type(o)
    if (getattr(t, "__getattribute__", None) is not object.__getattribute__
            or getattr(t, "__setattr__", None) is not object.__setattr__
            or getattr(t, "__getattr__", None) is not None):
        return (STAR,)
    cattr = getattr(t, name, None) if isinstance(name, str) else None
    if cattr is not None and (hasattr(type(cattr), "__get__")
                              or hasattr(type(cattr), "__set__")):
        return (STAR,)  # descriptor (property/slot/method) — arbitrary code
    return (object_domain(o),)


def _template_value(field, pos, kw, params):
    """Resolve one ``{field}`` of an effects template against a call's
    arguments.  Returns (found, value)."""
    if field in kw:
        return True, kw[field]
    if field.isdigit():
        i = int(field)
        return (True, pos[i]) if i < len(pos) else (False, None)
    if params and field in params:
        i = params.index(field)
        if i < len(pos):
            return True, pos[i]
    return False, None


def _format_effect_key(template, pos, kw, params):
    """Format one effects template; ``None`` if a referenced argument is
    missing or not yet resolved."""
    out = []
    for literal, field, spec, conv in _formatter.parse(template):
        out.append(literal)
        if field is None:
            continue
        found, v = _template_value(field, pos, kw, params)
        if not found:
            return None
        v = peek(v)
        if not deep_ready(v):
            return None
        if conv == "r":
            v = repr(v)
        elif conv == "s":
            v = str(v)
        out.append(format(v, spec or ""))
    return "".join(out)


def effect_keys(info: ExternalInfo, pos, kw):
    """Evaluate an annotation's declared effect keys for one call.

    Returns a tuple of keys, or ``None`` when they cannot be determined yet
    (an argument a template/callable needs is still ``Pending``).  A
    callable that raises degrades to ``("*",)`` — deterministically, so
    plain-Python and PopPy runs record the same keys."""
    eff = info.effects
    if eff is None:
        return (STAR,)
    if callable(eff):
        try:
            keys = eff(list(pos), dict(kw))
        except Exception:
            return (STAR,)
        if keys is None:
            return None
        keys = tuple(str(k) for k in keys)
        return keys if keys else (STAR,)
    out = []
    for t in eff:
        if "{" not in t:
            out.append(t)
            continue
        k = _format_effect_key(t, pos, kw, info.params)
        if k is None:
            return None
        out.append(k)
    # an empty declaration normalizes to the global domain, like the
    # callable branch — zero keys would mean zero locks (no ordering)
    return tuple(out) or (STAR,)


# Receiver-only container methods: provably touch nothing beyond the
# receiver (no element __eq__/__hash__ content reads of *other* mutable
# objects, no callable arguments, no iteration of a foreign iterable), so
# they may be keyed to the receiver's identity domain.  ``sort(key=...)``,
# ``extend(iterable)``, ``count(x)`` etc. stay on ``"*"``.
_RECEIVER_ONLY_METHODS: dict[type, frozenset] = {
    list: frozenset({"append", "insert", "pop", "clear", "reverse", "copy",
                     "__setitem__", "__delitem__", "__len__"}),
    dict: frozenset({"__setitem__", "__delitem__", "clear", "pop", "popitem",
                     "setdefault", "get", "keys", "values", "items", "copy",
                     "__len__"}),
    set: frozenset({"add", "discard", "remove", "pop", "clear", "copy",
                    "__len__"}),
    bytearray: frozenset({"append", "pop", "clear", "reverse", "copy",
                          "__setitem__", "__delitem__", "__len__"}),
}


def dynamic_effect_keys(fn):
    """Effect keys for an *unannotated* callable: receiver-only bound
    methods of the four known mutable container types are keyed to their
    receiver's identity domain (``lst.append(x)`` orders with other
    operations on ``lst``, not with the world); everything else — unknown
    functions, builtins, constructors, content-reading methods — defaults
    to ``"*"`` (may touch anything)."""
    if isinstance(fn, functools.partial):
        return dynamic_effect_keys(fn.func)
    self_obj = getattr(fn, "__self__", None)
    if self_obj is not None:
        safe = _RECEIVER_ONLY_METHODS.get(type(self_obj))
        if safe is not None and getattr(fn, "__name__", "") in safe:
            return (object_domain(self_obj),)
    return (STAR,)


def resolve_effect_keys(fn, pos, kw):
    """Effect-domain keys for a call to ``fn``, or ``None`` if not yet
    determinable (the engine then degrades locking to ``"*"``, which only
    over-orders — always sound)."""
    if _force_sequential.get():
        return (STAR,)  # Fig. 7 overhead mode: one chain, zero parallelism
    info = getattr(fn, "__poppy_external__", None)
    if info is None:
        return dynamic_effect_keys(fn)
    return effect_keys(info, pos, kw)


def get_callable_class(fn, args, kwargs, fresh_mask):
    """Dynamic concurrency classification for an arbitrary callable
    (paper §6.2: the controller 'knows what function is actually being
    called, and thus knows the desired concurrency behavior')."""
    if _force_sequential.get():
        return SEQUENTIAL
    info = getattr(fn, "__poppy_external__", None)
    if info is not None:
        if info.cls is not None:
            return info.cls
        return info.classify(args, kwargs, fresh_mask)

    if isinstance(fn, functools.partial):
        return get_callable_class(fn.func, tuple(fn.args) + tuple(args),
                                  kwargs, fresh_mask)

    # bound methods: classify by receiver
    self_obj = getattr(fn, "__self__", None)
    if self_obj is not None and not isinstance(self_obj, types.ModuleType):
        name = getattr(fn, "__name__", "")
        t = type(self_obj)
        muts = _MUTATING_METHODS.get(t)
        if muts is not None:
            if name in muts:
                return SEQUENTIAL
            # non-mutating method of a known mutable container → read
            return READONLY
        if is_immutable(self_obj):
            # paper: 336 methods of core immutable datatypes — unordered if
            # all arguments immutable, else readonly
            return UNORDERED if _all_imm(args, fresh_mask) else READONLY
        return SEQUENTIAL  # unknown mutable receiver → paper default

    if fn in _SEQUENTIAL_BUILTINS:
        return SEQUENTIAL
    if fn in _READING_BUILTINS:
        return UNORDERED if _all_imm(args, fresh_mask) else READONLY
    if isinstance(fn, type):
        if fn in (list, tuple, set, dict, frozenset, str, int, float, bool,
                  complex, bytes, bytearray, range):
            return UNORDERED if _all_imm(args, fresh_mask) else READONLY
        return SEQUENTIAL  # unknown constructors may run arbitrary __init__

    # unannotated function: paper §6.1 — default to sequential for soundness
    return SEQUENTIAL


def callable_name(fn) -> str:
    for attr in ("__qualname__", "__name__"):
        n = getattr(fn, attr, None)
        if n:
            return n
    return repr(fn)


def is_async_callable(fn) -> bool:
    if isinstance(fn, functools.partial):
        return is_async_callable(fn.func)
    return inspect.iscoroutinefunction(fn) or inspect.iscoroutinefunction(
        getattr(fn, "__call__", None))
