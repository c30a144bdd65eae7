"""Runtime value representation for the opportunistic (λ^O) engine.

A register slot holds either a plain Python value (READY) or a ``Pending``
wrapping an ``asyncio.Future``.  Internally-constructed containers (tuple /
list / slice built by compiled code) may embed ``Pending`` placeholders; the
spine is known even when elements are not — this is what lets a ``fold``
iterate over a tuple of outstanding LLM results (paper §2.3, Fig. 2).

External calls are dispatched only with *deep-resolved* arguments.
"""

from __future__ import annotations

import asyncio
import contextvars

from .errors import PoppyUnboundLocalError


class _UnboundType:
    """Sentinel for promoted locals read before assignment (Python's
    UnboundLocalError semantics, preserved through SSA promotion)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<unbound>"


UNBOUND = _UnboundType()


class Pending:
    """Placeholder for a not-yet-resolved register value.

    ``imm_hint=True`` guarantees the eventual value is a *core builtin
    immutable* (int/str/tuple/…): set by the engine's static-unordered
    fast path for operator intrinsics over immutable inputs, and consumed
    by the same path so chains of loop glue (``acc += (x,)``) classify at
    queue time without awaiting upstream results.

    ``spec`` is the *speculation epoch set* (DESIGN.md §2.4): ``None``
    for ordinary placeholders; a tuple of unvalidated
    :class:`repro_torch.core.speculate.SpecEpoch` objects while ``fut`` holds a
    *predicted* (or predicted-derived) value.  Awaiting ``fut`` on a
    speculative Pending yields the guess — consumers that must never act
    on a guess use :func:`settled` instead, and :func:`shallow` records
    the epochs it flowed through into the ambient taint set so producers
    can mark their own results speculative in turn.  On validation the
    epoch either clears ``spec`` (hit) or swaps ``fut`` for a fresh
    future that the re-executed producer resolves (miss) — stale guesses
    are unreachable after the swap.
    """

    __slots__ = ("fut", "imm_hint", "spec")

    def __init__(self, fut: asyncio.Future, imm_hint: bool = False):
        self.fut = fut
        self.imm_hint = imm_hint
        self.spec = None

    def __repr__(self):
        tag = " imm" if self.imm_hint else ""
        tag += " spec" if self.spec else ""
        return f"<pending{tag} {id(self):#x}>"


def is_pending(v) -> bool:
    return type(v) is Pending


def shallow_ready(v) -> bool:
    return type(v) is not Pending


#: Ambient speculation-taint set: the epochs whose *predicted* values the
#: current task has observed through :func:`shallow` / :func:`deep_resolve`.
#: Task-local (contextvars copy at task creation), holding a frozenset so
#: scope save/restore is O(1).  Controllers bracket each dispatch attempt
#: with :func:`taint_scope` / :func:`current_taint` to learn whether the
#: result they are about to publish depends on an unvalidated guess.
_taint: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "poppy_spec_taint", default=frozenset())


def taint_scope():
    """Open a fresh (empty) taint scope; returns a reset token."""
    return _taint.set(frozenset())


def reset_taint(token):
    _taint.reset(token)


def current_taint() -> frozenset:
    return _taint.get()


def note_taint(epochs):
    cur = _taint.get()
    new = cur.union(epochs)
    if new is not cur and new != cur:
        _taint.set(new)


#: True inside a ``with speculation():`` context (set by
#: :class:`repro_torch.core.speculate.speculation`).  Engine futures — value
#: placeholders, lock chains, keyed-state futures — are *multi-consumer*:
#: the winning arm awaits the very same futures a cancelled loser task may
#: be parked on, and ``Task.cancel()`` propagates into the future the task
#: is currently awaiting (``_fut_waiter.cancel()``), which would corrupt
#: shared state.  Under speculation every engine-future await therefore
#: goes through :func:`await_future`, which shields the future: the task
#: still dies promptly, the future survives.  Off speculation the await is
#: direct — zero-overhead, behavior unchanged.
_shielding: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "poppy_spec_shielding", default=False)


def set_shielding(on: bool):
    return _shielding.set(on)


def reset_shielding(token):
    _shielding.reset(token)


async def await_future(fut):
    """Await an engine future; cancellation-safe under speculation."""
    if fut.done():
        return fut.result()
    if _shielding.get():
        return await asyncio.shield(fut)
    return await fut


async def shallow(v):
    """Await the top-level value (its spine); embedded Pendings may remain.

    Flowing through a *speculative* Pending yields the predicted value and
    records its epochs in the ambient taint set (see :data:`_taint`).
    """
    while type(v) is Pending:
        s = v.spec
        if s is not None:
            note_taint(s)
        v = await await_future(v.fut)
    return v


async def settled(v):
    """Like :func:`shallow`, but never yields a speculative value: awaits
    each epoch's validation and re-reads the placeholder (a miss swaps
    ``fut``; a hit clears ``spec``).  Used wherever a guess must not leak:
    control decisions (branch/loop conditions), effectful-call arguments,
    mutable-container substitution, and the program's return value."""
    while type(v) is Pending:
        s = v.spec
        if s is not None:
            for e in s:
                if not e.validated.done():
                    await await_future(e.validated)
            if v.spec is s and v.spec is not None:
                # validated but not yet detached (hit commits clear spec
                # synchronously, so this is only a transient miss window)
                v.spec = None
            continue  # re-read fut: a miss swapped it
        v = await await_future(v.fut)
    return v


def peek(v):
    """Unwrap already-resolved Pendings *synchronously*.

    Returns the underlying value when every layer of Pending has already
    completed successfully; otherwise returns the outermost unresolved (or
    failed/cancelled) Pending unchanged.  Lets synchronous engine code (the
    inline fast path, effect-key resolution) see through a placeholder that
    has in fact resolved, without awaiting.

    Speculatively-resolved Pendings are treated as *unresolved*: the guess
    stays invisible to every synchronous path (static classification,
    effect-key templates — which then degrade soundly to the ``"*"``
    domain — and predictor inputs), so only the awaited paths, which carry
    taint, can observe it.
    """
    while type(v) is Pending:
        if v.spec is not None:
            break
        f = v.fut
        if not f.done() or f.cancelled() or f.exception() is not None:
            break
        v = f.result()
    return v


def deep_ready(v) -> bool:
    """True iff ``v`` contains no Pending anywhere (spine and elements)."""
    t = type(v)
    if t is Pending:
        return False
    if t is tuple or t is list:
        return all(deep_ready(e) for e in v)
    if t is dict:
        return all(deep_ready(e) for e in v.values())
    if t is slice:
        return deep_ready(v.start) and deep_ready(v.stop) and deep_ready(v.step)
    if getattr(v, "__poppy_internal__", False) and hasattr(v, "captured_vals"):
        return all(deep_ready(e) for e in v.captured_vals)
    return True


def check_bound(v):
    if v is UNBOUND:
        raise PoppyUnboundLocalError("local variable referenced before assignment")
    return v


async def deep_resolve(v, *, settle=False):
    """Resolve every embedded Pending.

    Immutable containers (tuple/slice) are rebuilt; mutable containers
    (list/dict) are substituted *in place* — this preserves aliasing
    semantics (sequential Python would have stored the concrete value in
    that same object).

    With ``settle=True`` every placeholder is resolved via :func:`settled`
    (no speculative value escapes).  Even with ``settle=False``, values
    substituted into **mutable** containers are always settled first: an
    in-place write cannot be rolled back on a mispredict, so a guess may
    flow through rebuilt immutables (re-resolvable from the original
    structure on redo) but never into a list/dict/closure cell.
    """
    v = await (settled(v) if settle else shallow(v))
    t = type(v)
    if t is tuple:
        if deep_ready(v):
            return v
        return tuple([await deep_resolve(e, settle=settle) for e in v])
    if t is list:
        for i, e in enumerate(v):
            if not deep_ready(e):
                v[i] = await deep_resolve(e, settle=True)
        return v
    if t is dict:
        for k, e in list(v.items()):
            if not deep_ready(e):
                v[k] = await deep_resolve(e, settle=True)
        return v
    if t is slice:
        if deep_ready(v):
            return v
        return slice(
            await deep_resolve(v.start, settle=settle),
            await deep_resolve(v.stop, settle=settle),
            await deep_resolve(v.step, settle=settle),
        )
    if getattr(v, "__poppy_internal__", False) and hasattr(v, "captured_vals"):
        if not deep_ready(v):
            v.captured_vals = tuple(
                [await deep_resolve(e, settle=True)
                 for e in v.captured_vals])
        return v
    return v


class SeqState:
    """Runtime representation of a sequence variable ``S`` (paper §6.2).

    Carries the two lock futures between adjacent call sites:
      * ``f_r`` — resolved once all preceding @sequential calls resolved
        (a "read lock").
      * ``f_w`` — resolved once all preceding @sequential *and* @readonly
        calls resolved (a "write lock").

    ``None`` means already-resolved (saves allocating Futures on the fast
    path at program start and after quiescence).
    """

    __slots__ = ("f_r", "f_w")

    def __init__(self, f_r=None, f_w=None):
        self.f_r = f_r
        self.f_w = f_w

    @property
    def resolved(self) -> bool:
        return (self.f_r is None or self.f_r.done()) and (
            self.f_w is None or self.f_w.done()
        )

    async def wait_r(self):
        if self.f_r is not None and not self.f_r.done():
            await await_future(self.f_r)

    async def wait_w(self):
        if self.f_w is not None and not self.f_w.done():
            await await_future(self.f_w)

    def __repr__(self):
        def s(f):
            return "✓" if f is None or f.done() else "…"
        return f"<S r={s(self.f_r)} w={s(self.f_w)}>"


S_READY = SeqState()


#: The default effect domain.  A call keyed ``"*"`` orders against *every*
#: live domain (it joins them all and its out-state becomes the new root),
#: which is exactly the paper's single-sequence-variable behavior — so
#: unannotated code is untouched by the keyed generalization.
STAR = "*"


class KeyedSeqState:
    """Ordering state keyed by *effect domain* (DESIGN.md §2.2).

    The paper threads one sequence variable through every call site, which
    serializes ``@sequential`` externals that touch disjoint resources (two
    agents' separate memories, a DB write vs. a log append).  The keyed
    generalization carries a **map of per-domain lock chains**:

      * ``domains[key]`` is the :class:`SeqState` at the head of domain
        ``key``'s chain — the out-state of the most recent call that
        affected ``key``.
      * A missing key falls back to the ``"*"`` (root) entry: after a
        ``"*"``-keyed call, every domain's chain passes through it.
      * The empty map means fully quiescent (every domain ``S_READY``).

    Instances are **immutable** (persistent): a call produces a *new*
    ``KeyedSeqState`` via :meth:`fork`, so branch bodies and loop carries
    can share a state value safely.  ``join`` collects the in-states a call
    must order against; ``fork`` installs its out-state.
    """

    __slots__ = ("domains",)

    def __init__(self, domains=None):
        self.domains = domains if domains is not None else {}

    def state_for(self, key) -> SeqState:
        d = self.domains
        s = d.get(key)
        if s is None:
            s = d.get(STAR)
        return s if s is not None else S_READY

    def join(self, keys) -> list:
        """The (deduplicated) lock chains a call keyed ``keys`` orders
        against.  ``"*"`` joins *all* live domains."""
        if STAR in keys:
            seen = {id(s): s for s in self.domains.values()}
        else:
            seen = {}
            for k in keys:
                s = self.state_for(k)
                seen[id(s)] = s
        return list(seen.values())

    def fork(self, keys, new_state):
        """Fork the keyed state for a queued call keyed ``keys``.

        Returns ``(new KeyedSeqState, links)`` where ``links`` pairs each
        affected domain's in-state with a **fresh per-domain out-state**
        (created by ``new_state()``) installed in the new map.  Per-domain
        out-states are what keep independent domains independent: the
        controller chains/fulfills each link according to the call's
        class, so e.g. an *unordered* ``"*"``-keyed call (loop glue whose
        class is only known dynamically) forwards every domain's chain
        without coupling them.

        A ``"*"`` call touches the root and every live domain; fully
        resolved side entries are pruned when the root is also resolved
        (they would fall back to a chain that carries no pending
        ordering), bounding map growth from anonymous ``obj:`` domains.
        """
        links = []
        old = self.domains
        root = old.get(STAR)
        root_resolved = root is None or root.resolved
        if STAR in keys:
            d = {}
            new_root = new_state()
            links.append((root if root is not None else S_READY, new_root))
            d[STAR] = new_root
            for k, s in old.items():
                if k == STAR:
                    continue
                if root_resolved and s.resolved:
                    continue  # prune: new_root carries this call's ordering
                o = new_state()
                links.append((s, o))
                d[k] = o
            return KeyedSeqState(d), links
        d = dict(old)
        if root_resolved:
            for k in [k for k, s in d.items()
                      if k != STAR and s.resolved and k not in keys]:
                del d[k]
        for k in keys:
            o = new_state()
            links.append((self.state_for(k), o))
            d[k] = o
        return KeyedSeqState(d), links

    @property
    def resolved(self) -> bool:
        return all(s.resolved for s in self.domains.values())

    def __repr__(self):
        inner = ", ".join(f"{k}={s!r}" for k, s in sorted(self.domains.items()))
        return f"<KS {inner or '∅'}>"


KS_READY = KeyedSeqState()
