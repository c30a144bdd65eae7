"""Speculative execution for the opportunistic engine (DESIGN.md §2.4).

Two speculation mechanisms share one rollback discipline:

* **Control speculation** (branch speculation): when an ``if`` condition
  is still a :class:`~repro_torch.core.values.Pending`, the engine expands
  *both* arms concurrently, each inside a :class:`SpecScope`.  Unordered
  (effect-free-to-reorder) externals in an arm dispatch immediately;
  every readonly/sequential call *parks* on the scope's admission gate.
  When the condition resolves, the winning scope commits (its trace
  segment merges into the parent, parked calls are admitted) and the
  losing scope aborts (tasks cancelled, trace segment discarded, lock
  out-states resolved by the controllers' ``finally`` blocks — so
  domain chains stay balanced and no dispatch admission leaks).

* **Value speculation** (predict-and-validate): an ``@unordered``
  external with a ``predictor=`` hook publishes its *predicted* result
  immediately in a :class:`SpecEpoch`; dependents launch on the guess
  (carrying taint, see :mod:`repro_torch.core.values`), the real call runs
  concurrently, and validation either detaches the epoch (hit) or swaps
  in fresh futures and lets every tainted producer re-execute with the
  actual value (miss).  Trace events of stale attempts are discarded, so
  the committed trace is ≡_A-equivalent to the non-speculative engine's.

Both are **opt-in**: wrap a run in :class:`speculation` to enable them.
Outside that context the engine takes its original non-speculative
paths and none of the machinery below is consulted.
"""

from __future__ import annotations

import asyncio
import contextvars

__all__ = [
    "SpeculationPolicy",
    "SpecStats",
    "SpecEpoch",
    "SpecScope",
    "speculation",
    "current_speculation",
    "current_scope",
]


class SpeculationPolicy:
    """Which speculation mechanisms are armed inside a :class:`speculation`
    context.  ``branches`` gates both-arm branch speculation, ``predict``
    gates predictor-driven value speculation."""

    __slots__ = ("branches", "predict")

    def __init__(self, branches: bool = True, predict: bool = True):
        self.branches = branches
        self.predict = predict


class SpecStats:
    """Speculation counters for one :class:`speculation` context.

    Loop-confined plain ints (the engine mutates them only from its event
    loop).  ``loser_effects`` must stay 0 — it counts effectful calls
    that ran inside an already-aborted scope, i.e. rollback violations —
    and is counter-asserted by the differential tests and fig16.
    """

    def __init__(self):
        self.branches_speculated = 0
        self.arms_committed = 0
        self.arms_aborted = 0
        self.arm_tasks_cancelled = 0
        self.gated_holds = 0       # effectful calls parked on a scope gate
        self.loser_effects = 0     # effectful calls run in an aborted scope
        self.predictions = 0
        self.pred_hits = 0
        self.pred_misses = 0
        self.spec_publishes = 0    # results published while tainted
        self.redo_runs = 0         # re-dispatches after a mispredict
        self.dropped_events = 0    # trace events discarded by rollback

    def snapshot(self) -> dict:
        return dict(vars(self))

    def __repr__(self):
        on = {k: v for k, v in vars(self).items() if v}
        return f"<SpecStats {on or 'idle'}>"


class _SpecContext:
    __slots__ = ("policy", "stats")

    def __init__(self, policy: SpeculationPolicy, stats: SpecStats):
        self.policy = policy
        self.stats = stats


_spec_var: contextvars.ContextVar[_SpecContext | None] = (
    contextvars.ContextVar("poppy_speculation", default=None))

_scope_var: contextvars.ContextVar["SpecScope | None"] = (
    contextvars.ContextVar("poppy_spec_scope", default=None))


def current_speculation() -> _SpecContext | None:
    """The ambient speculation context, or ``None`` (speculation off)."""
    return _spec_var.get()


def current_scope() -> "SpecScope | None":
    """The branch-speculation scope the current task runs under, if any."""
    return _scope_var.get()


class speculation:
    """Enable speculative execution for runs started in this context::

        with speculation() as sp:
            out = branchy_app(q)
        sp.stats.branches_speculated  # observability

    ``branches=False`` / ``predict=False`` disarm the individual
    mechanisms.  Nesting simply rebinds the ambient context (innermost
    wins); the context is carried into engine tasks via contextvars, so
    it also works around ``run_poppy`` driving a fresh event loop.
    """

    def __init__(self, *, branches: bool = True, predict: bool = True):
        self.policy = SpeculationPolicy(branches=branches, predict=predict)
        self.stats = SpecStats()
        self._ctx = _SpecContext(self.policy, self.stats)
        self._tok = None
        self._shield_tok = None

    def __enter__(self) -> "speculation":
        from .values import set_shielding
        self._tok = _spec_var.set(self._ctx)
        # engine futures (locks, state chains, value placeholders) are
        # shared with winning paths — shield awaits so cancelling a
        # speculative loser can't cancel a future out from under a winner
        self._shield_tok = set_shielding(True)
        return self

    def __exit__(self, *exc):
        from .values import reset_shielding
        _spec_var.reset(self._tok)
        reset_shielding(self._shield_tok)
        return False


class SpecEpoch:
    """One predict-and-validate episode (DESIGN.md §2.4).

    ``source`` is the predicted call's result placeholder; ``derived``
    collects every downstream placeholder whose published value depended
    on the guess.  :meth:`resolve` is called exactly once by the source
    call's controller with the actual result:

    * **hit** — the guess was right: detach (``spec`` cleared), resolve
      ``validated`` with ``True``; downstream results stand as-is.
    * **miss** — swap ``source.fut`` for a future already holding the
      actual value and give every derived placeholder a *fresh, empty*
      future, then resolve ``validated`` with ``False``.  Tainted
      producers (parked on ``validated`` in their redo loops) re-execute
      and resolve the fresh futures; late readers that grab ``fut``
      after the swap only ever see settled state.
    """

    __slots__ = ("source", "predicted", "validated", "derived")

    def __init__(self, rt, source, predicted):
        self.source = source
        self.predicted = predicted
        self.validated: asyncio.Future = rt.new_future()
        self.derived: list = []

    def register(self, pending):
        if pending is not self.source and pending not in self.derived:
            self.derived.append(pending)

    def _detach(self, pending):
        s = pending.spec
        if s:
            rest = tuple(e for e in s if e is not self)
            pending.spec = rest if rest else None

    def resolve(self, rt, actual) -> bool:
        try:
            hit = bool(actual == self.predicted)
        except Exception:
            hit = False
        if hit:
            self._detach(self.source)
            for p in self.derived:
                self._detach(p)
        else:
            f = rt.new_future()
            f.set_result(actual)
            self.source.fut = f
            self._detach(self.source)
            for p in self.derived:
                p.fut = rt.new_future()
                self._detach(p)
        self.validated.set_result(hit)
        return hit


class SpecScope:
    """A speculatively-executing branch arm (control speculation).

    Tracks the engine tasks spawned while expanding the arm, the trace
    segment its events record into, and nested child scopes.  Exactly one
    of :meth:`commit` / :meth:`abort` is called when the branch condition
    settles.  Task exceptions inside an unsettled scope are routed here
    (``error``) instead of failing the run — a losing arm is allowed to
    crash; a winning arm's error surfaces at commit.
    """

    def __init__(self, rt, parent: "SpecScope | None" = None, seg: int = 0):
        self.rt = rt
        self.parent = parent
        self.seg = seg
        self.tasks: set = set()
        self.children: list[SpecScope] = []
        self.decision: asyncio.Future = rt.new_future()
        self.error: BaseException | None = None
        self.committed = False
        self.aborted = False
        if parent is not None:
            parent.children.append(self)

    @property
    def settled(self) -> bool:
        return self.committed or self.aborted

    def adopt(self, task):
        self.tasks.add(task)

    async def admitted(self):
        """Park until this scope settles; raise ``CancelledError`` if it
        aborted.  Effectful (non-unordered) calls inside a speculative arm
        hold here so no effect can commit before the branch decision."""
        from .values import await_future
        ok = await await_future(self.decision)
        if not ok:
            raise asyncio.CancelledError

    def commit(self):
        if self.settled:
            return
        self.committed = True
        rt = self.rt
        stats = rt.spec.stats if rt.spec is not None else None
        if stats is not None:
            stats.arms_committed += 1
        if rt.trace is not None and self.seg:
            parent_seg = self.parent.seg if self.parent is not None else 0
            rt.trace.commit_segment(self.seg, parent_seg)
        live_parent = self.parent if (
            self.parent is not None and not self.parent.settled) else None
        for t in list(self.tasks):
            if live_parent is not None:
                live_parent.adopt(t)
                rt.scope_of[t] = live_parent
            else:
                rt.scope_of.pop(t, None)
        self.tasks.clear()
        for c in self.children:
            if not c.settled:
                c.parent = live_parent
                if live_parent is not None:
                    live_parent.children.append(c)
        if not self.decision.done():
            self.decision.set_result(True)
        if self.error is not None:
            rt.fail(self.error)

    def abort(self):
        if self.settled:
            return
        self.aborted = True
        rt = self.rt
        stats = rt.spec.stats if rt.spec is not None else None
        if stats is not None:
            stats.arms_aborted += 1
        for c in list(self.children):
            c.abort()
        if not self.decision.done():
            self.decision.set_result(False)
        for t in list(self.tasks):
            if not t.done():
                t.cancel()
                if stats is not None:
                    stats.arm_tasks_cancelled += 1
        if rt.trace is not None and self.seg:
            dropped = rt.trace.drop_segment(self.seg)
            if stats is not None:
                stats.dropped_events += dropped


class scope_context:
    """Bind ``scope`` (and its trace segment) as the ambient speculation
    scope for code run inside the ``with`` block — arm expansion uses
    this so every task/controller spawned for the arm inherits it."""

    def __init__(self, scope: SpecScope):
        self.scope = scope
        self._tok = None
        self._seg_tok = None

    def __enter__(self):
        from . import trace as _trace
        self._tok = _scope_var.set(self.scope)
        self._seg_tok = _trace.set_segment(self.scope.seg)
        return self.scope

    def __exit__(self, *exc):
        from . import trace as _trace
        _scope_var.reset(self._tok)
        _trace.reset_segment(self._seg_tok)
        return False
