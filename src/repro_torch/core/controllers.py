"""Dynamic concurrency control (paper §6.2, generalized to effect domains
— DESIGN.md §2.2).

Every queued external call is owned by a *concurrency controller* — a
lightweight asyncio task that (1) learns which function is actually being
called (solving dynamic dispatch), (2) classifies it (``unordered`` /
``readonly`` / ``sequential``) via the annotation registry, and (3) follows
the lock protocol over the sequence-variable futures of every effect
domain the call is keyed to:

  F_R  — all preceding @sequential calls resolved         ("read lock")
  F_W  — all preceding @sequential and @readonly resolved ("write lock")

  sequential: await F_R ∧ F_W → dispatch → resolve → fulfill F_R', F_W'
  readonly:   await F_R → fulfill F_R' (forward) → dispatch → resolve →
              await F_W → fulfill F_W'
  unordered:  forward both immediately; dispatch as soon as args resolve.

A call keyed to several domains awaits the *union* of their in-locks and
fulfills one shared out-state that the engine installed for each key; a
``"*"``-keyed call (the default) joins every live domain — exactly the
paper's single-chain protocol.  Finer-grained reorderability =
finer-grained locks.
"""

from __future__ import annotations

import asyncio

from . import registry
from .errors import DeadlineExceeded, ExternalCallError, PoppyRuntimeError
from .speculate import SpecEpoch, current_scope
from .trace import current_segment, safe_repr
from .values import (await_future, check_bound, current_taint, deep_resolve,
                     peek, reset_taint, settled, taint_scope)
from ..obs.spans import (PHASE_MIN_S, current_span, current_tracer,
                         maybe_span)

UNORDERED = registry.UNORDERED
READONLY = registry.READONLY
SEQUENTIAL = registry.SEQUENTIAL


def _resolve_lock(f):
    if f is not None and not f.done():
        f.set_result(None)


def _chain_all(srcs, dst):
    """dst resolves when every src future has (srcs may be resolved/None)."""
    if dst is None:
        return
    pending = [f for f in srcs if f is not None and not f.done()]
    if not pending:
        _resolve_lock(dst)
        return
    remaining = {"n": len(pending)}

    def one_done(_):
        remaining["n"] -= 1
        if remaining["n"] == 0:
            _resolve_lock(dst)

    for f in pending:
        f.add_done_callback(one_done)


async def _await_locks(futs):
    for f in futs:
        if f is not None and not f.done():
            # await_future: lock futures are shared across controllers — a
            # cancelled speculative loser parked here must not cancel the
            # chain out from under the winners
            await await_future(f)


async def _await_locks_traced(futs, locks):
    """``_await_locks`` plus a retroactive ``lock.wait`` span when the
    wait actually took time (``locks`` names which lock futures: "r",
    "w", or "rw")."""
    trz = current_tracer()
    if trz is None:
        await _await_locks(futs)
        return
    t0 = trz.now()
    await _await_locks(futs)
    if trz.now() - t0 >= PHASE_MIN_S:
        trz.record("lock.wait", t0, cat="external.lock", locks=locks)


def unwrap_external(fn):
    """The engine dispatches the *inner* function of an annotation wrapper so
    plain-mode trace recording in the wrapper doesn't double-fire."""
    inner = getattr(fn, "__poppy_dispatch__", None)
    return inner if inner is not None else fn


def _span_note(**attrs):
    """Annotate the enclosing ``external`` span (no-op when tracing is
    off or the innermost span is not the controller's external span)."""
    sp = current_span()
    if sp is not None and sp.cat == "external":
        sp.attrs.update(attrs)


async def invoke_external(rt, fn, pos, kw, ev, *, allow_batch=False,
                          settle=False):
    """Dispatch an external call with fully resolved arguments.

    ``allow_batch=True`` (set by the *unordered* dispatch paths only) lets
    a call to a ``batchable=`` component park in the runtime's batch
    window instead of firing immediately — concurrently pending calls then
    coalesce into one batched backend request (DESIGN.md §2.3).  Ordered
    classes never batch: reordering *within* the batch flush would be
    unobservable, but the window delays dispatch, and only unordered calls
    are free to wait on unrelated work.

    ``settle=True`` (set for *ordered* dispatches under speculation)
    resolves arguments via :func:`repro_torch.core.values.settled` — the call
    waits for every upstream prediction to validate instead of dispatching
    on a guess, because an effectful call cannot be rolled back.
    """
    trz = current_tracer()
    t_args = trz.now() if trz is not None else 0.0
    pos = [check_bound(await deep_resolve(a, settle=settle)) for a in pos]
    kw = {k: check_bound(await deep_resolve(v, settle=settle))
          for k, v in kw.items()}
    if trz is not None and trz.now() - t_args >= PHASE_MIN_S:
        # dependency wait worth attributing (sub-threshold resolves are
        # elided — most args are already concrete)
        trz.record("await.args", t_args, cat="external.args")
    if rt.error is not None:
        # a sibling already failed: the run is aborting — parking here (via
        # cancellation) instead of dispatching preserves sequential
        # semantics (plain Python would have terminated before this call)
        raise asyncio.CancelledError
    if rt.spec is not None:
        sc = current_scope()
        if sc is not None and sc.aborted:
            # this task belongs to a losing arm and is about to be
            # cancelled — don't race the cancellation with a dispatch
            raise asyncio.CancelledError
    # write-ahead journal (DESIGN.md §2.5): claim this call's occurrence
    # *before* the batch window — a replayed call must not occupy batch
    # capacity or touch the backend at all.  Only wrapped externals in the
    # committed segment participate: a speculative arm's resolutions are
    # never journaled (they may lose), and interpreter intrinsics are
    # cheap to re-execute.
    jr = rt.journal
    token = None
    if jr is not None and hasattr(fn, "__poppy_dispatch__") \
            and current_segment() == 0:
        hit, token, val = jr.claim(registry.callable_name(fn), pos, kw)
        if hit:
            # replay: the trace records the same dispatch/resolve events a
            # live run would, so resumed traces stay ≡_A-comparable
            if rt.trace is not None:
                rt.trace.dispatched(ev,
                                    args_repr=safe_repr((tuple(pos), kw)))
                rt.trace.resolved(ev)
                _record_declared_effects(rt, fn, ev, pos, kw)
            return val
    if allow_batch and rt.batching:
        spec = registry.batch_spec(fn)
        if spec is not None:
            key = registry.batch_element_key(spec, pos, kw)
            if key is not None:
                # the collector records dispatch/resolve trace events at
                # flush/scatter time (when the batch actually goes out)
                with maybe_span("batch.window", cat="external.batch"):
                    result = await rt.batches.submit(fn, spec, key, pos, kw,
                                                     ev)
                if token is not None:
                    jr.append(token, result, effects=_ev_effects(ev),
                              seq=ev.seq_no if ev is not None else -1)
                return result
    if rt.trace is not None:
        rt.trace.dispatched(ev, args_repr=safe_repr((tuple(pos), kw)))
        if ev is not None:
            _span_note(seq=ev.seq_no)
    target = unwrap_external(fn)
    info = getattr(fn, "__poppy_external__", None)
    deadline = info.deadline_ms if info is not None else None
    try:
        with maybe_span("call", cat="external.call"):
            if registry.is_async_callable(target):
                coro = target(*pos, **kw)
                result = await (asyncio.wait_for(coro, deadline / 1e3)
                                if deadline is not None else coro)
            else:
                mode = rt.offload_mode_for(fn)
                if mode == "thread":
                    # blocking externals dispatch on the offload executor
                    # so independent calls overlap (sync SDK clients)
                    fut = rt.run_sync(target, pos, kw)
                elif mode == "process":
                    # CPU-bound externals dispatch on the process pool so
                    # the GIL doesn't serialize them
                    fut = rt.run_process(fn, pos, kw)
                else:
                    # inline on the loop — the paper's single-interpreter
                    # dispatch (§6.1), right for cheap calls and
                    # thread-affine clients.  No deadline: the loop thread
                    # cannot be interrupted mid-call.
                    fut = None
                    result = target(*pos, **kw)
                if fut is not None:
                    result = await (asyncio.wait_for(fut, deadline / 1e3)
                                    if deadline is not None else fut)
    except asyncio.CancelledError:
        raise
    except asyncio.TimeoutError as e:
        if deadline is not None:
            # the deadline fired: wait_for already cancelled the attempt
            # cooperatively; lock chains release via the controller's
            # ``finally`` blocks like any other failure
            raise DeadlineExceeded(registry.callable_name(fn),
                                   deadline) from e
        raise ExternalCallError(registry.callable_name(fn), e) from e
    except Exception as e:
        raise ExternalCallError(registry.callable_name(fn), e) from e
    if rt.trace is not None:
        rt.trace.resolved(ev)
        _record_declared_effects(rt, fn, ev, pos, kw)
    if token is not None:
        jr.append(token, result, effects=_ev_effects(ev),
                  seq=ev.seq_no if ev is not None else -1)
    return result


def _ev_effects(ev):
    """The effect keys a trace event carries, for journal provenance."""
    effs = getattr(ev, "effects", None) if ev is not None else None
    return tuple(str(k) for k in effs) if effs else ("*",)


def _record_declared_effects(rt, fn, ev, pos, kw):
    """Record the *declared* effect keys now that arguments are concrete —
    locking may have been degraded to ``"*"`` while a key argument was
    still pending, but the trace must carry the deterministic declaration
    so per-domain ≡_A projections match the plain-Python run."""
    if ev is None:
        return
    info = getattr(fn, "__poppy_external__", None)
    if info is not None and info.effects is not None:
        effs = registry.effect_keys(info, pos, kw)
        if effs is not None:
            rt.trace.set_effects(ev, effs)
            _span_note(effects=list(effs))


def _redo_event(rt, ev, fn, callsite, cls, keys):
    """Discard the trace event of a stale (mispredicted) dispatch attempt
    and open a fresh queued/classified event for the re-execution, so the
    committed trace records exactly one event per call — the one the
    non-speculative engine would have recorded."""
    if rt.trace is None:
        return None
    if ev is not None:
        rt.trace.drop_event(ev)
        rt.spec.stats.dropped_events += 1
    nev = rt.trace.queued(registry.callable_name(fn), callsite,
                          wrapped=hasattr(fn, "__poppy_dispatch__"))
    rt.trace.classified(nev, cls, effects=keys)
    return nev


async def _invoke_settled(rt, fn, pos, kw, ev, callsite, cls, keys, *,
                          allow_batch=False):
    """Dispatch until the result is *taint-free*: the predict-and-validate
    redo loop (DESIGN.md §2.4).  Each attempt captures the speculation
    epochs its argument resolution flowed through; a result that depended
    on a guess is held until the guess validates, and on a miss the stale
    attempt's trace event is discarded and the call re-executes with the
    actual value — exactly once per mispredicted epoch.
    """
    stats = rt.spec.stats
    while True:
        tok = taint_scope()
        try:
            result = await invoke_external(rt, fn, pos, kw, ev,
                                           allow_batch=allow_batch)
        finally:
            epochs = current_taint()
            reset_taint(tok)
        stale = [e for e in epochs
                 if e.validated.done() and not e.validated.result()]
        live = tuple(e for e in epochs if not e.validated.done())
        if not stale and not live:
            return result, ev
        if not stale:
            ok = True
            for e in live:
                ok = (await await_future(e.validated)) and ok
            if ok:
                return result, ev
        # a guess this attempt consumed was wrong: the producer epochs
        # already swapped in fresh argument futures — re-execute
        ev = _redo_event(rt, ev, fn, callsite, cls, keys)
        stats.redo_runs += 1


async def _dispatch_unordered(rt, fn, pos, kw, ev, callsite, keys, dst,
                              dfut):
    """Unordered dispatch under speculation: publish the result as soon
    as it is known, *speculatively* when it depends on unvalidated
    guesses (registering the placeholder with each epoch so a miss can
    roll it back), and re-execute on mispredicts until taint-free."""
    stats = rt.spec.stats
    while True:
        tok = taint_scope()
        try:
            result = await invoke_external(rt, fn, pos, kw, ev,
                                           allow_batch=True)
        finally:
            epochs = current_taint()
            reset_taint(tok)
        stale = [e for e in epochs
                 if e.validated.done() and not e.validated.result()]
        live = tuple(e for e in epochs if not e.validated.done())
        if stale:
            # raced: a miss landed mid-dispatch — the result is stale
            ev = _redo_event(rt, ev, fn, callsite, UNORDERED, keys)
            stats.redo_runs += 1
            continue
        fut = dst.fut if dst is not None else dfut
        if not live:
            if dst is not None and dst.spec:
                dst.spec = None
            if not fut.done():
                fut.set_result(result)
            return
        if dst is None:
            # no placeholder to tag speculative — hold until validated
            ok = True
            for e in live:
                ok = (await await_future(e.validated)) and ok
            if ok:
                if not fut.done():
                    fut.set_result(result)
                return
            ev = _redo_event(rt, ev, fn, callsite, UNORDERED, keys)
            stats.redo_runs += 1
            continue
        # tainted: publish speculatively so dependents keep flowing
        for e in live:
            e.register(dst)
        dst.spec = live
        stats.spec_publishes += 1
        if not fut.done():
            fut.set_result(result)
        ok = True
        for e in live:
            ok = (await await_future(e.validated)) and ok
        if ok:
            if dst.spec is live:
                dst.spec = None
            return
        # miss: our placeholder got a fresh future from the epoch's
        # rollback; discard the stale event and re-execute
        ev = _redo_event(rt, ev, fn, callsite, UNORDERED, keys)
        stats.redo_runs += 1


async def _unordered_spec(rt, fn, pos, kw, ev, callsite, keys, dst, dfut,
                          info):
    """Unordered dispatch when a :class:`~repro_torch.core.speculate.speculation`
    context is active: try predict-and-validate first (when the external
    declares a ``predictor=`` and the policy arms it), otherwise run the
    taint-tracking redo loop."""
    spec = rt.spec
    if (spec.policy.predict and dst is not None and info is not None
            and info.predictor is not None):
        try:
            pred = info.predictor([peek(a) for a in pos],
                                  {k: peek(v) for k, v in kw.items()})
        except Exception:
            pred = None  # a predictor must never break the call
        if pred is not None:
            spec.stats.predictions += 1
            epoch = SpecEpoch(rt, dst, pred)
            dst.spec = (epoch,)
            if not dfut.done():
                dfut.set_result(pred)  # dependents launch on the guess
            result, _ = await _invoke_settled(rt, fn, pos, kw, ev, callsite,
                                              UNORDERED, keys,
                                              allow_batch=True)
            if epoch.resolve(rt, result):
                spec.stats.pred_hits += 1
            else:
                spec.stats.pred_misses += 1
            return
    await _dispatch_unordered(rt, fn, pos, kw, ev, callsite, keys, dst,
                              dfut)


async def external_controller(rt, fn, pos, kw, fresh, keys, links,
                              dfut: asyncio.Future, callsite: str,
                              resolve_links=None, dst=None):
    """The controller coroutine for one queued external call.

    ``keys`` are the effect-domain keys the engine resolved for this call;
    ``links`` pairs each affected domain's in-state with the fresh
    out-state the engine installed under that key
    (:meth:`KeyedSeqState.fork`).

    When the incoming keyed state was itself still a placeholder at queue
    time (a control-flow boundary still expanding), the engine passes
    ``links=None`` plus ``resolve_links`` — an async thunk that awaits the
    state, forks it, and returns ``(keys, links)``.  Unordered calls then
    dispatch *immediately* and plumb their lock-chaining concurrently:
    they never wait on locks, so a pending ordering state must not delay
    them (an LLM fan-out downstream of an unresolved conditional is the
    paper's bread-and-butter parallelism).
    """
    trz = current_tracer()
    if trz is None:
        await _external_controller(rt, fn, pos, kw, fresh, keys, links,
                                   dfut, callsite, resolve_links, dst)
        return
    # one span per queued external, on its effect domains' track; the
    # lifecycle phases below (classify, lock waits, arg resolution, batch
    # window, the call itself) nest inside it
    name = registry.callable_name(fn)
    track = "domain:" + ",".join(str(k) for k in keys) if keys \
        else "domain:*"
    with trz.span(name, cat="external", track=track, callsite=callsite):
        await _external_controller(rt, fn, pos, kw, fresh, keys, links,
                                   dfut, callsite, resolve_links, dst)


async def _external_controller(rt, fn, pos, kw, fresh, keys, links,
                               dfut: asyncio.Future, callsite: str,
                               resolve_links=None, dst=None):
    ev = rt.trace.queued(registry.callable_name(fn), callsite,
                         wrapped=hasattr(fn, "__poppy_dispatch__")) \
        if rt.trace is not None else None

    info = getattr(fn, "__poppy_external__", None)
    if registry.sequential_forced():
        cls = SEQUENTIAL
    elif info is not None and info.cls is not None:
        cls = info.cls
    else:
        # dynamic dispatch: classification needs argument *types* — await
        # the spine of each argument (not its contents).  ``settled`` (not
        # ``shallow``): classification is a control decision, so it must
        # never act on an unvalidated speculative value (identical to
        # ``shallow`` when speculation is off)
        trz = current_tracer()
        t_cls = trz.now() if trz is not None else 0.0
        cpos = [check_bound(await settled(a)) for a in pos]
        ckw = {k: await settled(v) for k, v in kw.items()}
        cls = registry.get_callable_class(fn, cpos, ckw, fresh)
        if trz is not None and trz.now() - t_cls >= PHASE_MIN_S:
            trz.record("classify", t_cls, cat="external.classify")
        pos = cpos
        kw = ckw
    if ev is not None:
        rt.trace.classified(ev, cls, effects=keys)
    _span_note(cls=cls, effects=[str(k) for k in keys] if keys else ["*"])

    spec = rt.spec
    if spec is not None and cls != UNORDERED:
        sc = current_scope()
        if sc is not None and not sc.settled:
            # effectful call inside an unresolved speculative arm: hold at
            # the dispatch boundary until the branch decision commits this
            # arm (or be cancelled with it) — a losing arm must commit no
            # effects
            spec.stats.gated_holds += 1
            await sc.admitted()

    if links is None:
        if cls == UNORDERED:
            # dispatch now; chain each domain's locks through once the
            # keyed state lands (unordered never waits on locks)
            async def plumb():
                _, late_links = await resolve_links()
                for s, o in late_links:
                    _chain_all([s.f_r], o.f_r)
                    _chain_all([s.f_w], o.f_w)

            rt.spawn(plumb())
            if spec is not None:
                await _unordered_spec(rt, fn, pos, kw, ev, callsite, keys,
                                      dst, dfut, info)
                return
            result = await invoke_external(rt, fn, pos, kw, ev,
                                           allow_batch=True)
            dfut.set_result(result)
            return
        keys, links = await resolve_links()
        if ev is not None:
            rt.trace.classified(ev, cls, effects=keys)
        _span_note(effects=[str(k) for k in keys] if keys else ["*"])

    outs = list({id(o): o for _, o in links}.values())
    # Lock futures are resolved in a ``finally``: a failing call must not
    # leave an out-state unresolved, or every downstream controller parks
    # on a lock nobody will ever release.  Failure is recorded on the
    # runtime *before* the locks release (the ``except`` below runs first),
    # so a sibling waking on a freed lock sees ``rt.error`` set and parks in
    # ``invoke_external`` instead of dispatching an external that standard
    # sequential Python would never have reached.
    if cls == UNORDERED:
        # no ordering: forward each domain's chain through *its own*
        # out-state, never coupling domains
        for s, o in links:
            _chain_all([s.f_r], o.f_r)
            _chain_all([s.f_w], o.f_w)
        if spec is not None:
            await _unordered_spec(rt, fn, pos, kw, ev, callsite, keys,
                                  dst, dfut, info)
            return
        result = await invoke_external(rt, fn, pos, kw, ev,
                                       allow_batch=True)
        dfut.set_result(result)
    elif cls == READONLY:
        try:
            await _await_locks_traced([s.f_r for s, _ in links], "r")
            for o in outs:
                _resolve_lock(o.f_r)  # forward before dispatching
            result = await invoke_external(rt, fn, pos, kw, ev,
                                           settle=spec is not None)
            if spec is not None and (sc := current_scope()) is not None \
                    and sc.aborted:
                spec.stats.loser_effects += 1  # invariant: must stay 0
            dfut.set_result(result)
            await _await_locks_traced([s.f_w for s, _ in links], "w")
        except BaseException as e:
            if not isinstance(e, asyncio.CancelledError):
                rt.fail(e)
            raise
        finally:
            for o in outs:
                _resolve_lock(o.f_r)
                _resolve_lock(o.f_w)
    elif cls == SEQUENTIAL:
        try:
            await _await_locks_traced(
                [s.f_r for s, _ in links] + [s.f_w for s, _ in links],
                "rw")
            result = await invoke_external(rt, fn, pos, kw, ev,
                                           settle=spec is not None)
            if spec is not None and (sc := current_scope()) is not None \
                    and sc.aborted:
                spec.stats.loser_effects += 1  # invariant: must stay 0
            dfut.set_result(result)
        except BaseException as e:
            if not isinstance(e, asyncio.CancelledError):
                rt.fail(e)
            raise
        finally:
            for o in outs:
                _resolve_lock(o.f_r)
                _resolve_lock(o.f_w)
    else:  # pragma: no cover
        raise PoppyRuntimeError(f"unknown reordering class {cls!r}")
