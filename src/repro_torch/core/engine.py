"""The opportunistic (λ^O) execution engine (paper §3.1, §6.2).

Executes compiled λ^O graphs with *opportunistic evaluation*: internal
operations run eagerly as soon as their inputs are available — execution
continues past outstanding external calls, whose results are placeholder
``Pending`` values.  External calls enter the *queued* state and are owned
by concurrency controllers (``controllers.py``).

The engine is a single asyncio event loop.  The scheduler is "inline-first":
an operation whose inputs are ready executes synchronously with no task
overhead (this keeps interpreter overhead in the paper's reported 0.15–11%
band); an operation blocked on a placeholder defers to a lightweight task.
Confluence of λ^O guarantees any such order is equivalent (paper §3.1).
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import importlib
import os
import pickle
import sys
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass

from ..obs.spans import current_tracer as _obs_tracer
from ..obs.spans import maybe_span

from . import registry
from .batching import BatchCollector, current_batching_policy
from .controllers import external_controller
from .errors import PoppyRuntimeError
from .lambda_o import (
    ITEM,
    LBlock,
    LCallOp,
    LClosure,
    LConst,
    LFor,
    LFunc,
    LGlobal,
    LIte,
    LPrim,
    LWhile,
    PoppyClosure,
)
from .speculate import current_scope, current_speculation
from .trace import Trace, current_segment, current_trace
from .values import (
    KS_READY,
    STAR,
    UNBOUND,
    Pending,
    SeqState,
    check_bound,
    deep_ready,
    deep_resolve,
    is_pending,
    peek,
    settled,
    shallow,
)

import builtins as _builtins

_current_runtime: contextvars.ContextVar["Runtime | None"] = \
    contextvars.ContextVar("poppy_runtime", default=None)


def current_runtime() -> "Runtime | None":
    return _current_runtime.get()


# ---------------------------------------------------------------------------
# executor offload (blocking externals must not serialize on the loop)
#
# The dominant real-world external is a *blocking* SDK client (classic
# ``openai``, ``requests``); dispatched inline on the event loop such calls
# get zero parallelism no matter what the annotations allow.  Synchronous
# externals therefore default to dispatching on a per-runtime
# ThreadPoolExecutor (``loop.run_in_executor``).  Per-annotation
# ``offload="inline"`` opts a callable out; ``offload_policy`` changes the
# runtime-wide default and pool size.


@dataclass(frozen=True)
class OffloadPolicy:
    """Runtime-wide executor-offload configuration.

    ``mode`` — default placement for annotated sync externals that did not
    pick one themselves: ``"thread"`` (overlap blocking calls),
    ``"process"`` (ProcessPoolExecutor, for CPU-bound externals the GIL
    would serialize — arguments/results must be picklable and the target a
    module-level function), or ``"inline"`` (paper §6.1 single-interpreter
    dispatch, zero thread overhead — and zero parallelism for blocking
    calls).
    ``max_workers`` — thread-pool size; bounds how many blocking externals
    overlap (``None`` → min(32, cpu+4, …) heuristic below).
    ``process_workers`` — process-pool size (``None`` → cpu count).
    """

    mode: str = "thread"
    max_workers: int | None = None
    process_workers: int | None = None

    def __post_init__(self):
        if self.mode not in ("thread", "process", "inline"):
            raise ValueError(f"offload mode must be 'thread', 'process', "
                             f"or 'inline', got {self.mode!r}")
        if self.max_workers is not None and self.max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        if self.process_workers is not None and self.process_workers < 1:
            raise ValueError("process_workers must be >= 1")


_offload_policy: contextvars.ContextVar[OffloadPolicy] = \
    contextvars.ContextVar("poppy_offload_policy", default=OffloadPolicy())


def current_offload_policy() -> OffloadPolicy:
    return _offload_policy.get()


class offload_policy:
    """Context manager: set the executor-offload policy for runtimes started
    in this context.  ``offload_policy(mode="inline")`` reproduces the old
    loop-inline dispatch (useful for overhead measurement and thread-affine
    clients); ``offload_policy(max_workers=4)`` caps blocking-call overlap.
    """

    def __init__(self, mode="thread", max_workers=None, process_workers=None):
        self.policy = OffloadPolicy(mode=mode, max_workers=max_workers,
                                    process_workers=process_workers)

    def __enter__(self):
        self._tok = _offload_policy.set(self.policy)
        return self.policy

    def __exit__(self, *exc):
        _offload_policy.reset(self._tok)
        return False


def _default_pool_size() -> int:
    # the stdlib heuristic, with a floor of 8 so small containers still
    # demonstrate overlap of a typical external-call burst
    return max(8, min(32, (os.cpu_count() or 1) + 4))


def _process_call(module: str, qualname: str, pos, kw):
    """Worker-side trampoline for ``offload="process"`` externals.

    Decorated externals don't pickle (the wrapper is a local closure), so
    the parent ships ``(module, qualname)`` and the worker re-imports the
    wrapper and unwraps it to the underlying implementation
    (``__poppy_dispatch__``).  Runs in a **separate interpreter**: no
    runtime, trace, or dispatcher context crosses the boundary.
    """
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    target = getattr(obj, "__poppy_dispatch__", obj)
    return target(*pos, **kw)


class Frame:
    """One block instance: a register file plus its owning λ^O function."""

    __slots__ = ("regs", "lfunc")

    def __init__(self, lfunc: LFunc, nregs: int):
        self.lfunc = lfunc
        self.regs = [None] * nregs


def _fulfill(fut: asyncio.Future, value):
    """Set ``fut`` from ``value``.

    A ``Pending`` value is stored *by reference* (consumers loop-unwrap
    placeholder chains) rather than flattened through a done-callback:
    flattening would copy a speculatively-resolved value out of its
    placeholder and strand the taint/epoch tag behind (DESIGN.md §2.4) —
    the chain keeps ``spec`` visible at every link, and keeps exceptions
    in the future that actually failed.
    """
    if not fut.done():
        fut.set_result(value)


def _is_internal(fn) -> bool:
    return getattr(fn, "__poppy_internal__", False)


_MISSING_ARG = object()


def _fmt_names(names) -> str:
    quoted = [f"'{n}'" for n in names]
    if len(quoted) == 1:
        return quoted[0]
    if len(quoted) == 2:
        return f"{quoted[0]} and {quoted[1]}"
    return ", ".join(quoted[:-1]) + f", and {quoted[-1]}"


def bind_positional(name: str, params, pos, kw) -> list:
    """Bind a call to a signature-less λ^O function (closures/lambdas carry
    only a parameter name list).  Raises ``TypeError`` with CPython's
    messages instead of silently binding missing parameters to None or
    surfacing unknown keyword names as ``ValueError`` from ``list.index``.
    """
    if len(pos) > len(params):
        raise TypeError(
            f"{name}() takes {len(params)} positional argument"
            f"{'s' if len(params) != 1 else ''} but {len(pos)} "
            f"{'were' if len(pos) != 1 else 'was'} given")
    vals = list(pos) + [_MISSING_ARG] * (len(params) - len(pos))
    for k, v in kw.items():
        if k not in params:
            raise TypeError(
                f"{name}() got an unexpected keyword argument '{k}'")
        i = params.index(k)
        if vals[i] is not _MISSING_ARG:
            raise TypeError(
                f"{name}() got multiple values for argument '{k}'")
        vals[i] = v
    missing = [p for p, v in zip(params, vals) if v is _MISSING_ARG]
    if missing:
        raise TypeError(
            f"{name}() missing {len(missing)} required positional argument"
            f"{'s' if len(missing) != 1 else ''}: {_fmt_names(missing)}")
    return vals


class Runtime:
    """One opportunistic execution of a ``@poppy`` entry point."""

    def __init__(self, *, trace: Trace | None = None,
                 inline_fast_path: bool = True,
                 offload: str | None = None,
                 offload_workers: int | None = None):
        self.trace = trace
        self.inline_fast_path = inline_fast_path
        self.tasks: set[asyncio.Task] = set()
        self.loop: asyncio.AbstractEventLoop | None = None
        self.error: BaseException | None = None
        self._err_evt: asyncio.Event | None = None
        pol = current_offload_policy()
        self.offload_mode = offload if offload is not None else pol.mode
        if self.offload_mode not in ("thread", "process", "inline"):
            raise ValueError(f"offload must be 'thread', 'process', or "
                             f"'inline', got {self.offload_mode!r}")
        self.offload_workers = offload_workers if offload_workers is not None \
            else pol.max_workers
        self.process_workers = pol.process_workers
        self._executor: ThreadPoolExecutor | None = None
        self._pexecutor: ProcessPoolExecutor | None = None
        # durability (DESIGN.md §2.5): the ambient write-ahead journal, if
        # any.  Imported lazily — repro_torch.durability reaches back into the
        # dispatch layer, which imports this module.
        from ..durability.journal import current_journal
        self.journal = current_journal()
        self.batching = current_batching_policy().enabled
        self._batches: BatchCollector | None = None
        # speculation (DESIGN.md §2.4): captured from the ambient
        # ``with speculation():`` context; None → every speculative path
        # below is skipped and the engine behaves exactly as before
        self.spec = current_speculation()
        # task → owning SpecScope, for routing task failures to a
        # still-speculative arm instead of failing the whole run
        self.scope_of: dict[asyncio.Task, object] = {}

    # -- auto-batching -----------------------------------------------------

    @property
    def batches(self) -> BatchCollector:
        """Lazily-created batch-window collector (never allocated for runs
        that don't batch)."""
        if self._batches is None:
            self._batches = BatchCollector(self)
        return self._batches

    # -- executor offload --------------------------------------------------

    @property
    def executor(self) -> ThreadPoolExecutor:
        """Lazily-created pool for blocking externals (never spun up for
        purely async / inline programs)."""
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self.offload_workers or _default_pool_size(),
                thread_name_prefix="poppy-offload")
        return self._executor

    @property
    def process_executor(self) -> ProcessPoolExecutor:
        """Lazily-created process pool for ``offload="process"`` externals
        (never spun up for runs that don't use it)."""
        if self._pexecutor is None:
            self._pexecutor = ProcessPoolExecutor(
                max_workers=self.process_workers)
        return self._pexecutor

    def offload_mode_for(self, fn) -> str:
        """Where a *synchronous* external executes: the annotation's explicit
        choice, else this runtime's default ('thread' unless configured)."""
        mode = registry.annotated_offload(fn)
        return self.offload_mode if mode is None else mode

    def run_sync(self, target, pos, kw) -> asyncio.Future:
        """Dispatch a blocking call on the offload executor.

        The caller's context is propagated so ambient state (trace, backend,
        dispatcher, current runtime) resolves inside the worker thread — a
        blocking external that itself calls annotated components behaves as
        it would inline.
        """
        ctx = contextvars.copy_context()
        trz = _obs_tracer()
        if trz is None:
            return self.loop.run_in_executor(
                self.executor, lambda: ctx.run(target, *pos, **kw))

        # traced: record the worker-thread occupancy as a span on the
        # worker's own track; the propagated context parents it under the
        # caller's external.call span
        def offloaded():
            with trz.span(
                    "offload", cat="offload",
                    track="offload:" + threading.current_thread().name):
                return target(*pos, **kw)

        return self.loop.run_in_executor(
            self.executor, lambda: ctx.run(offloaded))

    def run_process(self, fn, pos, kw) -> asyncio.Future:
        """Dispatch a CPU-bound external on the process pool.

        The target must be importable by name (a module-level function —
        the worker re-imports it) and the arguments picklable; both are
        validated *here* so a violation fails the call with a clear
        message instead of a deep BrokenProcessPool traceback.
        """
        mod = getattr(fn, "__module__", None)
        qn = getattr(fn, "__qualname__", None)
        if not mod or not qn or "<locals>" in qn:
            raise TypeError(
                f"offload='process' requires a module-level function "
                f"(importable by name); {qn or fn!r} is not — nested "
                f"functions and lambdas cannot cross the process boundary")
        try:
            pickle.dumps((tuple(pos), kw))
        except Exception as e:
            raise TypeError(
                f"offload='process' arguments for {qn!r} must be "
                f"picklable: {e}") from e
        return self.loop.run_in_executor(
            self.process_executor,
            functools.partial(_process_call, mod, qn, tuple(pos), kw))

    # -- task management ---------------------------------------------------

    def spawn(self, coro):
        task = self.loop.create_task(coro)
        self.tasks.add(task)
        if self.spec is not None:
            sc = current_scope()
            if sc is not None and not sc.settled:
                sc.adopt(task)
                self.scope_of[task] = sc
        task.add_done_callback(self._task_done)
        return task

    def _task_done(self, task):
        self.tasks.discard(task)
        sc = self.scope_of.pop(task, None)
        if sc is not None:
            sc.tasks.discard(task)
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            if sc is not None and not sc.committed:
                # a speculative arm is allowed to crash: remember the
                # error; it surfaces iff the arm commits (scope.commit)
                if sc.error is None:
                    sc.error = exc
                return
            self.fail(exc)

    def fail(self, exc: BaseException):
        if self.error is None:
            self.error = exc
        if self._err_evt is not None:
            self._err_evt.set()

    def new_future(self) -> asyncio.Future:
        return self.loop.create_future()

    # -- execution -------------------------------------------------------------

    async def run(self, poppy_fn, args, kwargs):
        self.loop = asyncio.get_running_loop()
        self._err_evt = asyncio.Event()
        if self.trace is None:
            self.trace = current_trace()
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 20000))
        tok = _current_runtime.set(self)
        # root span for the whole run: entered before any controller task
        # is spawned so every external span parents under it (create_task
        # copies the context, current span included)
        run_cm = maybe_span(
            "run:" + getattr(poppy_fn.lfunc, "name", "poppy"), cat="engine")
        run_cm.__enter__()
        try:
            inputs = self._bind(poppy_fn, list(args), dict(kwargs))
            outs = self.instantiate(poppy_fn.lfunc,
                                    poppy_fn.lfunc.block, inputs)
            # settle=True: the program's return value must never be a
            # still-speculative guess (DESIGN.md §2.4)
            ret_task = self.loop.create_task(
                deep_resolve(outs[0], settle=True))
            err_task = self.loop.create_task(self._err_evt.wait())
            try:
                await asyncio.wait({ret_task, err_task},
                                   return_when=asyncio.FIRST_COMPLETED)
                if self.error is not None:
                    ret_task.cancel()
                    await self._abort()
                    raise self.error
                result = check_bound(ret_task.result())
                # drain remaining external calls so all side effects land
                # (sequential semantics: the program "finishes" after its
                # trailing externals)
                while self.tasks:
                    await asyncio.wait(set(self.tasks),
                                       return_when=asyncio.FIRST_COMPLETED)
                    if self.error is not None:
                        await self._abort()
                        raise self.error
                return result
            finally:
                err_task.cancel()
        finally:
            run_cm.__exit__(None, None, None)
            _current_runtime.reset(tok)
            sys.setrecursionlimit(old_limit)
            if self._batches is not None:
                # success path: every window flushed (the drain loop waits
                # for the element controllers); on abort, cancel the
                # backstop timers so nothing fires into a closing loop
                self._batches.close()
            if self._executor is not None:
                # all offloaded calls have completed on the success path (the
                # drain loop above); on abort, queued-but-unstarted work is
                # dropped and in-flight blocking calls finish in the
                # background without holding the program's exit
                self._executor.shutdown(wait=False, cancel_futures=True)
            if self._pexecutor is not None:
                self._pexecutor.shutdown(wait=False, cancel_futures=True)

    async def _abort(self):
        for t in list(self.tasks):
            t.cancel()
        if self.tasks:
            await asyncio.gather(*list(self.tasks), return_exceptions=True)

    # -- internal call binding ----------------------------------------------------

    def _bind(self, fn_obj, pos, kw):
        lf: LFunc = fn_obj.lfunc
        captured = getattr(fn_obj, "captured_vals", ())
        if lf.signature is not None:
            ba = lf.signature.bind(*pos, **kw)
            ba.apply_defaults()
            vals = [ba.arguments[p] for p in lf.params]
        else:
            vals = bind_positional(lf.name, lf.params, pos, kw)
        return vals + list(captured) + [KS_READY]

    # -- block instantiation ----------------------------------------------------

    def instantiate(self, lfunc: LFunc, block: LBlock, inputs) -> list:
        frame = Frame(lfunc, block.nregs)
        regs = frame.regs
        for reg, val in zip(block.input_regs, inputs):
            regs[reg] = val
        for op in block.ops:
            self._step(op, frame)
        return [regs[r] for r in block.outputs]

    def _block_inputs(self, block: LBlock, frame: Frame, item=None,
                      carries=None):
        vals = []
        for src in block.input_srcs:
            if isinstance(src, int):
                vals.append(frame.regs[src])
            elif src == ITEM:
                vals.append(item)
            elif src[0] == "carry":
                vals.append(carries[src[1]])
            else:  # pragma: no cover
                raise PoppyRuntimeError(f"bad input src {src}")
        return vals

    # -- op stepping -----------------------------------------------------------------

    def _step(self, op, frame: Frame):
        t = type(op)
        if t is LCallOp:
            self._step_call(op, frame)
        elif t is LConst:
            frame.regs[op.dst] = op.value
        elif t is LGlobal:
            frame.regs[op.dst] = self._resolve_global(frame.lfunc, op.name)
        elif t is LPrim:
            self._step_prim(op, frame)
        elif t is LIte:
            self._step_ite(op, frame)
        elif t is LFor:
            self._step_for(op, frame)
        elif t is LWhile:
            self._step_while(op, frame)
        elif t is LClosure:
            frame.regs[op.dst] = PoppyClosure(
                op.lfunc, tuple(frame.regs[r] for r in op.captured))
        else:  # pragma: no cover
            raise PoppyRuntimeError(f"unknown op {op!r}")

    def _resolve_global(self, lfunc: LFunc, name: str):
        cell = lfunc.closure_map.get(name)
        if cell is not None:
            return cell.cell_contents
        g = lfunc.globals_ref or {}
        if name in g:
            return g[name]
        try:
            return getattr(_builtins, name)
        except AttributeError:
            raise NameError(f"name {name!r} is not defined") from None

    # -- prims -------------------------------------------------------------------------

    def _step_prim(self, op: LPrim, frame: Frame):
        regs = frame.regs
        vals = [regs[a] for a in op.args]
        kind = op.op
        if kind == "tuple" or kind == "list" or kind == "slice":
            for v in vals:
                if v is UNBOUND:
                    check_bound(v)
            if kind == "tuple":
                regs[op.dst] = tuple(vals)
            elif kind == "list":
                regs[op.dst] = list(vals)
            else:
                regs[op.dst] = slice(*vals)
            return
        # set/dict need hashable (resolved) keys; proj needs the spine
        if all(deep_ready(v) for v in vals):
            regs[op.dst] = self._finish_prim(kind, vals)
        else:
            fut = self.new_future()
            regs[op.dst] = Pending(fut)
            self.spawn(self._prim_async(kind, vals, fut))

    def _finish_prim(self, kind, vals):
        for v in vals:
            if v is UNBOUND:
                check_bound(v)
        if kind == "set":
            return set(vals)
        if kind == "dict":
            return dict(zip(vals[0::2], vals[1::2]))
        if kind == "proj":
            return vals[0][vals[1]]
        raise PoppyRuntimeError(f"unknown prim {kind}")  # pragma: no cover

    async def _prim_async(self, kind, vals, fut):
        # settle=True: set/dict/proj results are published unregistered
        # (no redo loop owns this future), so they must not be computed
        # from an unvalidated guess
        vals = [await deep_resolve(v, settle=True) for v in vals]
        fut.set_result(self._finish_prim(kind, vals))

    # -- conditionals ------------------------------------------------------------------

    def _expand_branch(self, op: LIte, frame: Frame, cond) -> list:
        blk = op.then_block if cond else op.else_block
        return self.instantiate(frame.lfunc, blk,
                                self._block_inputs(blk, frame))

    def _step_ite(self, op: LIte, frame: Frame):
        cond = frame.regs[op.cond]
        if not is_pending(cond):
            outs = self._expand_branch(op, frame, check_bound(cond))
            for r, v in zip(op.outs, outs):
                frame.regs[r] = v
            return
        sp = self.spec
        if (sp is not None and sp.policy.branches
                and self._ite_worth_speculating(op, frame)):
            self._speculate_ite(op, frame, cond)
            return
        futs = [self.new_future() for _ in op.outs]
        for r, f in zip(op.outs, futs):
            frame.regs[r] = Pending(f)

        async def later():
            # settled(): a control decision never acts on a speculative
            # value — a predicted condition waits for validation here
            c = check_bound(await settled(cond))
            outs = self._expand_branch(op, frame, c)
            for f, v in zip(futs, outs):
                _fulfill(f, v)

        self.spawn(later())

    def _ite_worth_speculating(self, op: LIte, frame: Frame) -> bool:
        """Race the arms only when at least one arm dispatches a
        statically-``@unordered`` external (resolved from the lowering-time
        callee-name capture, :func:`repro_torch.core.lower._block_call_names`) —
        otherwise both arms are interpreter glue and the non-speculative
        deferral is cheaper.  Unknown callees contribute nothing: safety
        is enforced dynamically (scope gating), this is purely a
        benefit heuristic."""
        for names in (op.then_calls, op.else_calls):
            for n in names:
                try:
                    fn = self._resolve_global(frame.lfunc, n)
                except NameError:
                    continue
                info = getattr(fn, "__poppy_external__", None)
                if info is not None and info.cls == registry.UNORDERED:
                    return True
        return False

    def _speculate_ite(self, op: LIte, frame: Frame, cond):
        """Branch speculation (DESIGN.md §2.4): expand *both* arms now,
        each inside a :class:`~repro_torch.core.speculate.SpecScope` — unordered
        externals dispatch immediately, effectful calls park on the
        scope's admission gate, and every task/trace event the arm
        produces is tagged to the scope.  When the condition settles, the
        winner commits and the loser aborts (tasks cancelled, trace
        segment discarded)."""
        from .speculate import SpecScope, scope_context
        futs = [self.new_future() for _ in op.outs]
        for r, f in zip(op.outs, futs):
            frame.regs[r] = Pending(f)
        self.spec.stats.branches_speculated += 1

        def expand(arm: bool):
            seg = self.trace.new_segment() if self.trace is not None else 0
            scope = SpecScope(self, parent=current_scope(), seg=seg)
            outs = None
            with scope_context(scope):
                try:
                    outs = self._expand_branch(op, frame, arm)
                except BaseException as e:
                    # the wrong arm may legitimately crash (e.g. an
                    # UnboundLocal in the not-taken path); hold the error
                    # and surface it only if this arm commits
                    scope.error = e
            return scope, outs

        then_scope, then_outs = expand(True)
        else_scope, else_outs = expand(False)

        async def decide():
            c = check_bound(await settled(cond))
            if c:
                win_scope, win_outs, lose = then_scope, then_outs, else_scope
            else:
                win_scope, win_outs, lose = else_scope, else_outs, then_scope
            lose.abort()
            win_scope.commit()
            if win_outs is None:
                raise win_scope.error
            for f, v in zip(futs, win_outs):
                _fulfill(f, v)

        self.spawn(decide())

    # -- fold (for loops) ---------------------------------------------------------

    def _run_fold(self, op: LFor, frame: Frame, spine) -> list:
        carries = [frame.regs[r] for r in op.init]
        body = op.body
        for item in spine:
            carries = self.instantiate(
                frame.lfunc, body,
                self._block_inputs(body, frame, item=item, carries=carries))
        return carries

    def _step_for(self, op: LFor, frame: Frame):
        spine = frame.regs[op.spine]
        if not is_pending(spine):
            outs = self._run_fold(op, frame, check_bound(spine))
            for r, v in zip(op.outs, outs):
                frame.regs[r] = v
            return
        futs = [self.new_future() for _ in op.outs]
        for r, f in zip(op.outs, futs):
            frame.regs[r] = Pending(f)

        async def later():
            sp = check_bound(await settled(spine))
            outs = self._run_fold(op, frame, sp)
            for f, v in zip(futs, outs):
                _fulfill(f, v)

        self.spawn(later())

    # -- while loops --------------------------------------------------------------

    def _step_while(self, op: LWhile, frame: Frame):
        carries = [frame.regs[r] for r in op.init]
        outs_bound = False
        futs = None

        def bind(vals):
            if futs is None:
                for r, v in zip(op.outs, vals):
                    frame.regs[r] = v
            else:
                for f, v in zip(futs, vals):
                    _fulfill(f, v)

        # inline iterations while the condition resolves synchronously
        while True:
            couts = self.instantiate(
                frame.lfunc, op.cond_block,
                self._block_inputs(op.cond_block, frame, carries=carries))
            cond, carries_after = couts[0], couts[1:]
            if is_pending(cond):
                break
            if not check_bound(cond):
                bind(carries_after)
                return
            carries = self.instantiate(
                frame.lfunc, op.body_block,
                self._block_inputs(op.body_block, frame,
                                   carries=carries_after))

        futs = [self.new_future() for _ in op.outs]
        for r, f in zip(op.outs, futs):
            frame.regs[r] = Pending(f)

        async def later(cond, carries_after):
            while True:
                c = check_bound(await settled(cond))
                if not c:
                    bind(carries_after)
                    return
                carries = self.instantiate(
                    frame.lfunc, op.body_block,
                    self._block_inputs(op.body_block, frame,
                                       carries=carries_after))
                couts = self.instantiate(
                    frame.lfunc, op.cond_block,
                    self._block_inputs(op.cond_block, frame, carries=carries))
                cond, carries_after = couts[0], couts[1:]

        self.spawn(later(cond, carries_after))

    # -- calls --------------------------------------------------------------------

    def _split_args(self, op: LCallOp, frame: Frame):
        vals = [frame.regs[a] for a in op.args]
        npos = len(vals) - len(op.kwnames)
        pos = vals[:npos]
        kw = dict(zip(op.kwnames, vals[npos:]))
        fresh = op.fresh[:npos] if op.fresh else ()
        return pos, kw, fresh

    def _step_call(self, op: LCallOp, frame: Frame):
        regs = frame.regs
        fnv = regs[op.fn]
        s_in = peek(regs[op.s_in])

        if op.unpack:
            # *args/**kwargs call site: args = (pos-tuple reg, kw-dict reg);
            # splice once the container spines are known (elements may
            # still be Pending — exactly like normal call arguments)
            pos_c = peek(regs[op.args[0]])
            kw_c = peek(regs[op.args[1]])
            if is_pending(pos_c) or is_pending(kw_c):
                dfut = self.new_future()
                sfut = self.new_future()
                dst = Pending(dfut)
                regs[op.dst] = dst
                regs[op.s_out] = Pending(sfut)
                self.spawn(self._deferred_unpack(op, fnv, pos_c, kw_c, s_in,
                                                 dfut, sfut, dst))
                return
            pos = list(check_bound(pos_c))
            kw = dict(check_bound(kw_c))
            fresh = ()
        else:
            pos, kw, fresh = self._split_args(op, frame)

        if not is_pending(fnv):
            fn = check_bound(fnv)
            if _is_internal(fn):
                inputs = self._bind_graph_call(fn, pos, kw, s_in)
                outs = self.instantiate(fn.lfunc, fn.lfunc.block, inputs)
                regs[op.dst] = outs[0]
                regs[op.s_out] = outs[1]
                return
            # external: inline fast path for ready unordered sync calls that
            # actually execute inline — thread-offloaded externals go through
            # a controller so the blocking call lands on the executor
            from .controllers import unwrap_external
            if (self.inline_fast_path
                    and not is_pending(s_in)
                    and all(deep_ready(a) for a in pos)
                    and all(deep_ready(v) for v in kw.values())
                    and not registry.is_async_callable(unwrap_external(fn))
                    and self.offload_mode_for(fn) == "inline"
                    and not (self.batching
                             and registry.batch_spec(fn) is not None)):
                cls = registry.get_callable_class(fn, pos, kw, fresh)
                if cls == registry.UNORDERED:
                    regs[op.dst] = self._dispatch_inline(fn, pos, kw,
                                                         op.callsite)
                    regs[op.s_out] = s_in  # forward locks unchanged
                    return
            # static-unordered fast path: loop glue (operators over
            # immutable accumulators) classifies at queue time even while
            # argument *values* are pending, so it forwards the keyed
            # ordering state untouched — independent domains stay
            # independent across ``acc += (x,)`` chains
            su = registry.static_unordered(fn, pos, kw, fresh)
            if su is not None:
                dfut = self.new_future()
                dst = Pending(dfut, imm_hint=su)
                regs[op.dst] = dst
                regs[op.s_out] = s_in
                self.spawn(external_controller(
                    self, fn, pos, kw, fresh, (STAR,), [], dfut,
                    op.callsite, dst=dst))
                return
            # queued external call: resolve the effect-domain keys, fork
            # the keyed ordering state, and spawn a concurrency controller.
            # The result hint is trusted only for *statically-classed*
            # annotations (the user's returns_immutable contract) — for a
            # dynamically-classified intrinsic, imm_result is conditional
            # on the arguments being immutable, which only the
            # static-unordered fast path above proves (list + list returns
            # a mutable list).
            info = getattr(fn, "__poppy_external__", None)
            dfut = self.new_future()
            dst = Pending(
                dfut, imm_hint=info is not None and info.cls is not None
                and info.imm_result)
            regs[op.dst] = dst
            if is_pending(s_in):
                # ordering state not yet known (e.g. downstream of a
                # deferred method call): defer the fork itself so per-domain
                # precision is preserved — the locks, not the state value,
                # are what gates dispatch
                sfut = self.new_future()
                regs[op.s_out] = Pending(sfut)
                self.spawn(self._queued_after_s(op, fn, pos, kw, fresh,
                                                s_in, dfut, sfut, dst))
                return
            keys, out_keyed, links = self._fork_keyed(fn, pos, kw, s_in)
            regs[op.s_out] = out_keyed
            self.spawn(external_controller(
                self, fn, pos, kw, fresh, keys, links, dfut, op.callsite,
                dst=dst))
            return

        # unknown callee: defer everything
        dfut = self.new_future()
        sfut = self.new_future()
        dst = Pending(dfut)
        regs[op.dst] = dst
        regs[op.s_out] = Pending(sfut)
        self.spawn(self._deferred_call(op, fnv, pos, kw, fresh, s_in,
                                       dfut, sfut, dst))

    def _new_seq_state(self) -> SeqState:
        return SeqState(self.new_future(), self.new_future())

    def _fork_keyed(self, fn, pos, kw, s_in):
        """Resolve a queued call's effect keys and fork the keyed state.

        When a key-determining argument is still pending, locking degrades
        to the ``"*"`` domain — the call orders against everything, which
        only over-orders (always sound); the trace later records the
        declared keys once arguments resolve."""
        keys = registry.resolve_effect_keys(fn, pos, kw)
        keys = (STAR,) if keys is None else tuple(dict.fromkeys(keys))
        out_keyed, links = s_in.fork(keys, self._new_seq_state)
        return keys, out_keyed, links

    async def _deferred_unpack(self, op, fnv, pos_c, kw_c, s_in, dfut, sfut,
                               dst=None):
        pos_c = check_bound(await settled(pos_c))
        kw_c = check_bound(await settled(kw_c))
        await self._deferred_call(op, fnv, list(pos_c), dict(kw_c), (),
                                  s_in, dfut, sfut, dst)

    async def _queued_after_s(self, op, fn, pos, kw, fresh, s_in, dfut, sfut,
                              dst=None):
        """Known external callee, pending ordering state: run the
        controller now with a thunk that awaits the keyed state and forks
        it with full per-domain precision.  The controller uses the thunk
        lazily — unordered calls dispatch before the state even lands."""

        async def resolve_links():
            s = await shallow(s_in)
            keys, out_keyed, links = self._fork_keyed(fn, pos, kw, s)
            sfut.set_result(out_keyed)
            return keys, links

        await external_controller(self, fn, pos, kw, fresh, (STAR,), None,
                                  dfut, op.callsite,
                                  resolve_links=resolve_links, dst=dst)

    def _dispatch_inline(self, fn, pos, kw, callsite):
        from .controllers import unwrap_external
        from .trace import safe_repr
        pos = [check_bound(a) for a in pos]
        kw = {k: check_bound(v) for k, v in kw.items()}
        ev = None
        if self.trace is not None:
            ev = self.trace.queued(registry.callable_name(fn), callsite,
                                   wrapped=hasattr(fn, "__poppy_dispatch__"))
            self.trace.classified(ev, registry.UNORDERED)
            self.trace.dispatched(ev, args_repr=safe_repr((tuple(pos), kw)))
        # durability: replay a journaled resolution, or journal the live
        # one (wrapped externals only — interpreter intrinsics are cheap
        # to re-execute and their arguments need not be repr-stable)
        jr = self.journal
        token = None
        if jr is not None and hasattr(fn, "__poppy_dispatch__") \
                and current_segment() == 0:
            hit, token, val = jr.claim(registry.callable_name(fn), pos, kw)
            if hit:
                if ev is not None:
                    self.trace.resolved(ev)
                return val
        try:
            with maybe_span(registry.callable_name(fn), cat="external",
                            cls="unordered", inline=True,
                            seq=ev.seq_no if ev is not None else -1):
                result = unwrap_external(fn)(*pos, **kw)
        except Exception as e:
            from .errors import ExternalCallError
            raise ExternalCallError(registry.callable_name(fn), e) from e
        if ev is not None:
            self.trace.resolved(ev)
        if token is not None:
            jr.append(token, result,
                      seq=ev.seq_no if ev is not None else -1)
        return result

    def _bind_graph_call(self, fn, pos, kw, s_in):
        lf: LFunc = fn.lfunc
        captured = getattr(fn, "captured_vals", ())
        if lf.signature is not None:
            ba = lf.signature.bind(*pos, **kw)
            ba.apply_defaults()
            vals = [ba.arguments[p] for p in lf.params]
        else:
            vals = bind_positional(lf.name, lf.params, pos, kw)
        return vals + list(captured) + [s_in]

    async def _deferred_call(self, op, fnv, pos, kw, fresh, s_in, dfut, sfut,
                             dst=None):
        # settled(): dispatch decisions (which callee, internal vs
        # external) never act on a speculative value
        fn = check_bound(await settled(fnv))
        if _is_internal(fn):
            inputs = self._bind_graph_call(fn, pos, kw, s_in)
            outs = self.instantiate(fn.lfunc, fn.lfunc.block, inputs)
            _fulfill(dfut, outs[0])
            _fulfill(sfut, outs[1])
            return
        # the deferred path can afford to await the keyed in-state, so it
        # resolves effect keys with full precision (no "*" degradation for
        # a merely-pending ordering state)
        s_in = await shallow(s_in)
        keys, out_keyed, links = self._fork_keyed(fn, pos, kw, s_in)
        sfut.set_result(out_keyed)
        await external_controller(self, fn, pos, kw, fresh, keys, links,
                                  dfut, op.callsite, dst=dst)


def run_poppy(poppy_fn, args, kwargs, *, trace=None):
    """Run a compiled @poppy function to completion (blocking entry point)."""
    rt = Runtime(trace=trace)
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(rt.run(poppy_fn, args, kwargs))
    raise PoppyRuntimeError(
        "calling a @poppy function from inside a running event loop; use "
        "`await fn.async_call(...)` instead")


async def run_poppy_async(poppy_fn, args, kwargs, *, trace=None):
    rt = Runtime(trace=trace)
    return await rt.run(poppy_fn, args, kwargs)
