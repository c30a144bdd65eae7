"""Phase-2 compiler: Bezoar → λ^O (paper §5.2) with the variable-mutation
optimizations of §7.

* **Sequencing**: every call site threads the sequence variable ``$S``
  (implemented as a promoted variable) — ``S1, r1 := print(S0, "bar")`` in
  the paper becomes an ``LCallOp`` with ``s_in``/``s_out`` registers here.
* **Conditionals / loops**: functionalized — each branch/body becomes a
  sub-``LBlock`` whose carried variables (anything stored inside, plus
  ``$S``) are returned and rebound by the ``ite`` / ``fold`` / ``while`` op,
  exactly the paper's Church-encoding with M/S passed through control flow.
* **Single-assignment variables** (§7): loads compile to direct register
  references — no memory object.
* **Local variable promotion** (§7): multi-assigned locals are SSA-promoted;
  an environment maps each variable to its current register, and control
  flow merges via carries.  After promotion the global memory object ``M``
  is empty for the whole supported fragment, so it is elided entirely;
  escaping *mutated* captures — the one case that would need ``M`` — are
  rejected at compile time (paper §7 observes they are rare; the @poppy
  fallback handles them soundly as sequential externals).
"""

from __future__ import annotations

import inspect

from .bezoar import (
    BCall,
    BConst,
    BDefFn,
    BFor,
    BFunc,
    BGlobal,
    BIf,
    BLoad,
    BPrim,
    BReturn,
    BStore,
    BWhile,
)
from .errors import PoppyCompileError
from .lambda_o import (
    CARRY,
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
)
from .values import UNBOUND

_S = "$S"


def _block_call_names(block: LBlock) -> tuple:
    """Statically-known callee names of every call site in ``block``
    (recursing into nested control flow): a call whose callee register is
    defined by an ``LGlobal`` in the same block resolves to that global's
    name.  Callees flowing in as registers (closures, parameters) are not
    representable by name and are simply omitted — the speculation
    heuristic consuming this treats an omitted callee as "unknown", never
    as safe."""
    names: list[str] = []

    def scan(blk: LBlock):
        globals_of = {op.dst: op.name for op in blk.ops
                      if isinstance(op, LGlobal)}
        for op in blk.ops:
            if isinstance(op, LCallOp):
                n = globals_of.get(op.fn)
                if n is not None:
                    names.append(n)
            elif isinstance(op, LIte):
                scan(op.then_block)
                scan(op.else_block)
            elif isinstance(op, LFor):
                scan(op.body)
            elif isinstance(op, LWhile):
                scan(op.cond_block)
                scan(op.body_block)

    scan(block)
    return tuple(names)


def _stored_vars(stmts) -> set[str]:
    """Variables (including $S) whose value may change in these statements."""
    out: set[str] = set()
    for s in stmts:
        if isinstance(s, BStore):
            out.add(s.var)
        elif isinstance(s, BCall):
            out.add(_S)
        elif isinstance(s, BIf):
            out |= _stored_vars(s.then) | _stored_vars(s.orelse)
        elif isinstance(s, BFor):
            out.add(s.item_var)
            out |= _stored_vars(s.body)
        elif isinstance(s, BWhile):
            out |= _stored_vars(s.cond_body) | _stored_vars(s.body)
    return out


def _count_assignments(name: str, stmts, *, in_loop=False) -> int:
    """Textual store count; stores inside loops count twice (multi)."""
    n = 0
    for s in stmts:
        if isinstance(s, BStore) and s.var == name:
            n += 2 if in_loop else 1
        elif isinstance(s, BIf):
            n += max(_count_assignments(name, s.then, in_loop=in_loop),
                     _count_assignments(name, s.orelse, in_loop=in_loop))
        elif isinstance(s, BFor):
            if s.item_var == name:
                n += 2
            n += _count_assignments(name, s.body, in_loop=True)
        elif isinstance(s, BWhile):
            n += _count_assignments(name, s.cond_body, in_loop=True)
            n += _count_assignments(name, s.body, in_loop=True)
    return n


class _BlockLowerer:
    def __init__(self, parent: "_BlockLowerer | None", func: "_FuncLowerer"):
        self.parent = parent
        self.func = func
        self.block = LBlock()
        self.bmap: dict[int, int] = {}   # bezoar reg -> local lreg
        self.env: dict[str, int] = {}    # promoted var -> local lreg

    # -- registers -------------------------------------------------------------

    def newreg(self) -> int:
        r = self.block.nregs
        self.block.nregs += 1
        return r

    def emit(self, op):
        self.block.ops.append(op)

    def add_input(self, src) -> int:
        r = self.newreg()
        self.block.input_srcs.append(src)
        self.block.input_regs.append(r)
        return r

    # -- resolution (with capture-from-parent) ----------------------------------

    def resolve_breg(self, breg: int) -> int:
        if breg in self.bmap:
            return self.bmap[breg]
        if self.parent is None:
            raise PoppyCompileError(f"internal: unresolved bezoar reg {breg}")
        parent_l = self.parent.resolve_breg(breg)
        local = self.add_input(parent_l)
        self.bmap[breg] = local
        return local

    def resolve_var(self, var: str) -> int:
        if var in self.env:
            return self.env[var]
        if self.parent is not None:
            parent_l = self.parent.resolve_var(var)
            local = self.add_input(parent_l)
            self.env[var] = local
            return local
        # function scope: unassigned promoted local → UnboundLocalError value
        r = self.newreg()
        self.emit(LConst(r, UNBOUND))
        self.env[var] = r
        return r

    # -- statement lowering -------------------------------------------------------

    def lower_stmts(self, stmts):
        ret_reg = None
        for s in stmts:
            if isinstance(s, BConst):
                r = self.newreg()
                self.emit(LConst(r, s.value))
                self.bmap[s.dst] = r
            elif isinstance(s, BGlobal):
                r = self.newreg()
                self.emit(LGlobal(r, s.name))
                self.bmap[s.dst] = r
            elif isinstance(s, BLoad):
                self.bmap[s.dst] = self.resolve_var(s.var)
            elif isinstance(s, BStore):
                self.env[s.var] = self.resolve_breg(s.src)
            elif isinstance(s, BPrim):
                r = self.newreg()
                self.emit(LPrim(r, s.op,
                                tuple(self.resolve_breg(a) for a in s.args)))
                self.bmap[s.dst] = r
            elif isinstance(s, BCall):
                fn = self.resolve_breg(s.fn)
                args = tuple(self.resolve_breg(a) for a in s.args)
                s_in = self.resolve_var(_S)
                dst = self.newreg()
                s_out = self.newreg()
                self.emit(LCallOp(dst, s_out, fn, args, tuple(s.kwarg_names),
                                  s_in, fresh=(), callsite=s.callsite,
                                  unpack=s.unpack))
                self.bmap[s.dst] = dst
                self.env[_S] = s_out
            elif isinstance(s, BIf):
                self.lower_if(s)
            elif isinstance(s, BFor):
                self.lower_for(s)
            elif isinstance(s, BWhile):
                self.lower_while(s)
            elif isinstance(s, BDefFn):
                lfunc = self.func.lowerer.lower_bfunc(
                    s.func, self.func.top_pyfunc)
                caps = tuple(self.resolve_var(n) for n in s.captured)
                # §7 single-assignment check for escaping variables
                for n in s.captured:
                    cnt = _count_assignments(n, self.func.bfunc.body)
                    if cnt > 1:
                        raise PoppyCompileError(
                            f"variable {n!r} is captured by nested function "
                            f"{s.func.name!r} but assigned more than once; "
                            "non-local variables must be single-assignment "
                            "(paper §7)")
                r = self.newreg()
                self.emit(LClosure(r, lfunc, caps))
                self.bmap[s.dst] = r
            elif isinstance(s, BReturn):
                ret_reg = self.resolve_breg(s.src)
            else:
                raise PoppyCompileError(f"internal: unknown stmt {s!r}")
        return ret_reg

    def lower_if(self, s: BIf):
        carries = sorted(_stored_vars(s.then) | _stored_vars(s.orelse))
        cond = self.resolve_breg(s.cond)

        def branch(stmts):
            b = _BlockLowerer(self, self.func)
            b.lower_stmts(stmts)
            b.block.outputs = [b.resolve_var(v) for v in carries]
            return b.block

        tb = branch(s.then)
        eb = branch(s.orelse)
        outs = []
        for v in carries:
            r = self.newreg()
            self.env[v] = r
            outs.append(r)
        self.emit(LIte(tuple(outs), cond, tb, eb,
                       then_calls=_block_call_names(tb),
                       else_calls=_block_call_names(eb)))

    def lower_for(self, s: BFor):
        body_vars = _stored_vars(s.body)
        carries = sorted(body_vars | {s.item_var})
        spine = self.resolve_breg(s.iter)
        init = tuple(self.resolve_var(v) for v in carries)

        b = _BlockLowerer(self, self.func)
        for i, v in enumerate(carries):
            b.env[v] = b.add_input(CARRY(i))
        # the item var is rebound from the iterator every iteration,
        # overriding its carried value at body entry
        b.env[s.item_var] = b.add_input(ITEM)
        b.lower_stmts(s.body)
        b.block.outputs = [b.resolve_var(v) for v in carries]

        outs = []
        for v in carries:
            r = self.newreg()
            self.env[v] = r
            outs.append(r)
        self.emit(LFor(tuple(outs), spine, init, b.block))

    def lower_while(self, s: BWhile):
        carries = sorted(_stored_vars(s.cond_body) | _stored_vars(s.body))
        init = tuple(self.resolve_var(v) for v in carries)

        cb = _BlockLowerer(self, self.func)
        for i, v in enumerate(carries):
            cb.env[v] = cb.add_input(CARRY(i))
        cb.lower_stmts(s.cond_body)
        cb.block.outputs = [cb.resolve_breg(s.cond)] + [
            cb.resolve_var(v) for v in carries]

        bb = _BlockLowerer(self, self.func)
        for i, v in enumerate(carries):
            bb.env[v] = bb.add_input(CARRY(i))
        bb.lower_stmts(s.body)
        bb.block.outputs = [bb.resolve_var(v) for v in carries]

        outs = []
        for v in carries:
            r = self.newreg()
            self.env[v] = r
            outs.append(r)
        self.emit(LWhile(tuple(outs), init, cb.block, bb.block))


def _mark_freshness(block: LBlock):
    """Static freshness: a register produced by a mutable-container literal
    (list/set/dict LPrim) consumed by exactly one op is unaliased; external
    classification may treat it as immutable when its contents are
    (paper Fig. 2; DESIGN.md §3).  Recurses into sub-blocks."""
    uses: dict[int, int] = {}

    def use(r):
        uses[r] = uses.get(r, 0) + 1

    for op in block.ops:
        if isinstance(op, LPrim):
            for a in op.args:
                use(a)
        elif isinstance(op, LCallOp):
            use(op.fn)
            use(op.s_in)
            for a in op.args:
                use(a)
        elif isinstance(op, LIte):
            use(op.cond)
            for b in (op.then_block, op.else_block):
                for src in b.input_srcs:
                    if isinstance(src, int):
                        use(src)
        elif isinstance(op, LFor):
            use(op.spine)
            for r in op.init:
                use(r)
            for src in op.body.input_srcs:
                if isinstance(src, int):
                    use(src)
        elif isinstance(op, LWhile):
            for r in op.init:
                use(r)
            for b in (op.cond_block, op.body_block):
                for src in b.input_srcs:
                    if isinstance(src, int):
                        use(src)
        elif isinstance(op, LClosure):
            for r in op.captured:
                use(r)
    for r in block.outputs:
        use(r)

    fresh_regs = {
        op.dst
        for op in block.ops
        if isinstance(op, LPrim) and op.op in ("list", "set", "dict")
        and uses.get(op.dst, 0) == 1
    }
    for op in block.ops:
        if isinstance(op, LCallOp):
            op.fresh = tuple(a in fresh_regs for a in op.args)
        elif isinstance(op, LIte):
            _mark_freshness(op.then_block)
            _mark_freshness(op.else_block)
        elif isinstance(op, LFor):
            _mark_freshness(op.body)
        elif isinstance(op, LWhile):
            _mark_freshness(op.cond_block)
            _mark_freshness(op.body_block)


class _FuncLowerer:
    def __init__(self, bfunc: BFunc, top_pyfunc, lowerer):
        self.bfunc = bfunc
        self.top_pyfunc = top_pyfunc
        self.lowerer = lowerer


class Lowerer:
    """Lowers one Bezoar function into a lambda^O block tree."""

    def __init__(self):
        self._cache: dict[int, LFunc] = {}

    def lower_bfunc(self, bfunc: BFunc, top_pyfunc) -> LFunc:
        key = id(bfunc)
        if key in self._cache:
            return self._cache[key]
        fctx = _FuncLowerer(bfunc, top_pyfunc, self)
        b = _BlockLowerer(None, fctx)
        # inputs: params, captured names, then $S
        for p in bfunc.params:
            b.env[p] = b.add_input(("param", p))
        for c in bfunc.captured_params:
            b.env[c] = b.add_input(("captured", c))
        b.env[_S] = b.add_input(("seq",))
        ret = b.lower_stmts(bfunc.body)
        if ret is None:  # no explicit return
            ret = b.newreg()
            b.emit(LConst(ret, None))
        b.block.outputs = [ret, b.resolve_var(_S)]
        _mark_freshness(b.block)

        pyfunc = bfunc.defaults_from
        sig = None
        if pyfunc is not None:
            try:
                sig = inspect.signature(pyfunc)
            except (ValueError, TypeError):  # pragma: no cover
                sig = None
        # names free in the *Python* function (defined in an enclosing
        # non-@poppy scope) resolve through its closure cells, late-bound
        closure_map = {}
        top_closure = getattr(top_pyfunc, "__closure__", None)
        if top_closure:
            freevars = top_pyfunc.__code__.co_freevars
            closure_map = dict(zip(freevars, top_closure))
        lf = LFunc(
            name=bfunc.name,
            params=list(bfunc.params),
            captured_names=list(bfunc.captured_params),
            block=b.block,
            pyfunc=pyfunc,
            globals_ref=getattr(top_pyfunc, "__globals__", {}),
            signature=sig,
        )
        lf.closure_map = closure_map
        self._cache[key] = lf
        return lf


def lower_function(bfunc: BFunc, pyfunc) -> LFunc:
    return Lowerer().lower_bfunc(bfunc, pyfunc)
