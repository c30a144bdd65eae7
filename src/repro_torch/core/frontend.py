"""Phase-1 compiler: Python → Bezoar (paper §5.1).

Three conceptual steps performed in a single AST walk:

  * **Desugaring** — operators → ``py_add``/``py_iadd``/…, attribute access →
    ``py_getattr``, indexing → ``py_getitem``, f-strings → ``py_fstring``,
    ``x in y`` → ``py_contains``, bool-ops/ternaries → short-circuit ``if``
    with a synthetic result variable, method calls fall out of
    ``getattr`` + call.
  * **Variable scope elaboration** — Python's implicit scoping is made
    explicit: every assigned name becomes a declared mutable local with
    ``BLoad``/``BStore``; free names resolve to enclosing compiled scopes
    (captured, checked single-assignment by varopt) or to globals/builtins
    (``BGlobal``, resolved lazily at run time).
  * **A-normalization** — nested expressions unfold into one operation per
    statement, each binding a fresh immutable register.

Anything outside the supported fragment raises ``PoppyCompileError``; the
``@poppy`` decorator falls back to sequential-external execution (paper §4.1).
"""

from __future__ import annotations

import ast
import inspect
import textwrap

from . import stdlib
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
    BStmt,
    BStore,
    BWhile,
)
from .errors import PoppyCompileError

_BINOP = {
    ast.Add: stdlib.py_add,
    ast.Sub: stdlib.py_sub,
    ast.Mult: stdlib.py_mul,
    ast.Div: stdlib.py_truediv,
    ast.FloorDiv: stdlib.py_floordiv,
    ast.Mod: stdlib.py_mod,
    ast.Pow: stdlib.py_pow,
    ast.LShift: stdlib.py_lshift,
    ast.RShift: stdlib.py_rshift,
    ast.BitOr: stdlib.py_or,
    ast.BitXor: stdlib.py_xor,
    ast.BitAnd: stdlib.py_and,
    ast.MatMult: stdlib.py_matmul,
}

_IBINOP = {
    ast.Add: stdlib.py_iadd,
    ast.Sub: stdlib.py_isub,
    ast.Mult: stdlib.py_imul,
    ast.Div: stdlib.py_itruediv,
    ast.FloorDiv: stdlib.py_ifloordiv,
    ast.Mod: stdlib.py_imod,
    ast.Pow: stdlib.py_ipow,
    ast.LShift: stdlib.py_ilshift,
    ast.RShift: stdlib.py_irshift,
    ast.BitOr: stdlib.py_ior,
    ast.BitXor: stdlib.py_ixor,
    ast.BitAnd: stdlib.py_iand,
    ast.MatMult: stdlib.py_imatmul,
}

_UNARYOP = {
    ast.USub: stdlib.py_neg,
    ast.UAdd: stdlib.py_pos,
    ast.Invert: stdlib.py_invert,
    ast.Not: stdlib.py_not,
}

_CMPOP = {
    ast.Eq: stdlib.py_eq,
    ast.NotEq: stdlib.py_ne,
    ast.Lt: stdlib.py_lt,
    ast.LtE: stdlib.py_le,
    ast.Gt: stdlib.py_gt,
    ast.GtE: stdlib.py_ge,
    ast.Is: stdlib.py_is,
    ast.IsNot: stdlib.py_is_not,
}


def _assigned_names(node) -> set[str]:
    """Names assigned anywhere in a function body (Python's local-scope
    rule), *not* descending into nested function definitions."""
    names: set[str] = set()

    def tgt(t):
        if isinstance(t, ast.Name):
            names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                tgt(e)
        # Attribute / Subscript targets mutate objects, not the scope.

    def walk(stmts):
        for s in stmts:
            if isinstance(s, ast.Assign):
                for t in s.targets:
                    tgt(t)
            elif isinstance(s, (ast.AugAssign, ast.AnnAssign)):
                tgt(s.target)
            elif isinstance(s, ast.For):
                tgt(s.target)
                walk(s.body)
                walk(s.orelse)
            elif isinstance(s, ast.While):
                walk(s.body)
                walk(s.orelse)
            elif isinstance(s, ast.If):
                walk(s.body)
                walk(s.orelse)
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(s.name)
            elif isinstance(s, (ast.Global, ast.Nonlocal)):
                raise PoppyCompileError(
                    f"'{type(s).__name__.lower()}' declarations are not "
                    "supported in internal code", s)
    walk(node)
    return names


class _FuncCompiler:
    """Compiles one ``def`` (plus nested defs, recursively)."""

    def __init__(self, name, args_node, body, *, parent, source_file, lineno,
                 defaults_from=None):
        if args_node.vararg or args_node.kwarg:
            raise PoppyCompileError(
                "*args/**kwargs are not supported in internal code", args_node)
        self.name = name
        self.params = [a.arg for a in args_node.posonlyargs] + \
                      [a.arg for a in args_node.args] + \
                      [a.arg for a in args_node.kwonlyargs]
        self.parent = parent
        self.source_file = source_file
        self.lineno = lineno
        self.defaults_from = defaults_from
        self.locals = set(self.params) | _assigned_names(body)
        self.captured: list[str] = []   # free names found in enclosing scopes
        self.nreg = 0
        self.synth = 0
        self.body_ast = body

    # -- register / synthetic-variable helpers ------------------------------

    def reg(self) -> int:
        r = self.nreg
        self.nreg += 1
        return r

    def synth_var(self) -> str:
        self.synth += 1
        name = f"$t{self.synth}"
        self.locals.add(name)
        return name

    def callsite(self, node) -> str:
        return f"{self.source_file}:{getattr(node, 'lineno', 0)}"

    # -- name resolution -----------------------------------------------------

    def resolve_name(self, name: str, out: list[BStmt], node) -> int:
        if name in self.locals:
            r = self.reg()
            out.append(BLoad(r, name, lineno=node.lineno))
            return r
        # search enclosing compiled scopes → capture (threading the capture
        # through every intermediate scope so multi-level nesting works)
        chain = [self]
        p = self.parent
        while p is not None:
            if name in p.locals:
                for s in chain:
                    if name not in s.captured:
                        s.captured.append(name)
                    s.locals.add(name)  # behaves like a pre-bound local
                r = self.reg()
                out.append(BLoad(r, name, lineno=node.lineno))
                return r
            chain.append(p)
            p = p.parent
        r = self.reg()
        out.append(BGlobal(r, name, lineno=node.lineno))
        return r

    def intrinsic(self, fn, out: list[BStmt], node) -> int:
        r = self.reg()
        out.append(BConst(r, fn, lineno=getattr(node, "lineno", 0)))
        return r

    def const(self, v, out, node) -> int:
        r = self.reg()
        out.append(BConst(r, v, lineno=getattr(node, "lineno", 0)))
        return r

    def call(self, fn_reg, args, out, node, kwarg_names=()) -> int:
        r = self.reg()
        out.append(BCall(r, fn_reg, list(args), list(kwarg_names),
                         callsite=self.callsite(node),
                         lineno=getattr(node, "lineno", 0)))
        return r

    def call_intrinsic(self, fn, args, out, node) -> int:
        return self.call(self.intrinsic(fn, out, node), args, out, node)

    # -- expressions ----------------------------------------------------------

    def expr(self, e, out: list[BStmt]) -> int:
        if isinstance(e, ast.Constant):
            return self.const(e.value, out, e)
        if isinstance(e, ast.Name):
            return self.resolve_name(e.id, out, e)
        if isinstance(e, ast.Tuple):
            regs = [self.expr(x, out) for x in e.elts]
            r = self.reg()
            out.append(BPrim(r, "tuple", regs, lineno=e.lineno))
            return r
        if isinstance(e, ast.List):
            regs = [self.expr(x, out) for x in e.elts]
            r = self.reg()
            out.append(BPrim(r, "list", regs, lineno=e.lineno))
            return r
        if isinstance(e, ast.Set):
            regs = [self.expr(x, out) for x in e.elts]
            r = self.reg()
            out.append(BPrim(r, "set", regs, lineno=e.lineno))
            return r
        if isinstance(e, ast.Dict):
            regs = []
            for k, v in zip(e.keys, e.values):
                if k is None:
                    raise PoppyCompileError("dict ** unpacking unsupported", e)
                regs.append(self.expr(k, out))
                regs.append(self.expr(v, out))
            r = self.reg()
            out.append(BPrim(r, "dict", regs, lineno=e.lineno))
            return r
        if isinstance(e, ast.BinOp):
            op = _BINOP.get(type(e.op))
            if op is None:
                raise PoppyCompileError(f"operator {e.op} unsupported", e)
            a = self.expr(e.left, out)
            b = self.expr(e.right, out)
            return self.call_intrinsic(op, [a, b], out, e)
        if isinstance(e, ast.UnaryOp):
            op = _UNARYOP.get(type(e.op))
            if op is None:
                raise PoppyCompileError(f"unary {e.op} unsupported", e)
            a = self.expr(e.operand, out)
            return self.call_intrinsic(op, [a], out, e)
        if isinstance(e, ast.Compare):
            return self.compare(e, out)
        if isinstance(e, ast.BoolOp):
            return self.boolop(e, out)
        if isinstance(e, ast.IfExp):
            return self.ifexp(e, out)
        if isinstance(e, ast.Call):
            return self.call_expr(e, out)
        if isinstance(e, ast.Attribute):
            o = self.expr(e.value, out)
            n = self.const(e.attr, out, e)
            return self.call_intrinsic(stdlib.py_getattr, [o, n], out, e)
        if isinstance(e, ast.Subscript):
            o = self.expr(e.value, out)
            i = self.subscript_index(e.slice, out)
            return self.call_intrinsic(stdlib.py_getitem, [o, i], out, e)
        if isinstance(e, ast.JoinedStr):
            return self.fstring(e, out)
        if isinstance(e, ast.Lambda):
            return self.nested_def(
                f"<lambda:{e.lineno}>", e.args,
                [ast.Return(value=e.body, lineno=e.lineno, col_offset=0)],
                e, out)
        if isinstance(e, ast.Starred):
            raise PoppyCompileError("* unpacking unsupported", e)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.GeneratorExp)):
            return self.comprehension(e, out)
        if isinstance(e, ast.NamedExpr):
            # walrus: value is assigned and also the expression result
            r = self.expr(e.value, out)
            if not isinstance(e.target, ast.Name):
                raise PoppyCompileError("complex walrus target", e)
            out.append(BStore(e.target.id, r, lineno=e.lineno))
            self.locals.add(e.target.id)
            return r
        raise PoppyCompileError(f"unsupported expression {type(e).__name__}", e)

    def subscript_index(self, sl, out) -> int:
        if isinstance(sl, ast.Slice):
            lo = self.expr(sl.lower, out) if sl.lower else self.const(None, out, sl)
            hi = self.expr(sl.upper, out) if sl.upper else self.const(None, out, sl)
            st = self.expr(sl.step, out) if sl.step else self.const(None, out, sl)
            r = self.reg()
            out.append(BPrim(r, "slice", [lo, hi, st],
                             lineno=getattr(sl, "lineno", 0)))
            return r
        return self.expr(sl, out)

    def call_expr(self, e: ast.Call, out) -> int:
        fn = self.expr(e.func, out)
        if any(isinstance(a, ast.Starred) for a in e.args) or \
                any(kw.arg is None for kw in e.keywords):
            return self.unpacked_call(fn, e, out)
        args = []
        for a in e.args:
            args.append(self.expr(a, out))
        kwnames = []
        for kw in e.keywords:
            kwnames.append(kw.arg)
            args.append(self.expr(kw.value, out))
        return self.call(fn, args, out, e, kwarg_names=kwnames)

    def unpacked_call(self, fn, e: ast.Call, out) -> int:
        """Call site with ``*args``/``**kwargs``: build one positional
        tuple and one keyword dict (CPython's left-to-right evaluation
        order), then emit a ``BCall(unpack=True)`` that the engine splices
        at dispatch.  Starred segments snapshot through ``iter_spine``
        (same read classification as a ``for`` spine); ``**m`` goes
        through ``py_kwargs`` (string-key validation) and segments merge
        via ``py_kw_merge`` (CPython's duplicate-keyword TypeError)."""
        seg_regs = []
        plain: list[int] = []

        def flush_plain():
            if plain:
                r = self.reg()
                out.append(BPrim(r, "tuple", list(plain), lineno=e.lineno))
                seg_regs.append(r)
                plain.clear()

        for a in e.args:
            if isinstance(a, ast.Starred):
                flush_plain()
                v = self.expr(a.value, out)
                seg_regs.append(
                    self.call_intrinsic(stdlib.iter_spine, [v], out, e))
            else:
                plain.append(self.expr(a, out))
        flush_plain()
        if not seg_regs:
            pos_reg = self.const((), out, e)
        else:
            pos_reg = seg_regs[0]
            for s in seg_regs[1:]:
                pos_reg = self.call_intrinsic(
                    stdlib.py_add, [pos_reg, s], out, e)

        kseg_regs = []
        pairs: list[int] = []

        def flush_pairs():
            if pairs:
                r = self.reg()
                out.append(BPrim(r, "dict", list(pairs), lineno=e.lineno))
                kseg_regs.append(r)
                pairs.clear()

        for kw in e.keywords:
            if kw.arg is None:
                flush_pairs()
                m = self.expr(kw.value, out)
                kseg_regs.append(
                    self.call_intrinsic(stdlib.py_kwargs, [m], out, e))
            else:
                pairs.append(self.const(kw.arg, out, e))
                pairs.append(self.expr(kw.value, out))
        flush_pairs()
        if not kseg_regs:
            kw_reg = self.reg()
            out.append(BPrim(kw_reg, "dict", [], lineno=e.lineno))
        else:
            kw_reg = kseg_regs[0]
            for s in kseg_regs[1:]:
                kw_reg = self.call_intrinsic(
                    stdlib.py_kw_merge, [kw_reg, s], out, e)

        r = self.reg()
        out.append(BCall(r, fn, [pos_reg, kw_reg], [],
                         callsite=self.callsite(e),
                         lineno=getattr(e, "lineno", 0), unpack=True))
        return r

    def truth(self, reg, out, node) -> int:
        return self.call_intrinsic(stdlib.py_truth, [reg], out, node)

    def shortcircuit(self, cond_bool_reg, then_build, else_build, out, node) -> int:
        """ite with a result: store into a synthetic promoted variable."""
        tvar = self.synth_var()
        then_stmts: list[BStmt] = []
        r1 = then_build(then_stmts)
        then_stmts.append(BStore(tvar, r1, lineno=node.lineno))
        else_stmts: list[BStmt] = []
        r2 = else_build(else_stmts)
        else_stmts.append(BStore(tvar, r2, lineno=node.lineno))
        out.append(BIf(cond_bool_reg, then_stmts, else_stmts, lineno=node.lineno))
        r = self.reg()
        out.append(BLoad(r, tvar, lineno=node.lineno))
        return r

    def boolop(self, e: ast.BoolOp, out) -> int:
        def build(values, out):
            head = self.expr(values[0], out)
            if len(values) == 1:
                return head
            c = self.truth(head, out, e)
            if isinstance(e.op, ast.And):
                return self.shortcircuit(
                    c,
                    lambda o: build(values[1:], o),
                    lambda o: head,
                    out, e)
            return self.shortcircuit(
                c,
                lambda o: head,
                lambda o: build(values[1:], o),
                out, e)
        return build(e.values, out)

    def ifexp(self, e: ast.IfExp, out) -> int:
        c = self.truth(self.expr(e.test, out), out, e)
        return self.shortcircuit(
            c, lambda o: self.expr(e.body, o), lambda o: self.expr(e.orelse, o),
            out, e)

    def compare(self, e: ast.Compare, out) -> int:
        def one(op, l, r, out):
            t = type(op)
            if t in _CMPOP:
                return self.call_intrinsic(_CMPOP[t], [l, r], out, e)
            if t is ast.In:
                return self.call_intrinsic(stdlib.py_contains, [r, l], out, e)
            if t is ast.NotIn:
                return self.call_intrinsic(stdlib.py_not_contains, [r, l], out, e)
            raise PoppyCompileError(f"comparison {op} unsupported", e)

        left = self.expr(e.left, out)
        if len(e.ops) == 1:
            return one(e.ops[0], left, self.expr(e.comparators[0], out), out)
        # chained: a < b < c  →  (a<b) and (b<c), b evaluated once
        rights = [self.expr(c, out) for c in e.comparators]

        def chain(i, l, out):
            r = one(e.ops[i], l, rights[i], out)
            if i == len(e.ops) - 1:
                return r
            c = self.truth(r, out, e)
            return self.shortcircuit(
                c, lambda o: chain(i + 1, rights[i], o), lambda o: r, out, e)
        return chain(0, left, out)

    def fstring(self, e: ast.JoinedStr, out) -> int:
        spec_parts = []
        value_regs = []
        for part in e.values:
            if isinstance(part, ast.Constant):
                spec_parts.append(("s", part.value))
            elif isinstance(part, ast.FormattedValue):
                conv = chr(part.conversion) if part.conversion != -1 else ""
                if part.format_spec is None:
                    fmt = ""
                elif (isinstance(part.format_spec, ast.JoinedStr)
                      and all(isinstance(v, ast.Constant)
                              for v in part.format_spec.values)):
                    fmt = "".join(v.value for v in part.format_spec.values)
                else:
                    raise PoppyCompileError("dynamic format specs unsupported", e)
                spec_parts.append(("v", conv, fmt))
                value_regs.append(self.expr(part.value, out))
            else:
                raise PoppyCompileError("unsupported f-string part", e)
        spec = self.const(tuple(spec_parts), out, e)
        return self.call_intrinsic(stdlib.py_fstring, [spec] + value_regs, out, e)

    def comprehension(self, e, out) -> int:
        """Desugar comprehensions into a loop over a synthetic accumulator.

        ``[f(x) for x in xs if p(x)]`` becomes::

            $acc = ()                    # tuple accumulator (immutable → parallel)
            for $x in xs:
                if p($x): $acc = py_iadd($acc, (f($x),))
            list($acc)                   # materialize the display type

        Using a *tuple* accumulator keeps the appends @unordered, preserving
        the paper's parallelism for the common produce-in-a-loop idiom.
        """
        if isinstance(e, ast.GeneratorExp):
            # evaluated eagerly — acceptable within the fragment (documented)
            pass
        gens = e.generators
        if any(g.is_async for g in gens):
            raise PoppyCompileError("async comprehensions unsupported", e)
        acc = self.synth_var()
        z = self.reg()
        out.append(BConst(z, (), lineno=e.lineno))
        out.append(BStore(acc, z, lineno=e.lineno))

        def emit_level(i, out_stmts):
            if i == len(gens):
                cur = self.reg()
                out_stmts.append(BLoad(cur, acc, lineno=e.lineno))
                if isinstance(e, ast.DictComp):
                    k = self.expr(e.key, out_stmts)
                    v = self.expr(e.value, out_stmts)
                    item = self.reg()
                    out_stmts.append(BPrim(item, "tuple", [k, v], lineno=e.lineno))
                else:
                    item = self.expr(e.elt, out_stmts)
                wrapped = self.reg()
                out_stmts.append(BPrim(wrapped, "tuple", [item], lineno=e.lineno))
                r = self.call_intrinsic(stdlib.py_iadd, [cur, wrapped],
                                        out_stmts, e)
                out_stmts.append(BStore(acc, r, lineno=e.lineno))
                return
            g = gens[i]
            it = self.expr(g.iter, out_stmts)
            spine = self.call_intrinsic(stdlib.iter_spine, [it], out_stmts, e)
            body: list[BStmt] = []
            ivar = self.bind_target_var(g.target, body, e)
            inner: list[BStmt] = body
            for cond in g.ifs:
                c = self.truth(self.expr(cond, inner), inner, e)
                blk: list[BStmt] = []
                inner.append(BIf(c, blk, [], lineno=e.lineno))
                inner = blk
            emit_level(i + 1, inner)
            out_stmts.append(BFor(ivar, spine, body, lineno=e.lineno))

        emit_level(0, out)
        fin = self.reg()
        out.append(BLoad(fin, acc, lineno=e.lineno))
        if isinstance(e, ast.ListComp):
            return self.call_intrinsic(stdlib.py_to_list, [fin], out, e)
        if isinstance(e, ast.SetComp):
            return self.call_intrinsic(stdlib.py_to_set, [fin], out, e)
        if isinstance(e, ast.DictComp):
            return self.call_intrinsic(stdlib.py_to_dict, [fin], out, e)
        return fin  # GeneratorExp → tuple (eager; spine-iterable)

    def bind_target_var(self, target, body: list[BStmt], node) -> str:
        """For-loop / comprehension target: returns the item var name and
        appends unpack statements for tuple targets into the body head."""
        if isinstance(target, ast.Name):
            self.locals.add(target.id)
            return target.id
        if isinstance(target, (ast.Tuple, ast.List)):
            item = self.synth_var()
            self.unpack_into(target, item, body, node)
            return item
        raise PoppyCompileError("unsupported loop target", node)

    def unpack_into(self, target, item_var: str, out: list[BStmt], node):
        elts = target.elts
        if any(isinstance(t, ast.Starred) for t in elts):
            raise PoppyCompileError("starred unpacking unsupported", node)
        src = self.reg()
        out.append(BLoad(src, item_var, lineno=node.lineno))
        unpacked = self.call_intrinsic(
            stdlib.py_unpack,
            [src, self.const(len(elts), out, node)], out, node)
        for i, t in enumerate(elts):
            r = self.reg()
            idx = self.const(i, out, node)
            out.append(BPrim(r, "proj", [unpacked, idx], lineno=node.lineno))
            self.assign_target(t, r, out, node)

    def assign_target(self, t, src_reg, out: list[BStmt], node):
        if isinstance(t, ast.Name):
            self.locals.add(t.id)
            out.append(BStore(t.id, src_reg, lineno=node.lineno))
        elif isinstance(t, ast.Attribute):
            o = self.expr(t.value, out)
            n = self.const(t.attr, out, node)
            self.call_intrinsic(stdlib.py_setattr, [o, n, src_reg], out, node)
        elif isinstance(t, ast.Subscript):
            o = self.expr(t.value, out)
            i = self.subscript_index(t.slice, out)
            self.call_intrinsic(stdlib.py_setitem, [o, i, src_reg], out, node)
        elif isinstance(t, (ast.Tuple, ast.List)):
            tmp = self.synth_var()
            out.append(BStore(tmp, src_reg, lineno=node.lineno))
            self.unpack_into(t, tmp, out, node)
        else:
            raise PoppyCompileError("unsupported assignment target", node)

    # -- statements ------------------------------------------------------------

    def stmts(self, body, out: list[BStmt], *, toplevel=False):
        n = len(body)
        for i, s in enumerate(body):
            last = toplevel and i == n - 1
            if isinstance(s, ast.Return):
                if not last:
                    raise PoppyCompileError(
                        "return is only supported as the final statement of an "
                        "internal function (paper §4.1)", s)
                r = self.expr(s.value, out) if s.value else self.const(None, out, s)
                out.append(BReturn(r, lineno=s.lineno))
            elif isinstance(s, ast.Assign):
                r = self.expr(s.value, out)
                for t in s.targets:
                    self.assign_target(t, r, out, s)
            elif isinstance(s, ast.AnnAssign):
                if s.value is not None:
                    r = self.expr(s.value, out)
                    self.assign_target(s.target, r, out, s)
            elif isinstance(s, ast.AugAssign):
                op = _IBINOP.get(type(s.op))
                if op is None:
                    raise PoppyCompileError(f"augmented {s.op} unsupported", s)
                t = s.target
                if isinstance(t, ast.Name):
                    cur = self.resolve_name(t.id, out, s)
                    rhs = self.expr(s.value, out)
                    r = self.call_intrinsic(op, [cur, rhs], out, s)
                    self.locals.add(t.id)
                    out.append(BStore(t.id, r, lineno=s.lineno))
                elif isinstance(t, ast.Attribute):
                    obj_r = self.expr(t.value, out)
                    name_r = self.const(t.attr, out, s)
                    cur = self.call_intrinsic(
                        stdlib.py_getattr, [obj_r, name_r], out, s)
                    rhs = self.expr(s.value, out)
                    r = self.call_intrinsic(op, [cur, rhs], out, s)
                    self.call_intrinsic(
                        stdlib.py_setattr, [obj_r, name_r, r], out, s)
                elif isinstance(t, ast.Subscript):
                    obj_r = self.expr(t.value, out)
                    idx_r = self.subscript_index(t.slice, out)
                    cur = self.call_intrinsic(
                        stdlib.py_getitem, [obj_r, idx_r], out, s)
                    rhs = self.expr(s.value, out)
                    r = self.call_intrinsic(op, [cur, rhs], out, s)
                    self.call_intrinsic(
                        stdlib.py_setitem, [obj_r, idx_r, r], out, s)
                else:
                    raise PoppyCompileError("unsupported augassign target", s)
            elif isinstance(s, ast.Expr):
                if isinstance(s.value, ast.Constant):  # docstring / bare const
                    continue
                self.expr(s.value, out)
            elif isinstance(s, ast.If):
                c = self.truth(self.expr(s.test, out), out, s)
                then: list[BStmt] = []
                self.stmts(s.body, then)
                orelse: list[BStmt] = []
                self.stmts(s.orelse, orelse)
                out.append(BIf(c, then, orelse, lineno=s.lineno))
            elif isinstance(s, ast.For):
                if s.orelse:
                    raise PoppyCompileError("for-else unsupported", s)
                it = self.expr(s.iter, out)
                spine = self.call_intrinsic(stdlib.iter_spine, [it], out, s)
                body: list[BStmt] = []
                ivar = self.bind_target_var(s.target, body, s)
                self.stmts(s.body, body)
                out.append(BFor(ivar, spine, body, lineno=s.lineno))
            elif isinstance(s, ast.While):
                if s.orelse:
                    raise PoppyCompileError("while-else unsupported", s)
                cond_body: list[BStmt] = []
                c = self.truth(self.expr(s.test, cond_body), cond_body, s)
                body: list[BStmt] = []
                self.stmts(s.body, body)
                out.append(BWhile(cond_body, c, body, lineno=s.lineno))
            elif isinstance(s, ast.FunctionDef):
                r = self.nested_def(s.name, s.args, s.body, s, out)
                self.locals.add(s.name)
                out.append(BStore(s.name, r, lineno=s.lineno))
            elif isinstance(s, ast.Pass):
                continue
            elif isinstance(s, (ast.Break, ast.Continue)):
                raise PoppyCompileError(
                    f"'{type(s).__name__.lower()}' causes non-local control "
                    "flow and is not supported in internal code (paper §4.1)", s)
            elif isinstance(s, (ast.Try, ast.Raise, ast.With, ast.Match,
                                ast.Delete, ast.Import, ast.ImportFrom,
                                ast.AsyncFunctionDef, ast.Assert)):
                raise PoppyCompileError(
                    f"{type(s).__name__} is not supported in internal code", s)
            else:
                raise PoppyCompileError(
                    f"unsupported statement {type(s).__name__}", s)

    def nested_def(self, name, args_node, body, node, out) -> int:
        sub = _FuncCompiler(name, args_node, body, parent=self,
                            source_file=self.source_file,
                            lineno=getattr(node, "lineno", 0))
        bfunc = sub.compile()
        r = self.reg()
        out.append(BDefFn(r, bfunc, list(sub.captured),
                          lineno=getattr(node, "lineno", 0)))
        return r

    def compile(self) -> BFunc:
        out: list[BStmt] = []
        self.stmts(self.body_ast, out, toplevel=True)
        if not out or not isinstance(out[-1], BReturn):
            r = self.reg()
            out.append(BConst(r, None))
            out.append(BReturn(r))
        return BFunc(
            name=self.name,
            params=list(self.params),
            defaults_from=self.defaults_from,
            body=out,
            nregs=self.nreg,
            mutable_vars=sorted(self.locals),
            captured_params=list(self.captured),
            source_file=self.source_file,
            lineno=self.lineno,
        )


def compile_function(fn) -> BFunc:
    """Compile a Python function object to Bezoar."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError) as e:  # pragma: no cover
        raise PoppyCompileError(f"cannot fetch source for {fn!r}: {e}")
    src = textwrap.dedent(src)
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise PoppyCompileError("@poppy must decorate a def", fdef)
    if isinstance(fdef, ast.AsyncFunctionDef):
        raise PoppyCompileError(
            "internal (@poppy) functions must be synchronous; async belongs "
            "to external code", fdef)
    fc = _FuncCompiler(
        fdef.name, fdef.args, fdef.body, parent=None,
        source_file=getattr(fn, "__code__", None) and fn.__code__.co_filename
        or "<unknown>",
        lineno=getattr(fn, "__code__", None) and fn.__code__.co_firstlineno or 0,
        defaults_from=fn)
    if fc.captured:
        raise PoppyCompileError(
            f"top-level @poppy function captures {fc.captured}")
    bf = fc.compile()
    return bf
