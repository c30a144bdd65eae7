"""Bezoar — PopPy's intermediate representation (paper §5).

Bezoar sits between Python and λ^O.  Like Python it is *sequential* and has
*mutable variables*; like λ^O it is minimal and explicit:

  * A-normal form — no nested expressions; every operation is a separate
    statement binding an immutable register ``r{n}``.
  * Explicit scoping — every local variable access is an explicit
    ``BLoad`` / ``BStore`` on a declared mutable variable; global/builtin
    reads are explicit ``BGlobal``.
  * Minimal constructs — ``if``, ``for``, ``while``, function definition,
    call, return-at-end.  Everything else (operators, attribute access,
    indexing, f-strings, bool ops) has been desugared into calls.

The printer (``format_func``) exists so tests and users can inspect the IR.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

Reg = int


@dataclass
class BStmt:
    """Base of all Bezoar statements (carries the source line)."""

    lineno: int = field(default=0, kw_only=True)


@dataclass
class BConst(BStmt):
    """Load a literal constant into a register."""

    dst: Reg
    value: Any


@dataclass
class BGlobal(BStmt):
    """Read a global / builtin name.

    Resolved lazily against the source function's ``__globals__`` — the
    single-assignment-library-function assumption of paper §7 (reassigning
    e.g. ``print`` mid-run is not supported, which avoids serializing every
    call site on a memory load).
    """

    dst: Reg
    name: str


@dataclass
class BLoad(BStmt):
    """Read a mutable local variable into a register."""

    dst: Reg
    var: str


@dataclass
class BStore(BStmt):
    """Assign a register to a mutable local variable."""

    var: str
    src: Reg


@dataclass
class BCall(BStmt):
    """Call (external or internal) - the unit the engine parallelizes."""

    dst: Reg
    fn: Reg
    args: list[Reg]
    kwarg_names: list[str]  # names for the trailing len(kwarg_names) args
    callsite: str = ""      # "file:line fn-ish" for traces
    # unpack=True — a call site with *args/**kwargs: ``args`` is exactly
    # [positional-tuple reg, keyword-dict reg] (built by the frontend) and
    # the engine splices them at dispatch.
    unpack: bool = False


@dataclass
class BPrim(BStmt):
    """Pure internal construction: never an external call.

    ops: tuple, list, set, dict (args = k0,v0,k1,v1...), slice (a,b,c).
    tuple/list/slice may embed unresolved placeholders; set/dict need
    resolved elements (hashing).
    """

    dst: Reg
    op: str
    args: list[Reg]


@dataclass
class BIf(BStmt):
    """Conditional on a boolean register."""

    cond: Reg  # register holding a *bool* (frontend inserts py_truth)
    then: list[BStmt]
    orelse: list[BStmt]


@dataclass
class BFor(BStmt):
    """``for`` over a snapshot spine of the iterable."""

    item_var: str  # mutable var assigned each iteration (tuple targets pre-desugared)
    iter: Reg      # register holding the snapshot spine (frontend inserts iter_spine)
    body: list[BStmt]


@dataclass
class BWhile(BStmt):
    """``while`` with a re-evaluated condition block."""

    cond_body: list[BStmt]  # re-evaluated every iteration
    cond: Reg               # bool register defined by cond_body
    body: list[BStmt]


@dataclass
class BReturn(BStmt):
    """Return a register's value from the enclosing function."""

    src: Reg


@dataclass
class BDefFn(BStmt):
    """Define a nested function, capturing enclosing names by value."""

    dst: Reg
    func: "BFunc"
    # enclosing-scope names captured by the nested function, read from the
    # defining scope at definition time.  varopt verifies these are
    # single-assignment (paper §7: non-local ⇒ assigned-once).
    captured: list[str]


@dataclass
class BFunc:
    """A whole compiled function: parameters, body, register count."""

    name: str
    params: list[str]
    defaults_from: Any  # the original Python function (for defaults/globals)
    body: list[BStmt]
    nregs: int
    mutable_vars: list[str]
    captured_params: list[str]  # names this (nested) function captures
    source_file: str = ""
    lineno: int = 0


# ---------------------------------------------------------------------------
# printer


def _fmt_block(stmts: list[BStmt], indent: int, lines: list[str]):
    pad = "  " * indent
    for s in stmts:
        if isinstance(s, BConst):
            lines.append(f"{pad}r{s.dst} := const {s.value!r}")
        elif isinstance(s, BGlobal):
            lines.append(f"{pad}r{s.dst} := global {s.name}")
        elif isinstance(s, BLoad):
            lines.append(f"{pad}r{s.dst} := load {s.var}")
        elif isinstance(s, BStore):
            lines.append(f"{pad}store {s.var} r{s.src}")
        elif isinstance(s, BCall):
            pos = s.args[: len(s.args) - len(s.kwarg_names)]
            kw = s.args[len(s.args) - len(s.kwarg_names):]
            a = ", ".join([f"r{r}" for r in pos])
            if kw:
                a += ", " + ", ".join(
                    f"{n}=r{r}" for n, r in zip(s.kwarg_names, kw)
                )
            lines.append(f"{pad}r{s.dst} := r{s.fn}({a})")
        elif isinstance(s, BPrim):
            a = ", ".join(f"r{r}" for r in s.args)
            lines.append(f"{pad}r{s.dst} := {s.op}({a})")
        elif isinstance(s, BIf):
            lines.append(f"{pad}if r{s.cond}:")
            _fmt_block(s.then, indent + 1, lines)
            if s.orelse:
                lines.append(f"{pad}else:")
                _fmt_block(s.orelse, indent + 1, lines)
        elif isinstance(s, BFor):
            lines.append(f"{pad}for {s.item_var} in r{s.iter}:")
            _fmt_block(s.body, indent + 1, lines)
        elif isinstance(s, BWhile):
            lines.append(f"{pad}while:")
            lines.append(f"{pad}  cond:")
            _fmt_block(s.cond_body, indent + 2, lines)
            lines.append(f"{pad}  -> r{s.cond}; body:")
            _fmt_block(s.body, indent + 2, lines)
        elif isinstance(s, BReturn):
            lines.append(f"{pad}return r{s.src}")
        elif isinstance(s, BDefFn):
            cap = f" captures {s.captured}" if s.captured else ""
            lines.append(f"{pad}r{s.dst} := def {s.func.name}{cap}")
            _fmt_block(s.func.body, indent + 1, lines)
        else:
            lines.append(f"{pad}<? {s!r}>")


def format_func(f: BFunc) -> str:
    lines = [f"bezoar {f.name}({', '.join(f.params)})  "
             f"[mutable: {', '.join(f.mutable_vars) or '-'}]"]
    _fmt_block(f.body, 1, lines)
    return "\n".join(lines)
