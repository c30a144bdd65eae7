"""λ^O program representation.

λ^O [Mell et al. 2025] is a minimal calculus with confluent *opportunistic*
evaluation.  We realize λ^O programs as single-assignment dataflow graphs:
every Bezoar statement becomes a graph op over immutable registers, control
flow is functionalized into ``ite`` / ``fold`` / recursive-``while`` ops that
expand sub-blocks lazily, and sequencing of external calls is encoded as
data dependencies on sequence variables ``$S`` (paper §5.2).  Confluence —
hence soundness — follows from single-assignment: any execution order of
ready ops produces the same values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Tags for block input sources (resolved by the engine when instantiating):
#   int >= 0          — register of the *parent* block instance
#   ("item",)         — the fold's per-iteration item
#   ("carry", i)      — the i-th loop carry / branch carry
ITEM = ("item",)


def CARRY(i):
    return ("carry", i)


@dataclass
class LBlock:
    """A register block: inputs, ops, outputs - the lambda^O unit of code."""

    nregs: int = 0
    input_srcs: list = field(default_factory=list)  # parallel to input_regs
    input_regs: list[int] = field(default_factory=list)
    ops: list = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)


@dataclass
class LConst:
    """Load a literal constant into a register."""

    dst: int
    value: Any


@dataclass
class LGlobal:
    """Lazily-resolved global / builtin name read."""

    dst: int
    name: str


@dataclass
class LPrim:
    """Internal construction — never an external call, no locks, no trace.

    ops: tuple | list | set | dict | slice | proj
    tuple/list/slice may embed Pending placeholders; set/dict/proj need
    resolved inputs (hashing / projection).
    """

    dst: int
    op: str
    args: tuple


@dataclass
class LCallOp:
    """Call site threading the sequence variable (s_in -> s_out)."""

    dst: int
    s_out: int
    fn: int
    args: tuple            # positional then keyword values
    kwnames: tuple         # names for the trailing len(kwnames) args
    s_in: int
    fresh: tuple           # per-arg static freshness (unaliased literal)
    callsite: str = ""
    # unpack=True — *args/**kwargs call site: ``args`` is exactly
    # (pos-tuple reg, kw-dict reg), spliced by the engine at dispatch
    unpack: bool = False


@dataclass
class LIte:
    """Conditional: both arms lowered as blocks over shared carries."""

    outs: tuple            # dst regs, parallel to each branch's outputs
    cond: int              # bool (or Pending) — frontend inserted py_truth
    then_block: LBlock
    else_block: LBlock
    # Statically-known callee names per arm (global-name call sites,
    # including nested control flow), captured at lowering time.  The
    # engine's branch-speculation heuristic resolves these against the
    # enclosing function's globals to ask "does either arm dispatch an
    # @unordered external worth racing?" without expanding the arms.
    then_calls: tuple = ()
    else_calls: tuple = ()


@dataclass
class LFor:
    """Fold over a snapshot spine with loop-carried registers."""

    outs: tuple
    spine: int             # tuple (or Pending) — frontend inserted iter_spine
    init: tuple            # regs holding initial carry values
    body: LBlock           # inputs: ITEM + CARRY(i)... (+ parent captures)


@dataclass
class LWhile:
    """While-fold: condition block + body block over carries."""

    outs: tuple
    init: tuple
    cond_block: LBlock     # outputs: [cond_reg] + carries-after-cond
    body_block: LBlock     # outputs: carries


@dataclass
class LClosure:
    """Materialize a nested lambda^O function with captured registers."""

    dst: int
    lfunc: "LFunc"
    captured: tuple        # regs in the defining block


@dataclass
class LFunc:
    """A lowered function: parameter/captured names + its root block."""

    name: str
    params: list[str]
    captured_names: list[str]
    block: LBlock          # inputs: params + captured + [$S]; outputs [ret, $S']
    pyfunc: Any = None     # original function (signature defaults, globals)
    globals_ref: dict = None
    signature: Any = None
    closure_map: dict = field(default_factory=dict)  # freevar -> cell

    @property
    def qualname(self):
        return self.name


class PoppyClosure:
    """Runtime closure value for nested internal function definitions.

    Callable from external code (e.g. a ``sorted`` key function): escapes of
    internal code into external context execute *sequentially*, which is
    sound (paper §4.1 fallback semantics).
    """

    __slots__ = ("lfunc", "captured_vals")
    __poppy_internal__ = True

    def __init__(self, lfunc: LFunc, captured_vals: tuple):
        self.lfunc = lfunc
        self.captured_vals = captured_vals

    def __call__(self, *args, **kwargs):
        from .seqeval import call_internal_sequential
        return call_internal_sequential(self, list(args), kwargs)

    def __repr__(self):
        return f"<poppy closure {self.lfunc.name}>"


# ---------------------------------------------------------------------------
# printer (debugging / tests)


def _fmt_block(b: LBlock, indent, lines):
    pad = "  " * indent
    ins = ", ".join(
        f"r{r}<-{s}" for r, s in zip(b.input_regs, b.input_srcs))
    lines.append(f"{pad}block[{ins}] -> {b.outputs}")
    for op in b.ops:
        if isinstance(op, LConst):
            lines.append(f"{pad}  r{op.dst} := const {op.value!r}")
        elif isinstance(op, LGlobal):
            lines.append(f"{pad}  r{op.dst} := global {op.name}")
        elif isinstance(op, LPrim):
            lines.append(f"{pad}  r{op.dst} := {op.op}{op.args}")
        elif isinstance(op, LCallOp):
            lines.append(
                f"{pad}  r{op.dst}, S r{op.s_out} := call r{op.fn}"
                f"{op.args} kw={op.kwnames} S=r{op.s_in} fresh={op.fresh}")
        elif isinstance(op, LIte):
            lines.append(f"{pad}  {op.outs} := ite r{op.cond}")
            _fmt_block(op.then_block, indent + 2, lines)
            _fmt_block(op.else_block, indent + 2, lines)
        elif isinstance(op, LFor):
            lines.append(f"{pad}  {op.outs} := fold r{op.spine} init={op.init}")
            _fmt_block(op.body, indent + 2, lines)
        elif isinstance(op, LWhile):
            lines.append(f"{pad}  {op.outs} := while init={op.init}")
            _fmt_block(op.cond_block, indent + 2, lines)
            _fmt_block(op.body_block, indent + 2, lines)
        elif isinstance(op, LClosure):
            lines.append(
                f"{pad}  r{op.dst} := closure {op.lfunc.name} cap={op.captured}")
        else:
            lines.append(f"{pad}  ? {op!r}")


def format_lfunc(f: LFunc) -> str:
    lines = [f"λO {f.name}({', '.join(f.params)}) captured={f.captured_names}"]
    _fmt_block(f.block, 1, lines)
    return "\n".join(lines)
