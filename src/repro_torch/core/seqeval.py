"""Sequential λ^O evaluator.

Executes a compiled graph in strict program order with *direct* external
calls — no controllers, no placeholders.  Used when internal code escapes
into external context (e.g. a nested @poppy closure passed as a ``sorted``
key function): sequential execution there is sound, matching the paper's
fallback story (§4.1).
"""

from __future__ import annotations

import builtins as _builtins

from .controllers import unwrap_external
from .errors import ExternalCallError, PoppyRuntimeError
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
)
from .values import check_bound

_SEQ_TOKEN = object()  # stands in for $S; never inspected sequentially


def _resolve_global(lfunc: LFunc, name: str):
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


def _block_inputs(block: LBlock, regs, item=None, carries=None):
    vals = []
    for src in block.input_srcs:
        if isinstance(src, int):
            vals.append(regs[src])
        elif src == ITEM:
            vals.append(item)
        elif src[0] == "carry":
            vals.append(carries[src[1]])
        else:  # pragma: no cover
            raise PoppyRuntimeError(f"bad input src {src}")
    return vals


def run_block_sequential(lfunc: LFunc, block: LBlock, inputs):
    regs = [None] * block.nregs
    for r, v in zip(block.input_regs, inputs):
        regs[r] = v
    for op in block.ops:
        t = type(op)
        if t is LConst:
            regs[op.dst] = op.value
        elif t is LGlobal:
            regs[op.dst] = _resolve_global(lfunc, op.name)
        elif t is LPrim:
            vals = [check_bound(regs[a]) for a in op.args]
            if op.op == "tuple":
                regs[op.dst] = tuple(vals)
            elif op.op == "list":
                regs[op.dst] = list(vals)
            elif op.op == "set":
                regs[op.dst] = set(vals)
            elif op.op == "dict":
                regs[op.dst] = dict(zip(vals[0::2], vals[1::2]))
            elif op.op == "slice":
                regs[op.dst] = slice(*vals)
            elif op.op == "proj":
                regs[op.dst] = vals[0][vals[1]]
            else:  # pragma: no cover
                raise PoppyRuntimeError(f"unknown prim {op.op}")
        elif t is LCallOp:
            fn = check_bound(regs[op.fn])
            vals = [check_bound(regs[a]) for a in op.args]
            if op.unpack:
                pos, kw = list(vals[0]), dict(vals[1])
            else:
                npos = len(vals) - len(op.kwnames)
                pos, kw = vals[:npos], dict(zip(op.kwnames, vals[npos:]))
            if getattr(fn, "__poppy_internal__", False):
                regs[op.dst] = call_internal_sequential(fn, pos, kw)
            else:
                try:
                    regs[op.dst] = unwrap_external(fn)(*pos, **kw)
                except Exception as e:
                    raise ExternalCallError(str(fn), e) from e
            regs[op.s_out] = _SEQ_TOKEN
        elif t is LIte:
            blk = op.then_block if check_bound(regs[op.cond]) else op.else_block
            outs = run_block_sequential(lfunc, blk, _block_inputs(blk, regs))
            for r, v in zip(op.outs, outs):
                regs[r] = v
        elif t is LFor:
            carries = [regs[r] for r in op.init]
            for item in check_bound(regs[op.spine]):
                carries = run_block_sequential(
                    lfunc, op.body,
                    _block_inputs(op.body, regs, item=item, carries=carries))
            for r, v in zip(op.outs, carries):
                regs[r] = v
        elif t is LWhile:
            carries = [regs[r] for r in op.init]
            while True:
                couts = run_block_sequential(
                    lfunc, op.cond_block,
                    _block_inputs(op.cond_block, regs, carries=carries))
                cond, carries = couts[0], couts[1:]
                if not check_bound(cond):
                    break
                carries = run_block_sequential(
                    lfunc, op.body_block,
                    _block_inputs(op.body_block, regs, carries=carries))
            for r, v in zip(op.outs, carries):
                regs[r] = v
        elif t is LClosure:
            from .lambda_o import PoppyClosure
            regs[op.dst] = PoppyClosure(
                op.lfunc, tuple(regs[r] for r in op.captured))
        else:  # pragma: no cover
            raise PoppyRuntimeError(f"unknown op {op!r}")
    return [regs[r] for r in block.outputs]


def call_internal_sequential(fn_obj, pos, kw):
    lf: LFunc = fn_obj.lfunc
    captured = getattr(fn_obj, "captured_vals", ())
    if lf.signature is not None:
        ba = lf.signature.bind(*pos, **kw)
        ba.apply_defaults()
        vals = [ba.arguments[p] for p in lf.params]
    else:
        from .engine import bind_positional
        vals = bind_positional(lf.name, lf.params, pos, kw)
    inputs = vals + list(captured) + [_SEQ_TOKEN]
    outs = run_block_sequential(lf, lf.block, inputs)
    return check_bound(outs[0])
