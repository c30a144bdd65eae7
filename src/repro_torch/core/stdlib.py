"""PopPy standard-library intrinsics.

The frontend desugars every Python operator, attribute access, index access,
f-string, truth test and loop-iteration into a call to one of these
functions.  Each carries a *dynamic* reordering classifier (paper §6.1):
the concurrency controller consults it at runtime once argument types are
known, solving the dynamic-dispatch problem (``+=`` on tuple vs list).
"""

from __future__ import annotations

import operator as _op

from .registry import (
    ExternalInfo,
    _effects_obj,
    _effects_obj_attr,
    classify_binary,
    classify_inplace,
    classify_iter_spine,
    classify_read,
    classify_unordered,
    classify_write,
)


def _intrinsic(classify, name=None, effects=None, imm_result=False):
    # offload="inline": intrinsics are interpreter-level work (an add, an
    # index) — a thread round-trip would cost orders of magnitude more than
    # the operation itself, so they always execute on the loop thread.
    #
    # effects=_effects_obj keys object-touching intrinsics to the target's
    # *identity domain* (DESIGN.md §2.2): a ``d[k] = v`` on one local dict
    # orders with other reads/writes of that same dict, not with unrelated
    # sequential externals.
    def deco(fn):
        fn.__poppy_external__ = ExternalInfo(
            classify=classify, name=name or fn.__name__, offload="inline",
            effects=effects, imm_result=imm_result)
        return fn
    return deco


def _binary(name, fn):
    @_intrinsic(classify_binary, name, imm_result=True)
    def g(a, b, _fn=fn):
        return _fn(a, b)
    g.__name__ = g.__qualname__ = name
    return g


def _inplace(name, fn):
    @_intrinsic(classify_inplace, name, imm_result=True)
    def g(a, b, _fn=fn):
        return _fn(a, b)
    g.__name__ = g.__qualname__ = name
    return g


def _unary(name, fn):
    @_intrinsic(classify_binary, name, imm_result=True)
    def g(a, _fn=fn):
        return _fn(a)
    g.__name__ = g.__qualname__ = name
    return g


# binary operators ----------------------------------------------------------
py_add = _binary("py_add", _op.add)
py_sub = _binary("py_sub", _op.sub)
py_mul = _binary("py_mul", _op.mul)
py_truediv = _binary("py_truediv", _op.truediv)
py_floordiv = _binary("py_floordiv", _op.floordiv)
py_mod = _binary("py_mod", _op.mod)
py_pow = _binary("py_pow", _op.pow)
py_lshift = _binary("py_lshift", _op.lshift)
py_rshift = _binary("py_rshift", _op.rshift)
py_or = _binary("py_or", _op.or_)
py_xor = _binary("py_xor", _op.xor)
py_and = _binary("py_and", _op.and_)
py_matmul = _binary("py_matmul", _op.matmul)
py_eq = _binary("py_eq", _op.eq)
py_ne = _binary("py_ne", _op.ne)
py_lt = _binary("py_lt", _op.lt)
py_le = _binary("py_le", _op.le)
py_gt = _binary("py_gt", _op.gt)
py_ge = _binary("py_ge", _op.ge)
py_contains = _binary("py_contains", lambda c, x: x in c)
py_not_contains = _binary("py_not_contains", lambda c, x: x not in c)

# identity is pure regardless of mutability
py_is = _binary("py_is", _op.is_)
py_is.__poppy_external__ = ExternalInfo(
    classify=classify_unordered, name="py_is", offload="inline",
    imm_result=True)
py_is_not = _binary("py_is_not", _op.is_not)
py_is_not.__poppy_external__ = ExternalInfo(
    classify=classify_unordered, name="py_is_not", offload="inline",
    imm_result=True)

# in-place operators ----------------------------------------------------------
py_iadd = _inplace("py_iadd", _op.iadd)
py_isub = _inplace("py_isub", _op.isub)
py_imul = _inplace("py_imul", _op.imul)
py_itruediv = _inplace("py_itruediv", _op.itruediv)
py_ifloordiv = _inplace("py_ifloordiv", _op.ifloordiv)
py_imod = _inplace("py_imod", _op.imod)
py_ipow = _inplace("py_ipow", _op.ipow)
py_ilshift = _inplace("py_ilshift", _op.ilshift)
py_irshift = _inplace("py_irshift", _op.irshift)
py_ior = _inplace("py_ior", _op.ior)
py_ixor = _inplace("py_ixor", _op.ixor)
py_iand = _inplace("py_iand", _op.iand)
py_imatmul = _inplace("py_imatmul", _op.imatmul)

# unary operators ------------------------------------------------------------
py_neg = _unary("py_neg", _op.neg)
py_pos = _unary("py_pos", _op.pos)
py_invert = _unary("py_invert", _op.invert)
py_not = _unary("py_not", _op.not_)


# attribute / item access ------------------------------------------------------
#
# Reads and writes of one object are keyed to its identity effect domain
# (``_effects_obj``): they order among themselves and against any
# ``"*"``-keyed call (every unannotated external), but not against
# unrelated domains — a local-dict build no longer serializes unrelated
# sequential externals.  Writes use ``classify_write`` (the
# ``classify_inplace`` mirror): mutation → sequential-in-domain, unless the
# target is a fresh single-consumer literal.
@_intrinsic(classify_read, effects=_effects_obj_attr)
def py_getattr(o, name):
    return getattr(o, name)


@_intrinsic(classify_write, effects=_effects_obj_attr, imm_result=True)
def py_setattr(o, name, v):
    setattr(o, name, v)
    return None


@_intrinsic(classify_read, effects=_effects_obj)
def py_getitem(o, i):
    return o[i]


@_intrinsic(classify_write, effects=_effects_obj, imm_result=True)
def py_setitem(o, i, v):
    o[i] = v
    return None


# control-flow support ---------------------------------------------------------
@_intrinsic(classify_read, effects=_effects_obj, imm_result=True)
def py_truth(x):
    return bool(x)


@_intrinsic(classify_iter_spine, effects=_effects_obj, imm_result=True)
def iter_spine(x):
    """Snapshot an iterable's spine for a ``for`` loop (elements may still be
    placeholders; the tuple structure is what the fold needs)."""
    return tuple(x)


@_intrinsic(classify_read, imm_result=True)
def py_unpack(v, n):
    t = tuple(v)
    if len(t) != n:
        raise ValueError(
            f"cannot unpack {len(t)} values into {n} targets")
    return t


# call-site unpacking (*args / **kwargs) -----------------------------------------
@_intrinsic(classify_read)
def py_kwargs(m):
    """Snapshot a ``**m`` mapping at a call site (CPython's semantics:
    keys must be strings; the mapping is read once)."""
    d = {}
    for k in m:
        if not isinstance(k, str):
            raise TypeError("keywords must be strings")
        d[k] = m[k]
    return d


@_intrinsic(classify_read)
def py_kw_merge(a, b):
    """Merge two keyword-argument dicts, rejecting duplicates like CPython
    (``f(x=1, **{'x': 2})`` → TypeError)."""
    out = dict(a)
    for k, v in b.items():
        if k in out:
            raise TypeError(
                f"got multiple values for keyword argument '{k}'")
        out[k] = v
    return out


# f-strings ---------------------------------------------------------------------
_CONV = {"s": str, "r": repr, "a": ascii, "": lambda v: v}


@_intrinsic(classify_read, imm_result=True)
def py_fstring(spec, *values):
    out = []
    vi = 0
    for part in spec:
        if part[0] == "s":
            out.append(part[1])
        else:
            _, conv, fmt = part
            v = values[vi]
            vi += 1
            v = _CONV[conv](v)
            out.append(format(v, fmt))
    return "".join(out)


# comprehension finalizers --------------------------------------------------------
@_intrinsic(classify_read)
def py_to_list(acc):
    return list(acc)


@_intrinsic(classify_read)
def py_to_set(acc):
    return set(acc)


@_intrinsic(classify_read)
def py_to_dict(acc):
    return dict(acc)
