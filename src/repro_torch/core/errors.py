"""PopPy error types."""


class PoppyError(Exception):
    """Base class for all PopPy errors."""


class PoppyCompileError(PoppyError):
    """Raised when a function cannot be compiled to the PopPy fragment.

    The ``@poppy`` decorator catches this and falls back to treating the
    function as an ``@sequential`` external (paper §4.1), unless
    ``strict=True`` was requested.
    """

    def __init__(self, msg, node=None, source_name=None):
        self.node = node
        self.source_name = source_name
        loc = ""
        if node is not None and hasattr(node, "lineno"):
            loc = f" (line {node.lineno})"
        if source_name:
            loc += f" in {source_name}"
        super().__init__(msg + loc)


class PoppyRuntimeError(PoppyError):
    """Raised for errors during opportunistic execution."""


class PoppyUnboundLocalError(PoppyRuntimeError):
    """A promoted local variable was read before assignment."""


class FirstSuccessError(PoppyRuntimeError):
    """Every rollout in a :func:`repro_torch.core.ai.first_success` race failed
    (raised, or was rejected by the ``accept`` filter).  ``failures`` holds
    the per-rollout outcomes in argument order: an exception instance for a
    raising rollout, or the rejected result."""

    def __init__(self, failures):
        self.failures = list(failures)
        super().__init__(
            f"all {len(self.failures)} first_success rollouts failed: "
            f"{self.failures!r}")


class ExternalCallError(PoppyRuntimeError):
    """An external call raised; PopPy terminates and surfaces the error
    to the user (paper §4.1: no silent execution of unsupported code)."""

    def __init__(self, fn_name, original):
        self.fn_name = fn_name
        self.original = original
        super().__init__(f"external call {fn_name!r} raised {original!r}")


class DeadlineExceeded(PoppyRuntimeError):
    """An external call exceeded its declared ``deadline_ms`` and was
    cooperatively cancelled (DESIGN.md §2.5).  The call's lock-chain
    positions are released normally — a deadline failure never wedges the
    per-domain ordering machinery."""

    def __init__(self, fn_name, deadline_ms):
        self.fn_name = fn_name
        self.deadline_ms = deadline_ms
        super().__init__(
            f"external call {fn_name!r} exceeded its {deadline_ms}ms "
            f"deadline")
