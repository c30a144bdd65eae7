"""repro_torch.core — PopPy: opportunistic parallelism for compound-AI
Python; the port's copy of ``repro.core``.

Public API::

    from repro_torch.core import poppy, unordered, readonly, sequential

    @poppy
    def app(task):
        ...

    app("...")          # runs opportunistically, external calls in parallel

See DESIGN.md for the compiler (frontend → Bezoar → λ^O) and runtime
(opportunistic engine + concurrency controllers) architecture.  The
components (``llm``, ``embed``, ``http``, ``MemoryStore``, the blocking
clients) and the backend hooks are in :mod:`.ai`; the annotation registry
knows only this package's annotations, so a program uses one package's
symbols throughout.
"""

from .annotations import (  # noqa: F401
    PoppyFn,
    batch_handler,
    external,
    in_sequential_mode,
    poppy,
    readonly,
    sequential,
    sequential_mode,
    unordered,
)
from .batching import (  # noqa: F401
    BatchingPolicy,
    batching,
    current_batching_policy,
)
from .engine import OffloadPolicy, current_offload_policy, offload_policy  # noqa: F401
from .errors import (  # noqa: F401
    DeadlineExceeded,
    ExternalCallError,
    FirstSuccessError,
    PoppyCompileError,
    PoppyError,
    PoppyRuntimeError,
    PoppyUnboundLocalError,
)
from .registry import (  # noqa: F401
    READONLY,
    SEQUENTIAL,
    UNORDERED,
    BatchSpec,
    register_immutable_type,
)
from .ai import first_success  # noqa: F401
from .speculate import SpecStats, current_speculation, speculation  # noqa: F401
from .trace import Trace, equivalent, recording  # noqa: F401

__all__ = [
    "poppy", "unordered", "readonly", "sequential", "external",
    "sequential_mode", "in_sequential_mode", "PoppyFn",
    "PoppyError", "PoppyCompileError", "PoppyRuntimeError",
    "PoppyUnboundLocalError", "ExternalCallError", "FirstSuccessError",
    "DeadlineExceeded",
    "UNORDERED", "READONLY", "SEQUENTIAL", "register_immutable_type",
    "Trace", "recording", "equivalent",
    "OffloadPolicy", "offload_policy", "current_offload_policy",
    "BatchSpec", "batch_handler", "BatchingPolicy", "batching",
    "current_batching_policy",
    "speculation", "SpecStats", "current_speculation", "first_success",
]
