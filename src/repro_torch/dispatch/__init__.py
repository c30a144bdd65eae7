"""repro_torch.dispatch — production external-call dispatch (DESIGN.md §5);
the port's copy of ``repro.dispatch``.

Sits between the PopPy concurrency controllers and the backends: routing
across backend replicas, per-backend admission control (token-bucket rate
limits + concurrency caps with asyncio backpressure), a deterministic
result cache with in-flight coalescing, a micro-batcher coalescing
concurrent requests into batched backend calls (DESIGN.md §2.3), retries
with deterministic-jitter backoff, hedged duplicate requests for
straggler mitigation, and a stats surface.

Quickstart::

    from repro_torch.core.ai import SimulatedBackend, llm, use_dispatcher
    from repro_torch.dispatch import (AdmissionPolicy, BatchPolicy,
                                      Dispatcher, HedgePolicy)

    d = Dispatcher(
        [SimulatedBackend(), SimulatedBackend()],   # two replicas
        policy="least_outstanding",
        cache=True,                                  # LRU + coalescing
        admission=AdmissionPolicy(max_concurrency=8, rate=200.0, burst=16),
        hedge=HedgePolicy(delay_s=0.25),
        batch=BatchPolicy(max_batch=32, max_wait_s=0.004),  # micro-batching
    )
    with use_dispatcher(d):
        my_poppy_app()
    print(d.stats.report())
"""

from .admission import (  # noqa: F401
    AdmissionController,
    AdmissionPolicy,
    AdmissionRejected,
    TokenBucket,
)
from .batcher import (  # noqa: F401
    BatchPolicy,
    BatchStats,
    MicroBatcher,
    make_batch_policy,
)
from .cache import DiskCache, LRUCache, ResultCache, request_key  # noqa: F401
from .dispatcher import Dispatcher  # noqa: F401
from .reliability import (  # noqa: F401
    HedgePolicy,
    RetryPolicy,
    with_hedge,
    with_retry,
)
from .router import (  # noqa: F401
    LeastOutstandingRouter,
    PrefixAffinityRouter,
    Replica,
    Router,
    WeightedRouter,
    make_router,
)
from .stats import BackendStats, DispatchStats, LatencyDigest  # noqa: F401

__all__ = [
    "Dispatcher",
    "Router", "WeightedRouter", "LeastOutstandingRouter",
    "PrefixAffinityRouter", "Replica",
    "make_router",
    "AdmissionPolicy", "AdmissionController", "AdmissionRejected",
    "TokenBucket",
    "BatchPolicy", "BatchStats", "MicroBatcher", "make_batch_policy",
    "ResultCache", "LRUCache", "DiskCache", "request_key",
    "RetryPolicy", "HedgePolicy", "with_retry", "with_hedge",
    "DispatchStats", "BackendStats", "LatencyDigest",
]
