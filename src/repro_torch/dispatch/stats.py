"""Dispatch observability surface.

Counters and latency digests for the dispatch subsystem (DESIGN.md §5):
cache hit rate, in-flight coalescing, retries, hedges and hedge wins,
admission queue depth, per-effect-domain request counts, and per-backend
latency percentiles.  Consumed by ``benchmarks/fig9_dispatch.py`` and by
the serving example's end-of-run report.  Multi-step counter updates are
lock-protected: with blocking (sync-SDK) components the dispatcher is
driven from the bridge loop's thread concurrently with the engine loop.

Storage lives in a :class:`repro_torch.obs.metrics.MetricsRegistry`
(DESIGN.md §4): each stats class here is a *view* whose public counter
attributes are :class:`~repro_torch.obs.metrics.InstrumentAttr` descriptors over
registry series, so the same numbers are readable through the legacy
``snapshot()`` / ``report()`` surfaces (shape-stable — benchmarks and
tests depend on them) and through ``stats.registry.snapshot()``.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

from repro_torch.obs.metrics import Histogram, InstrumentAttr, MetricsRegistry

if TYPE_CHECKING:  # avoid a runtime cycle (batcher imports LatencyDigest)
    from .batcher import BatchStats

#: Historical name for the bounded percentile reservoir, which now lives in
#: ``repro_torch.obs.metrics`` so the registry can own histogram series.  The
#: surface (``add`` / ``percentile`` / ``p50`` / ``p99`` / ``mean``) is
#: unchanged.
LatencyDigest = Histogram


class PrefixStats:
    """Shared-prefix admission counters (serving radix KV cache,
    DESIGN.md §3.2): how much prompt ingestion the engine skipped because
    app-level batches share a prefix.  ``note_batch`` is called once per
    batched admission by ``LocalEngineBackend.generate_batch``."""

    batches = InstrumentAttr()          # batches that warmed a shared prefix
    elements = InstrumentAttr()         # requests riding those batches
    shared_tokens = InstrumentAttr()    # common-prefix tokens over batches
    computed_tokens = InstrumentAttr()  # prefix tokens actually prefilled
    warm_cached = InstrumentAttr()      # warms fully served by radix cache

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self._i_batches = reg.counter("prefix_batches")
        self._i_elements = reg.counter("prefix_elements")
        self._i_shared_tokens = reg.counter("prefix_shared_tokens")
        self._i_computed_tokens = reg.counter("prefix_computed_tokens")
        self._i_warm_cached = reg.counter("prefix_warm_cached")

    def note_batch(self, *, elements, shared_tokens, computed_tokens):
        self.batches += 1
        self.elements += elements
        self.shared_tokens += shared_tokens
        self.computed_tokens += computed_tokens
        if computed_tokens == 0:
            self.warm_cached += 1

    def snapshot(self) -> dict:
        return {
            "batches": self.batches,
            "elements": self.elements,
            "shared_tokens": self.shared_tokens,
            "computed_tokens": self.computed_tokens,
            "warm_cached": self.warm_cached,
        }


class BackendStats:
    """Per-replica counters (a labeled view: every instrument carries a
    ``backend=<name>`` label in the owning registry)."""

    requests = InstrumentAttr()
    errors = InstrumentAttr()
    outstanding_peak = InstrumentAttr()
    routed = InstrumentAttr()            # router picks that landed here
    prefix_probed = InstrumentAttr()     # routed picks with an affinity probe
    prefix_hits = InstrumentAttr()       # probes matching >=1 cached token
    prefix_hit_tokens = InstrumentAttr()  # total matched prefix depth

    def __init__(self, registry: MetricsRegistry | None = None,
                 name: str = ""):
        reg = registry if registry is not None else MetricsRegistry()
        self._i_requests = reg.counter("backend_requests", backend=name)
        self._i_errors = reg.counter("backend_errors", backend=name)
        self._i_outstanding_peak = reg.counter("backend_outstanding_peak",
                                               backend=name)
        self._i_routed = reg.counter("replica_routed", backend=name)
        self._i_prefix_probed = reg.counter("replica_prefix_probes",
                                            backend=name)
        self._i_prefix_hits = reg.counter("replica_prefix_hits",
                                          backend=name)
        self._i_prefix_hit_tokens = reg.counter("replica_prefix_hit_tokens",
                                                backend=name)
        self.latency: Histogram = reg.histogram("backend_latency_s",
                                                backend=name)


class DispatchStats:
    """Aggregated counters for one Dispatcher."""

    requests = InstrumentAttr()      # client-visible calls entering dispatch
    dispatched = InstrumentAttr()    # calls actually sent to a backend
    cache_hits = InstrumentAttr()
    cache_misses = InstrumentAttr()
    disk_hits = InstrumentAttr()
    coalesced = InstrumentAttr()     # joined an identical in-flight request
    retries = InstrumentAttr()
    hedges = InstrumentAttr()        # duplicate requests launched
    hedge_wins = InstrumentAttr()    # a hedge finished before the primary
    rejected = InstrumentAttr()      # admission queue overflow
    cancelled = InstrumentAttr()     # backend attempts cancelled mid-flight
    races = InstrumentAttr()         # first_success races started
    race_losers = InstrumentAttr()   # rollouts cancelled after a winner
    disk_corrupt = InstrumentAttr()  # unparseable disk-cache entries dropped
    faults_injected = InstrumentAttr()   # chaos perturbations applied
    breaker_fastfails = InstrumentAttr()  # requests refused on open circuit
    breaker_opens = InstrumentAttr()     # circuit transitions to open
    breaker_closes = InstrumentAttr()    # circuit transitions to closed
    breaker_probes = InstrumentAttr()    # half-open probes admitted

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self._i_requests = reg.counter("dispatch_requests")
        self._i_dispatched = reg.counter("dispatch_dispatched")
        self._i_cache_hits = reg.counter("dispatch_cache_hits")
        self._i_cache_misses = reg.counter("dispatch_cache_misses")
        self._i_disk_hits = reg.counter("dispatch_disk_hits")
        self._i_coalesced = reg.counter("dispatch_coalesced")
        self._i_retries = reg.counter("dispatch_retries")
        self._i_hedges = reg.counter("dispatch_hedges")
        self._i_hedge_wins = reg.counter("dispatch_hedge_wins")
        self._i_rejected = reg.counter("dispatch_rejected")
        self._i_cancelled = reg.counter("dispatch_cancelled")
        self._i_races = reg.counter("dispatch_races")
        self._i_race_losers = reg.counter("dispatch_race_losers")
        self._i_disk_corrupt = reg.counter("dispatch_disk_corrupt")
        self._i_faults_injected = reg.counter("dispatch_faults_injected")
        self._i_breaker_fastfails = reg.counter("dispatch_breaker_fastfails")
        self._i_breaker_opens = reg.counter("dispatch_breaker_opens")
        self._i_breaker_closes = reg.counter("dispatch_breaker_closes")
        self._i_breaker_probes = reg.counter("dispatch_breaker_probes")
        # admission queue: one gauge carries depth (value) and peak
        self._queue = reg.gauge("dispatch_queue_depth")
        self.per_backend: dict[str, BackendStats] = {}
        # per-batch stats, attached by the Dispatcher
        self.batch: BatchStats | None = None
        # shared-prefix admission stats, fed by LocalEngineBackend
        self.prefix: PrefixStats | None = None
        self._lock = threading.Lock()

    # -- registry-backed views ----------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Currently waiting on admission."""
        return self._queue.value

    @property
    def queue_peak(self) -> int:
        return self._queue.peak

    @property
    def per_domain(self) -> dict[str, int]:
        """Requests per effect domain (DESIGN.md §2.2) — which sessions /
        hosts / resources drive the traffic.  A fresh dict view over the
        registry's ``domain_requests`` series."""
        return {dict(labels)["domain"]: c.value
                for labels, c in
                self.registry.series("domain_requests").items()}

    # -- event hooks ---------------------------------------------------------

    def backend(self, name: str) -> BackendStats:
        bs = self.per_backend.get(name)
        if bs is None:
            bs = self.per_backend[name] = BackendStats(self.registry, name)
        return bs

    def note_domains(self, domains):
        with self._lock:
            for d in domains:
                self.registry.counter("domain_requests", domain=d).inc()

    def note_prefix_batch(self, *, elements, shared_tokens,
                          computed_tokens):
        with self._lock:
            if self.prefix is None:
                self.prefix = PrefixStats(self.registry)
            self.prefix.note_batch(elements=elements,
                                   shared_tokens=shared_tokens,
                                   computed_tokens=computed_tokens)

    def note_route(self, name: str, matched: int | None = None):
        """Record a router pick landing on replica ``name``.  ``matched``
        is the prefix-affinity probe depth (tokens of the prompt already
        cached on the picked replica), or ``None`` when routing had no
        prompt hint or the backend exposes no digest — those picks count
        as routed but not probed, keeping hit *rate* meaningful."""
        with self._lock:
            bs = self.backend(name)
            bs.routed += 1
            if matched is not None:
                bs.prefix_probed += 1
                if matched > 0:
                    bs.prefix_hits += 1
                    bs.prefix_hit_tokens += matched

    def enqueue(self):
        with self._lock:
            self._queue.inc()

    def dequeue(self):
        with self._lock:
            self._queue.dec()

    def observe(self, name: str, seconds: float, *, error: bool = False):
        with self._lock:
            bs = self.backend(name)
            bs.requests += 1
            if error:
                bs.errors += 1
            else:
                bs.latency.add(seconds)

    # -- reporting -----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        looked = self.cache_hits + self.cache_misses
        return self.cache_hits / looked if looked else 0.0

    def snapshot(self) -> dict:
        batch = self.batch.snapshot() \
            if self.batch is not None and self.batch.batches else None
        return {
            "batch": batch,
            "prefix": self.prefix.snapshot()
            if self.prefix is not None else None,
            "requests": self.requests,
            "dispatched": self.dispatched,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "disk_hits": self.disk_hits,
            "hit_rate": self.hit_rate,
            "coalesced": self.coalesced,
            "retries": self.retries,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "rejected": self.rejected,
            "cancelled": self.cancelled,
            "races": self.races,
            "race_losers": self.race_losers,
            "disk_corrupt": self.disk_corrupt,
            "faults_injected": self.faults_injected,
            "breaker_fastfails": self.breaker_fastfails,
            "breaker_opens": self.breaker_opens,
            "breaker_closes": self.breaker_closes,
            "breaker_probes": self.breaker_probes,
            "queue_peak": self.queue_peak,
            "per_domain": dict(self.per_domain),
            "backends": {
                name: {
                    "requests": bs.requests,
                    "errors": bs.errors,
                    "outstanding_peak": bs.outstanding_peak,
                    "routed": bs.routed,
                    "prefix_probed": bs.prefix_probed,
                    "prefix_hits": bs.prefix_hits,
                    "prefix_hit_tokens": bs.prefix_hit_tokens,
                    "p50_s": bs.latency.p50,
                    "p99_s": bs.latency.p99,
                    "mean_s": bs.latency.mean,
                }
                for name, bs in self.per_backend.items()
            },
        }

    def report(self) -> str:
        snap = self.snapshot()
        lines = [
            f"dispatch: {snap['requests']} requests, "
            f"{snap['dispatched']} dispatched, "
            f"hit rate {snap['hit_rate']:.0%} "
            f"({snap['cache_hits']} hits / {snap['coalesced']} coalesced / "
            f"{snap['disk_hits']} disk), "
            f"{snap['retries']} retries, "
            f"{snap['hedges']} hedges ({snap['hedge_wins']} wins), "
            f"queue peak {snap['queue_peak']}"
        ]
        if snap["races"] or snap["cancelled"]:
            lines.append(
                f"  races: {snap['races']} first_success races, "
                f"{snap['race_losers']} losers cancelled, "
                f"{snap['cancelled']} attempts cancelled mid-flight")
        if snap["faults_injected"] or snap["breaker_opens"]:
            lines.append(
                f"  chaos: {snap['faults_injected']} faults injected, "
                f"breaker {snap['breaker_opens']} opens / "
                f"{snap['breaker_probes']} probes / "
                f"{snap['breaker_closes']} closes, "
                f"{snap['breaker_fastfails']} fast-fails")
        if snap["batch"]:
            b = snap["batch"]
            lines.append(
                f"  batches: {b['batches']} carrying {b['elements']} "
                f"elements (mean {b['mean_size']:.1f}"
                + (f", fill {b['fill_ratio']:.0%}" if b["fill_ratio"]
                   else "")
                + f"), window wait p50 {b['wait_p50_s'] * 1e3:.1f}ms")
        if snap["prefix"]:
            p = snap["prefix"]
            lines.append(
                f"  prefix: {p['batches']} shared-prefix batches "
                f"({p['elements']} requests), {p['shared_tokens']} shared "
                f"tokens, {p['computed_tokens']} prefilled once "
                f"({p['warm_cached']} warm hits)")
        if snap["per_domain"]:
            top = sorted(snap["per_domain"].items(),
                         key=lambda kv: -kv[1])[:8]
            lines.append("  domains: " + ", ".join(
                f"{d}={n}" for d, n in top))
        for name, bs in snap["backends"].items():
            line = (
                f"  {name}: {bs['requests']} reqs, {bs['errors']} errors, "
                f"p50 {bs['p50_s'] * 1e3:.1f}ms p99 {bs['p99_s'] * 1e3:.1f}ms, "
                f"peak in-flight {bs['outstanding_peak']}")
            if bs["prefix_probed"]:
                line += (f", affinity {bs['prefix_hits']}/"
                         f"{bs['prefix_probed']} warm "
                         f"({bs['prefix_hit_tokens']} tok)")
            lines.append(line)
        return "\n".join(lines)
