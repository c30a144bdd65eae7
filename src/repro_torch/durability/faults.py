"""Fault injection: deterministic chaos for the dispatch and serving
layers (DESIGN.md §2.5).

A :class:`FaultPlan` declares per-backend misbehavior probabilities —
errors, timeouts, latency spikes, and a cold slow-start window — and a
:class:`FaultInjector` draws from a *seeded* per-backend RNG, so a chaos
run is exactly reproducible: the same plan and traffic order injects the
same faults.  Threaded through ``repro_torch.dispatch.Dispatcher``
(``faults=``, applied per backend attempt, inside the retry loop so
retries see fresh draws) and
``repro_torch.serving.backend.LocalEngineBackend`` (``faults=``).  The
port's copy of ``repro/durability/faults.py``: :func:`make_injector`
accepts this module's plan and injector types only.
"""

from __future__ import annotations

import asyncio
import random
import threading
from dataclasses import dataclass


class InjectedFault(RuntimeError):
    """A fault-plan error draw: stands in for a backend 5xx/exception."""


class InjectedTimeout(InjectedFault, TimeoutError):
    """A fault-plan timeout draw: the request hangs for ``timeout_s``
    and then fails, like a deadline-exceeded upstream call."""


@dataclass(frozen=True)
class FaultPlan:
    """Misbehavior probabilities for one backend (or the default plan).

    Each attempt draws once: with probability ``error_rate`` it raises
    :class:`InjectedFault` immediately; with ``timeout_rate`` it sleeps
    ``timeout_s`` then raises :class:`InjectedTimeout`; with
    ``spike_rate`` it sleeps ``spike_s`` and then proceeds normally.
    Independently, the first ``slow_start`` attempts against a backend
    each pay ``slow_start_s`` of extra latency (a cold replica warming
    up).  ``seed`` keys the deterministic per-backend RNG.
    """

    error_rate: float = 0.0
    timeout_rate: float = 0.0
    timeout_s: float = 0.05
    spike_rate: float = 0.0
    spike_s: float = 0.05
    slow_start: int = 0
    slow_start_s: float = 0.02
    seed: int = 0

    def __post_init__(self):
        for f in ("error_rate", "timeout_rate", "spike_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.error_rate + self.timeout_rate + self.spike_rate > 1.0:
            raise ValueError("error_rate + timeout_rate + spike_rate "
                             "must not exceed 1.0")


class FaultInjector:
    """Applies a :class:`FaultPlan` per backend attempt.

    ``per_backend`` overrides the default plan for named backends.
    ``on_fault(backend, kind)`` is invoked for every injected perturbation
    (kinds: ``error`` / ``timeout`` / ``spike`` / ``slow_start``) — the
    dispatcher wires it to its counters and span events.  ``plan`` is
    deliberately mutable: chaos tests swap in a healthy plan mid-run to
    exercise circuit-breaker recovery.
    """

    def __init__(self, plan: FaultPlan | None = None, *, per_backend=None,
                 on_fault=None):
        self.plan = plan if plan is not None else FaultPlan()
        self.per_backend = dict(per_backend or {})
        self.on_fault = on_fault
        self.injected = 0
        self._rng: dict[str, random.Random] = {}
        self._attempts: dict[str, int] = {}
        self._lock = threading.Lock()

    def plan_for(self, backend: str) -> FaultPlan:
        return self.per_backend.get(backend, self.plan)

    def _note(self, backend: str, kind: str):
        with self._lock:
            self.injected += 1
        if self.on_fault is not None:
            self.on_fault(backend, kind)

    def _draw(self, backend: str, plan: FaultPlan):
        """One seeded draw + the slow-start counter, under the lock."""
        with self._lock:
            rng = self._rng.get(backend)
            if rng is None:
                rng = self._rng[backend] = random.Random(
                    f"{plan.seed}:{backend}")
            n = self._attempts.get(backend, 0)
            self._attempts[backend] = n + 1
            return rng.random(), n

    async def perturb(self, backend: str):
        """Apply this attempt's draw for ``backend``: possibly sleep,
        possibly raise.  Returning normally means the real call proceeds.
        """
        plan = self.plan_for(backend)
        r, n = self._draw(backend, plan)
        if n < plan.slow_start:
            self._note(backend, "slow_start")
            await asyncio.sleep(plan.slow_start_s)
        if r < plan.error_rate:
            self._note(backend, "error")
            raise InjectedFault(f"injected error on backend {backend!r}")
        r -= plan.error_rate
        if r < plan.timeout_rate:
            self._note(backend, "timeout")
            await asyncio.sleep(plan.timeout_s)
            raise InjectedTimeout(
                f"injected timeout on backend {backend!r} "
                f"after {plan.timeout_s}s")
        r -= plan.timeout_rate
        if r < plan.spike_rate:
            self._note(backend, "spike")
            await asyncio.sleep(plan.spike_s)


def make_injector(faults) -> FaultInjector | None:
    """Accept a FaultInjector, a FaultPlan, a kwargs dict, or None."""
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults)
    if isinstance(faults, dict):
        return FaultInjector(FaultPlan(**faults))
    raise TypeError(f"faults must be a FaultInjector, FaultPlan, dict, or "
                    f"None, got {type(faults).__name__}")
