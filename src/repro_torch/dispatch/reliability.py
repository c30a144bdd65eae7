"""Reliability layer: retries with exponential backoff, hedged requests,
and per-backend circuit breakers (DESIGN.md §5, §2.5).

* :func:`with_retry` — re-dispatch on failure with exponential backoff and
  *deterministic* jitter (derived from the request key and attempt number,
  never from a global RNG) so retried runs stay reproducible and the
  differential-testing invariant is unaffected.
* :func:`with_hedge` — straggler mitigation: if a request exceeds the hedge
  delay, race a duplicate (each hedge re-routes, so on a multi-replica
  router the duplicate lands on a *different* backend); first successful
  completion wins and the rest are cancelled.  Safe because the component
  calls are stateless and deterministic — whichever copy finishes first
  returns the same value.
* :class:`CircuitBreaker` — per-replica failure isolation: after
  ``failure_threshold`` consecutive failures the breaker *opens* and new
  requests fast-fail (:class:`CircuitOpenError`) instead of queuing on a
  dead backend; after ``cooldown_s`` one half-open probe is admitted, and
  its outcome closes or re-opens the circuit.
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter_frac: float = 0.1
    retry_on: tuple = (Exception,)


def backoff_s(policy: RetryPolicy, attempt: int, key: str = "") -> float:
    """Backoff before retry ``attempt`` (1-based), deterministically
    jittered by ±jitter_frac from the (key, attempt) hash."""
    base = min(policy.max_backoff_s,
               policy.base_s * policy.multiplier ** (attempt - 1))
    if policy.jitter_frac <= 0:
        return base
    d = int.from_bytes(
        hashlib.sha256(f"{key}:{attempt}".encode()).digest()[:4], "big")
    return base * (1.0 + policy.jitter_frac * ((d % 1000) / 500.0 - 1.0))


async def with_retry(thunk, policy: RetryPolicy | None, *, key: str = "",
                     on_retry=None):
    """Run async 0-arg ``thunk``, retrying per ``policy``."""
    if policy is None:
        return await thunk()
    attempt = 0
    while True:
        attempt += 1
        try:
            return await thunk()
        except asyncio.CancelledError:
            raise
        except policy.retry_on:
            if attempt >= policy.max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt)
            await asyncio.sleep(backoff_s(policy, attempt, key))


@dataclass(frozen=True)
class HedgePolicy:
    delay_s: float = 0.1     # how long before launching a duplicate
    max_hedges: int = 1      # duplicates beyond the primary


async def with_hedge(thunk_factory, policy: HedgePolicy | None, *,
                     on_hedge=None, on_win=None):
    """Run ``thunk_factory()`` (a fresh coroutine per call); if it hasn't
    finished after ``delay_s``, race up to ``max_hedges`` duplicates.
    Returns the first successful result; raises only if *all* copies fail.
    """
    if policy is None:
        return await thunk_factory()
    tasks: list[asyncio.Task] = [asyncio.ensure_future(thunk_factory())]
    errors: list[BaseException] = []
    try:
        while True:
            can_hedge = len(tasks) - 1 < policy.max_hedges
            done, pending = await asyncio.wait(
                [t for t in tasks if not t.done()],
                timeout=policy.delay_s if can_hedge else None,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:
                # hedge deadline passed: race a duplicate
                tasks.append(asyncio.ensure_future(thunk_factory()))
                if on_hedge is not None:
                    on_hedge()
                continue
            for t in done:
                if t.exception() is None:
                    if t is not tasks[0] and on_win is not None:
                        on_win()
                    return t.result()
                errors.append(t.exception())
            if len(errors) == len(tasks):
                raise errors[-1]
            # failures remain outstanding copies: keep waiting (and keep
            # hedging if budget remains)
    finally:
        for t in tasks:
            if not t.done():
                t.cancel()
        # retrieve cancellations so the loop doesn't warn
        for t in tasks:
            if t.cancelled():
                continue
            if t.done():
                t.exception()


# ---------------------------------------------------------------------------
# circuit breaker (DESIGN.md §2.5)


class CircuitOpenError(RuntimeError):
    """Fast-fail: the picked replica's circuit is open (the backend failed
    ``failure_threshold`` consecutive times and its cooldown has not yet
    elapsed)."""

    def __init__(self, backend: str):
        self.backend = backend
        super().__init__(f"circuit open for backend {backend!r}")


@dataclass(frozen=True)
class BreakerPolicy:
    failure_threshold: int = 5   # consecutive failures before opening
    cooldown_s: float = 1.0      # open duration before a half-open probe

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")


class CircuitBreaker:
    """closed → (threshold consecutive failures) → open → (cooldown) →
    half-open probe → closed on success / open on failure.

    Thread-safe: the dispatcher may be driven from the sync-client bridge
    loop concurrently with the engine loop.  ``on_transition(name, state)``
    fires on every state change (the dispatcher wires it to counters and
    span events); ``clock`` is injectable for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, policy: BreakerPolicy, *, name: str = "",
                 on_transition=None, clock=time.monotonic):
        self.policy = policy
        self.name = name
        self.on_transition = on_transition
        self.clock = clock
        self.state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._lock = threading.Lock()

    def _to(self, state: str):
        self.state = state
        if self.on_transition is not None:
            self.on_transition(self.name, state)

    def allow(self) -> bool:
        """Whether a new attempt may proceed.  In the open state this
        flips to half-open (admitting exactly one probe) once the cooldown
        has elapsed; other arrivals fast-fail until the probe settles."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self.clock() - self._opened_at < self.policy.cooldown_s:
                    return False
                self._to(self.HALF_OPEN)
                self._probing = True
                return True
            # half-open: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._probing = False
            if self.state != self.CLOSED:
                self._to(self.CLOSED)

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self.state == self.HALF_OPEN or (
                    self.state == self.CLOSED
                    and self._failures >= self.policy.failure_threshold):
                self._opened_at = self.clock()
                if self.state != self.OPEN:
                    self._to(self.OPEN)
