"""Admission control: token-bucket rate limits and concurrency caps
(DESIGN.md §5).

An unbounded ``@unordered`` burst from the PopPy engine would otherwise
stampede a backend with every call the moment its arguments resolve.  The
:class:`AdmissionController` applies asyncio *backpressure* instead: calls
past the concurrency cap or rate limit park on the event loop until
capacity frees up, so the burst degrades gracefully into a bounded-depth
pipeline.  Optionally a hard queue bound turns overload into fast-fail
(:class:`AdmissionRejected`) rather than unbounded memory growth.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass


class AdmissionRejected(RuntimeError):
    """Raised when the admission queue is full (load shedding)."""


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second, capacity ``burst``.

    ``acquire`` blocks (asyncio sleep, no busy-wait spin beyond one retry
    loop) until a token is available and returns the time spent waiting.
    """

    def __init__(self, rate: float, burst: float = 1.0, *,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.clock = clock
        self.last = clock()

    def _refill(self):
        now = self.clock()
        self.tokens = min(self.burst, self.tokens + (now - self.last)
                          * self.rate)
        self.last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    async def acquire(self, n: float = 1.0) -> float:
        t0 = self.clock()
        while True:
            self._refill()
            if self.tokens >= n:
                self.tokens -= n
                return self.clock() - t0
            await asyncio.sleep((n - self.tokens) / self.rate)


@dataclass(frozen=True)
class AdmissionPolicy:
    """Per-backend admission limits.  ``None`` disables a limit."""

    max_concurrency: int | None = None   # in-flight cap (semaphore)
    rate: float | None = None            # requests / second
    burst: float = 1.0                   # token-bucket capacity
    max_queue: int | None = None         # waiters beyond this are rejected


class AdmissionController:
    """Gate guarding one backend replica."""

    def __init__(self, policy: AdmissionPolicy):
        self.policy = policy
        self._sem = (asyncio.Semaphore(policy.max_concurrency)
                     if policy.max_concurrency else None)
        self._bucket = (TokenBucket(policy.rate, policy.burst)
                        if policy.rate else None)
        self.waiting = 0
        self.waiting_peak = 0

    async def __aenter__(self):
        if (self.policy.max_queue is not None
                and self.waiting >= self.policy.max_queue):
            raise AdmissionRejected(
                f"admission queue full ({self.waiting} waiting, "
                f"max {self.policy.max_queue})")
        self.waiting += 1
        self.waiting_peak = max(self.waiting_peak, self.waiting)
        acquired = False
        try:
            if self._bucket is not None:
                await self._bucket.acquire()
            if self._sem is not None:
                await self._sem.acquire()
                acquired = True
        except BaseException:
            if acquired:
                self._sem.release()
            raise
        finally:
            self.waiting -= 1
        return self

    async def __aexit__(self, *exc):
        if self._sem is not None:
            self._sem.release()
        return False


def make_admission(policy) -> AdmissionController | None:
    """Accept an AdmissionPolicy, a kwargs dict, or None."""
    if policy is None:
        return None
    if isinstance(policy, AdmissionController):
        return policy
    if isinstance(policy, dict):
        policy = AdmissionPolicy(**policy)
    return AdmissionController(policy)
