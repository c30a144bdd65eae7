"""Multi-backend routing (DESIGN.md §5).

A :class:`Router` load-balances external calls across N registered backend
*replicas* — anything implementing the ``repro_torch.core.ai.Backend``
interface (a ``LocalEngineBackend`` over a ``ServingEngine``, another
``Dispatcher``, …).  Two policies:

* ``weighted`` — smooth weighted round-robin (the nginx algorithm): each
  pick adds every replica's weight to its current credit and selects the
  max-credit replica, subtracting the total weight.  Deterministic, and the
  long-run pick distribution matches the weights exactly.
* ``least_outstanding`` — pick the replica with the fewest in-flight
  requests, tie-broken by smooth-WRR credit so equal-load replicas still
  interleave deterministically.
* ``prefix_affinity`` — ask each replica's backend how many tokens of the
  request's prompt it already holds in its prefix KV cache
  (``Backend.prefix_probe``, a read-only radix-trie walk) and route to the
  warmest replica, so shared-prefix fan-outs land where the prefix lives
  instead of re-paying the prefill N times.  Cold traffic (no replica
  warm) and saturated warm replicas (see ``overload_slack``) fall back to
  least-outstanding.

The router only *selects*; in-flight accounting is transacted by the
dispatcher via :meth:`Replica.begin` / :meth:`Replica.end`.  ``pick``
takes an optional *hint* — the request's prompt text — which only
``prefix_affinity`` consults.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(eq=False)
class Replica:
    """One registered backend replica plus its routing state.

    ``eq=False``: replicas are identity objects — two replicas over equal
    backends are still distinct routing targets, and value-equality would
    deep-compare backend state on every lookup."""

    backend: object
    name: str
    weight: float = 1.0
    outstanding: int = 0
    dispatched: int = 0
    _credit: float = field(default=0.0, repr=False)

    def resolve(self):
        """The backend to call — overridable for late binding."""
        return self.backend

    def begin(self):
        self.outstanding += 1
        self.dispatched += 1

    def end(self):
        self.outstanding -= 1


class Router:
    def __init__(self, replicas: list[Replica]):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)

    def pick(self, hint=None) -> Replica:
        raise NotImplementedError


class WeightedRouter(Router):
    """Smooth weighted round-robin."""

    def _wrr_pick(self, candidates: list[Replica]) -> Replica:
        total = sum(r.weight for r in candidates)
        for r in candidates:
            r._credit += r.weight
        best = max(candidates, key=lambda r: r._credit)
        best._credit -= total
        return best

    def pick(self, hint=None) -> Replica:
        return self._wrr_pick(self.replicas)


class LeastOutstandingRouter(WeightedRouter):
    """Pick the least-loaded replica; ties resolve by smooth WRR."""

    def pick(self, hint=None) -> Replica:
        low = min(r.outstanding for r in self.replicas)
        return self._wrr_pick(
            [r for r in self.replicas if r.outstanding == low])


class PrefixAffinityRouter(LeastOutstandingRouter):
    """Route to the replica whose prefix KV cache best covers the prompt.

    Each replica's backend may expose ``prefix_probe(prompt) -> int`` (the
    longest-cached-prefix token count; ``LocalEngineBackend`` delegates to
    the engine's radix trie).  The pick:

    1. Probe every probe-capable replica with the hint.  Replicas matching
       ``>= min_match`` tokens are *warm*.
    2. Among warm replicas, take the deepest match; ties resolve by
       least-outstanding then smooth WRR.
    3. Saturation spill: if the chosen warm replica's backlog exceeds the
       fleet's least-loaded replica by more than ``overload_slack``
       in-flight requests, re-paying the prefill beats queueing — fall
       back to least-outstanding over everyone.
    4. No hint, no probes, or no warm replica → least-outstanding.
    """

    def __init__(self, replicas, *, min_match: int = 1,
                 overload_slack: int | None = None):
        super().__init__(replicas)
        self.min_match = min_match
        self.overload_slack = overload_slack

    def _probe(self, replica: Replica, hint) -> int:
        probe = getattr(replica.resolve(), "prefix_probe", None)
        if probe is None:
            return 0
        try:
            return int(probe(hint))
        except Exception:
            return 0  # a broken digest must never fail routing

    def pick(self, hint=None) -> Replica:
        if hint is None:
            return super().pick()
        scored = [(self._probe(r, hint), r) for r in self.replicas]
        best = max((s for s, _ in scored), default=0)
        if best < self.min_match:
            return super().pick()
        warm = [r for s, r in scored if s == best]
        low_warm = min(r.outstanding for r in warm)
        if self.overload_slack is not None:
            fleet_low = min(r.outstanding for r in self.replicas)
            if low_warm - fleet_low > self.overload_slack:
                return super().pick()
        return self._wrr_pick(
            [r for r in warm if r.outstanding == low_warm])


POLICIES = {
    "weighted": WeightedRouter,
    "least_outstanding": LeastOutstandingRouter,
    "prefix_affinity": PrefixAffinityRouter,
}


def make_router(backends, *, policy="least_outstanding", weights=None,
                names=None, **policy_kwargs) -> Router:
    """Build a router over ``backends`` (a list of Backend instances).

    ``policy_kwargs`` pass through to the policy class (e.g.
    ``min_match`` / ``overload_slack`` for ``prefix_affinity``)."""
    if policy not in POLICIES:
        raise ValueError(
            f"unknown routing policy {policy!r}; one of {sorted(POLICIES)}")
    n = len(backends)
    weights = list(weights) if weights is not None else [1.0] * n
    if len(weights) != n:
        raise ValueError(
            f"len(weights) must match len(backends): {len(weights)} != {n}")
    bad = [w for w in weights if not w > 0]
    if bad:
        raise ValueError(f"weights must be positive, got {bad}")
    names = list(names) if names is not None else [
        f"backend{i}" for i in range(n)]
    if len(names) != n:
        raise ValueError(
            f"len(names) must match len(backends): {len(names)} != {n}")
    replicas = [Replica(backend=b, name=nm, weight=w)
                for b, nm, w in zip(backends, names, weights)]
    return POLICIES[policy](replicas, **policy_kwargs)
