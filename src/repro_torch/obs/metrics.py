"""Metrics registry: counters, gauges, and histograms with labeled series.

The port's own copy of ``repro/obs/metrics.py`` (the port imports nothing
of ``repro``).  The serving engine's page allocator feeds its
``serving_page_*`` series.

Instruments are identified by ``(name, labels)``; ``registry.counter(
"dispatch_requests")`` and ``registry.counter("domain_requests",
domain="http:a")`` are distinct series.  Get-or-create is lock-protected;
updates to an individual instrument are plain attribute writes (callers
needing multi-step atomicity hold their own lock).
"""

from __future__ import annotations

import threading
from typing import Any, Iterator

__all__ = ["Counter", "Gauge", "Histogram", "InstrumentAttr",
           "MetricsRegistry"]

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically-intended numeric series (``.value`` is writable so
    legacy ``stats.requests += 1`` call sites keep working)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time numeric series (queue depth, occupancy)."""

    __slots__ = ("name", "labels", "value", "peak")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value: float = 0
        self.peak: float = 0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v

    def inc(self, n: float = 1) -> None:
        self.set(self.value + n)

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Bounded reservoir of samples with percentile queries.

    Keeps the most recent ``maxlen`` samples (enough for p99 at benchmark
    scales; a production deployment would swap in t-digest without
    changing the surface).
    """

    __slots__ = ("name", "labels", "maxlen", "samples", "count", "total_s")

    def __init__(self, maxlen: int = 8192, *, name: str = "",
                 labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.maxlen = maxlen
        self.samples: list[float] = []
        self.count = 0
        self.total_s = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.samples.append(seconds)
        if len(self.samples) > self.maxlen:
            del self.samples[: len(self.samples) - self.maxlen]

    # registry-idiomatic alias
    observe = add

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def mean(self) -> float:
        return self.total_s / self.count if self.count else 0.0


Instrument = Counter | Gauge | Histogram


class InstrumentAttr:
    """Descriptor exposing a registry instrument's ``.value`` as a plain
    read/write attribute.  The legacy stats classes declare ``requests =
    InstrumentAttr()`` and bind ``self._i_requests = registry.counter(...)``
    in ``__init__`` — call sites keep writing ``st.requests += 1`` while the
    registry owns the storage."""

    __slots__ = ("slot",)

    def __set_name__(self, owner: type, name: str) -> None:
        self.slot = "_i_" + name

    def __get__(self, obj: Any, objtype: type | None = None) -> Any:
        if obj is None:
            return self
        return getattr(obj, self.slot).value

    def __set__(self, obj: Any, value: Any) -> None:
        getattr(obj, self.slot).value = value


class MetricsRegistry:
    """Labeled-series store with get-or-create instrument accessors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: dict[tuple[str, LabelKey], Instrument] = {}

    # -- get-or-create -------------------------------------------------------

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)  # type: ignore[return-value]

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)  # type: ignore[return-value]

    def histogram(self, name: str, maxlen: int = 8192,
                  **labels: Any) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._series.get(key)
            if inst is None:
                inst = self._series[key] = Histogram(
                    maxlen, name=name, labels=key[1])
            elif not isinstance(inst, Histogram):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}")
        return inst

    def _get(self, cls: type, name: str, labels: dict[str, Any]) -> Instrument:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._series.get(key)
            if inst is None:
                inst = self._series[key] = cls(name, key[1])
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}")
        return inst

    # -- views ---------------------------------------------------------------

    def series(self, name: str) -> dict[LabelKey, Instrument]:
        """All instruments registered under ``name``, keyed by labels."""
        with self._lock:
            return {k[1]: v for k, v in self._series.items()
                    if k[0] == name}

    def __iter__(self) -> Iterator[Instrument]:
        with self._lock:
            return iter(list(self._series.values()))

    def snapshot(self) -> dict[str, Any]:
        """``{name{label=val,...}: value}`` for scalars; histograms render
        as ``{count, mean, p50, p99}`` sub-dicts."""
        out: dict[str, Any] = {}
        with self._lock:
            items = list(self._series.items())
        for (name, labels), inst in sorted(items):
            key = name
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            if isinstance(inst, Histogram):
                out[key] = {"count": inst.count, "mean_s": inst.mean,
                            "p50_s": inst.p50, "p99_s": inst.p99}
            elif isinstance(inst, Gauge):
                out[key] = {"value": inst.value, "peak": inst.peak}
            else:
                out[key] = inst.value
        return out

    def render(self) -> str:
        """Human-readable one-line-per-series dump."""
        lines = []
        for key, val in self.snapshot().items():
            if isinstance(val, dict) and "p99_s" in val:
                lines.append(
                    f"{key}: n={val['count']} mean={val['mean_s'] * 1e3:.2f}ms"
                    f" p50={val['p50_s'] * 1e3:.2f}ms"
                    f" p99={val['p99_s'] * 1e3:.2f}ms")
            elif isinstance(val, dict):
                lines.append(f"{key}: {val['value']} (peak {val['peak']})")
            else:
                lines.append(f"{key}: {val}")
        return "\n".join(lines)
