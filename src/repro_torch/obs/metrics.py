"""Typed process-local metric instruments: Counter, Gauge, Histogram.

A framework-free copy of the JAX package's ``obs/metrics.py``: ONE
percentile implementation for the port (``quantile`` / ``Histogram``;
``runtime.serving.percentile`` delegates here).

Design constraints:

  * **Bounded.**  ``Histogram`` keeps a uniform reservoir (Vitter's
    algorithm R) of at most ``max_samples`` observations, so a serving
    process that handles millions of requests holds a constant-size
    sample while count/sum/min/max stay exact.
  * **Thread-safe.**  The serving queue is drained from whatever thread
    calls ``drain``/``step``; instruments take a lock per operation and
    the registry takes one per lookup, so concurrent ``observe``/``inc``
    never lose updates.
  * **Host-side only.**  Instruments store Python floats and never touch a
    tensor, so recording never waits on the device.
"""

from __future__ import annotations

import random
import threading
from typing import Iterable, Sequence


def quantile(sorted_xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (``p`` in [0, 100]) of an already
    sorted sequence — numpy's default "linear" method, and bit-identical
    to the historical ``runtime.serving.percentile``."""
    if not sorted_xs:
        return float("nan")
    n = len(sorted_xs)
    if n == 1:
        return float(sorted_xs[0])
    rank = (p / 100.0) * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return float(sorted_xs[lo] * (1.0 - frac) + sorted_xs[hi] * frac)


class Counter:
    """Monotonically increasing count (float increments allowed)."""

    kind = "counter"

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self._value}


class Histogram:
    """Bounded-reservoir distribution with exact count/sum/min/max.

    Observations past ``max_samples`` replace a uniformly random resident
    sample (algorithm R), so quantiles stay representative of the whole
    stream while memory stays constant.  The RNG is seeded per instrument
    for reproducible tests.
    """

    kind = "histogram"

    def __init__(self, name: str = "", labels: tuple = (),
                 max_samples: int = 1024, seed: int = 0):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.name = name
        self.labels = labels
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._rng = random.Random(seed)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.max_samples:
                    self._samples[j] = v

    def observe_many(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    def percentile(self, p: float) -> float:
        with self._lock:
            s = sorted(self._samples)
        return quantile(s, p)

    def percentiles(self, ps: Sequence[float]) -> list[float]:
        with self._lock:
            s = sorted(self._samples)
        return [quantile(s, p) for p in ps]

    def snapshot(self) -> dict:
        with self._lock:
            s = sorted(self._samples)
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        return {
            "kind": self.kind,
            "count": count,
            "sum": total,
            "min": mn if count else None,
            "max": mx if count else None,
            "mean": (total / count) if count else None,
            "p50": quantile(s, 50.0) if count else None,
            "p95": quantile(s, 95.0) if count else None,
            "p99": quantile(s, 99.0) if count else None,
        }


class MetricsRegistry:
    """Process-local registry of named, labelled instruments.

    ``counter``/``gauge``/``histogram`` are get-or-create keyed on
    ``(name, sorted(labels))`` — the same call site across threads always
    lands on the same instrument.  ``snapshot`` returns a plain dict for
    exporters.
    """

    def __init__(self):
        self._instruments: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def _get_or_create(self, cls, name, labels, **kwargs):
        key = self._key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name=name, labels=key[1], **kwargs)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, max_samples: int = 1024,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels,
                                   max_samples=max_samples)

    def instruments(self) -> list:
        with self._lock:
            return list(self._instruments.values())

    def get(self, name: str, **labels):
        """The instrument at ``(name, labels)`` or None."""
        with self._lock:
            return self._instruments.get(self._key(name, labels))

    def snapshot(self) -> dict:
        """``{name{label="v",...}: instrument snapshot}`` over everything."""
        out = {}
        for inst in self.instruments():
            if inst.labels:
                tags = ",".join(f'{k}="{v}"' for k, v in inst.labels)
                key = f"{inst.name}{{{tags}}}"
            else:
                key = inst.name
            out[key] = inst.snapshot()
        return out
