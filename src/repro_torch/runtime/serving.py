"""Shared serving primitives: bounded queues, deadlines, typed errors.

A framework-free copy of the JAX package's ``runtime/serving.py``: a
serving tier only earns production traffic if overload sheds instead of
growing an unbounded queue, if an expired request is *rejected with a
typed error* instead of silently dropped, and if every failure a client
can observe is a member of one exception family it can switch on.

  * ``ServeError`` and its subclasses — the complete, typed failure
    surface.  Every rejection the server emits is one of these; a bare
    ``Exception`` escaping the server is a bug.
  * ``RequestQueue`` — bounded FIFO with per-request absolute deadlines.
    ``submit`` raises ``QueueFullError`` at capacity (load shedding, the
    shed is counted), ``sweep_expired``/``take`` return expired tickets
    separately so the caller must complete them with
    ``DeadlineExceededError``.
  * ``Backoff`` — deterministic exponential retry schedule with an
    injectable sleep (tests pass a recorder, production passes
    ``time.sleep``).
  * ``percentile``/``latency_summary`` — the p50/p99 surface of the stats
    dicts.  The math itself lives in ``repro_torch.obs.metrics``; these
    wrappers also accept an ``obs.Histogram`` directly (the
    registry-backed per-bucket latency instruments).

The clock is injectable everywhere (``clock=time.monotonic`` by default)
so deadline behaviour is tested deterministically, without wall-time
sleeps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

from repro_torch.obs import metrics as _metrics


# ---------------------------------------------------------------------------
# The typed failure surface.
# ---------------------------------------------------------------------------

class ServeError(Exception):
    """Base of every typed serving failure — clients switch on ``code``."""
    code = "serve_error"


class QueueFullError(ServeError):
    """The bounded request queue is at capacity: the request was shed."""
    code = "queue_full"


class DeadlineExceededError(ServeError):
    """The request's deadline passed before it was served."""
    code = "deadline_exceeded"


class InvalidRequestError(ServeError):
    """The request failed validation at ``submit`` (wrong shape, unknown
    model, prompt longer than the serving window)."""
    code = "invalid_request"


class PoisonedOutputError(ServeError):
    """The request's output contained NaN/Inf and was quarantined."""
    code = "poisoned_output"


class DispatchFailedError(ServeError):
    """Every engine (primary, retries, fallback) failed to serve the
    request's batch."""
    code = "dispatch_failed"


# ---------------------------------------------------------------------------
# Bounded deadline-aware queue.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ticket:
    """One queued request: the payload plus its admission bookkeeping."""
    item: Any
    seq: int
    submitted: float
    deadline: float | None          # absolute (queue-clock) or None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class RequestQueue:
    """Bounded FIFO with load shedding and per-request deadlines.

    ``submit`` raises ``QueueFullError`` when ``max_depth`` tickets are
    waiting (counted in ``shed``).  Expired tickets are never silently
    dropped: ``sweep_expired`` (and the sweep inside ``take``) hands them
    back to the caller, which must complete them with
    ``DeadlineExceededError`` — the counters make the behaviour auditable
    from the stats surface.
    """

    def __init__(self, max_depth: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.clock = clock
        self._items: list[Ticket] = []
        self._seq = 0
        self.submitted = 0
        self.shed = 0
        self.expired = 0

    def __len__(self) -> int:
        return len(self._items)

    @property
    def depth(self) -> int:
        return len(self._items)

    def submit(self, item, deadline_s: float | None = None) -> Ticket:
        """Enqueue ``item`` (deadline relative to now) or shed it."""
        if len(self._items) >= self.max_depth:
            self.shed += 1
            raise QueueFullError(
                f"queue full ({self.max_depth} waiting): request shed")
        now = self.clock()
        t = Ticket(item=item, seq=self._seq, submitted=now,
                   deadline=None if deadline_s is None else now + deadline_s)
        self._seq += 1
        self._items.append(t)
        self.submitted += 1
        return t

    def sweep_expired(self) -> list[Ticket]:
        """Remove and return every expired ticket (caller completes them
        with a typed error — they are never dropped)."""
        now = self.clock()
        out = [t for t in self._items if t.expired(now)]
        if out:
            self._items = [t for t in self._items if not t.expired(now)]
            self.expired += len(out)
        return out

    def peek(self) -> Ticket | None:
        """The oldest non-expired ticket (expired ones are NOT removed —
        call ``sweep_expired`` first)."""
        now = self.clock()
        for t in self._items:
            if not t.expired(now):
                return t
        return None

    def take(self, n: int, pred: Callable[[Any], bool] | None = None,
             ) -> list[Ticket]:
        """Dequeue up to ``n`` non-expired tickets in FIFO order, keeping
        only those matching ``pred`` (None = all).  Non-matching tickets
        stay queued in order."""
        taken: list[Ticket] = []
        rest: list[Ticket] = []
        now = self.clock()
        for t in self._items:
            if (len(taken) < n and not t.expired(now)
                    and (pred is None or pred(t.item))):
                taken.append(t)
            else:
                rest.append(t)
        self._items = rest
        return taken


# ---------------------------------------------------------------------------
# Retry policy.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backoff:
    """Exponential retry schedule: ``base_s * factor**attempt`` seconds
    before retry ``attempt`` (0-indexed), ``max_retries`` retries total.
    ``sleep`` is injectable so tests record delays instead of waiting."""
    base_s: float = 0.02
    factor: float = 2.0
    max_retries: int = 2
    sleep: Callable[[float], None] = time.sleep

    def delay(self, attempt: int) -> float:
        return self.base_s * (self.factor ** attempt)

    def wait(self, attempt: int) -> None:
        self.sleep(self.delay(attempt))


# ---------------------------------------------------------------------------
# Latency math shared by the stats surfaces and serve_bench.
# ---------------------------------------------------------------------------

def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (p in [0, 100]) of ``xs`` —
    delegates to the shared ``repro_torch.obs.metrics.quantile``."""
    return _metrics.quantile(sorted(xs), p)


def latency_summary(seconds) -> dict:
    """p50/p99/mean (microseconds) + count over per-request latencies.

    ``seconds`` is a sequence of wall seconds (the historical contract)
    or an ``obs.Histogram`` of them — the registry-backed bucket
    instruments ``dcnn_server.stats()`` renders.  For a histogram, ``n``
    is the TOTAL observation count while the percentiles come from its
    bounded reservoir.
    """
    if isinstance(seconds, _metrics.Histogram):
        if seconds.count == 0:
            return {"n": 0, "p50_us": None, "p99_us": None, "mean_us": None}
        p50, p99 = seconds.percentiles((50.0, 99.0))
        return {
            "n": seconds.count,
            "p50_us": round(p50 * 1e6, 1),
            "p99_us": round(p99 * 1e6, 1),
            "mean_us": round(seconds.mean * 1e6, 1),
        }
    if not seconds:
        return {"n": 0, "p50_us": None, "p99_us": None, "mean_us": None}
    us = [s * 1e6 for s in seconds]
    return {
        "n": len(us),
        "p50_us": round(percentile(us, 50.0), 1),
        "p99_us": round(percentile(us, 99.0), 1),
        "mean_us": round(sum(us) / len(us), 1),
    }
