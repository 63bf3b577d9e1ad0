"""Span tracer: bounded in-memory ring buffer + optional JSONL event log.

``Tracer.span`` is a context manager recording one timed region with
free-form fields::

    with tel.tracer.span("compile", network="vnet", method="pallas"):
        apply, report = compile_network(...)

Events land in a ``deque(maxlen=capacity)`` ring (a long-lived serving
process never grows without bound) and, when a ``jsonl_path`` is
configured, are appended to the event log as one JSON object per line —
the format the CI serving smoke parses.  All timing is host-side
(``time.perf_counter`` for durations, ``time.time`` for wall-clock
timestamps); nothing here ever touches a tensor.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque


class Span:
    """Handle yielded by ``Tracer.span`` — lets the body attach fields."""

    __slots__ = ("name", "fields", "t0", "duration_s")

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields
        self.t0 = 0.0
        self.duration_s = None

    def set(self, **fields) -> "Span":
        self.fields.update(fields)
        return self


class Tracer:
    def __init__(self, capacity: int = 2048, jsonl_path: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.jsonl_path = jsonl_path
        self.ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._fh = None

    # -- recording ----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Time a region; on exit record a ``kind="span"`` event with its
        ``duration_s``.  The event is recorded even when the body raises
        (with an ``error`` field) — failures must be observable too."""
        s = Span(name, dict(fields))
        s.t0 = time.perf_counter()
        try:
            yield s
        except BaseException as e:
            s.duration_s = time.perf_counter() - s.t0
            s.fields.setdefault("error", type(e).__name__)
            self._emit({"kind": "span", "name": name,
                        "duration_s": s.duration_s, **s.fields})
            raise
        s.duration_s = time.perf_counter() - s.t0
        self._emit({"kind": "span", "name": name,
                    "duration_s": s.duration_s, **s.fields})

    def event(self, name: str, **fields) -> None:
        """Record a point-in-time event (no duration)."""
        self._emit({"kind": "event", "name": name, **fields})

    def metric_record(self, name: str, payload: dict) -> None:
        """Append one metric snapshot record to the ring/JSONL (used by
        ``Telemetry.flush_metrics`` so the event log carries final
        instrument values alongside the spans)."""
        self._emit({"kind": "metric", "name": name, **payload})

    def _emit(self, rec: dict) -> None:
        rec = {"ts": time.time(), **rec}
        with self._lock:
            self.ring.append(rec)
            if self.jsonl_path is not None:
                if self._fh is None:
                    self._fh = open(self.jsonl_path, "a", buffering=1)
                self._fh.write(json.dumps(rec, default=str) + "\n")

    # -- inspection ---------------------------------------------------------

    def events(self, name: str | None = None) -> list[dict]:
        """Ring contents (oldest first), optionally filtered by name."""
        with self._lock:
            out = list(self.ring)
        if name is not None:
            out = [e for e in out if e.get("name") == name]
        return out

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
