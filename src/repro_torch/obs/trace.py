"""Span tracer: bounded in-memory ring buffer + optional JSONL event log.

``Tracer.span`` is a context manager recording one timed region with
free-form fields::

    with tel.tracer.span("compile", network="vnet", method="pallas"):
        apply, report = compile_network(...)

Events land in a ``deque(maxlen=capacity)`` ring (a long-lived serving
process never grows without bound) and, when a ``jsonl_path`` is
configured, are appended to the event log as one JSON object per line —
the format the CI serving smoke parses.

A span is stamped on the clock of ``torch.profiler``'s events
(``time.time_ns``: ``start_ns``/``end_ns``), takes its ``duration_s`` from
``time.perf_counter``, and carries its own ``id`` and the ``parent`` id of
the span enclosing it on the same thread (autograd runs a CUDA backward on
a thread of its own).  While a profiler records (``profiler_recording``),
a span also opens a ``record_function`` range named
``repro_torch.<name>[.<of>]``, so it sits in the device trace as the
parent of the kernels launched inside it.  The range is PyTorch's
``_RecordFunctionFast``, the same user-scope range that
``torch.profiler.record_function`` opens, at about a tenth of its cost
(1.6 against 13 µs on a CPU): a traced V-Net batch opens ~40 spans.
Nothing here ever touches a tensor.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "repro_torch."
# the profiler's range (``record_function``'s own kind, without its Python
# dispatch through ``torch.ops.profiler``)
RANGE = torch._C._profiler._RecordFunctionFast

# span ids are unique in the process, so parent links hold across tracers
_ids = itertools.count(1)
_open = threading.local()           # .stack: ids of this thread's open spans

# what a site enters when nothing records: shared, and does nothing
NO_SPAN = contextlib.nullcontext()


def profiler_recording() -> bool:
    """True while a ``torch.profiler`` (or ``autograd.profiler``) profile
    records, in any thread: one read of the flag its enter and exit set."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class Span:
    """One region: ``with tracer.span(...) as s`` times it and records it on
    exit; ``s.set(...)`` attaches fields from the body.  The record is made
    even when the body raises (with an ``error`` field)."""

    __slots__ = ("tracer", "name", "of", "fields", "id", "parent",
                 "start_ns", "end_ns", "duration_s", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, of, fields: dict):
        self.tracer = tracer
        self.name = name
        self.of = of
        self.fields = fields
        self.duration_s = None
        self._range = None

    def set(self, **fields) -> "Span":
        self.fields.update(fields)
        return self

    def __enter__(self) -> "Span":
        if profiler_recording():
            label = PREFIX + self.name
            if self.of is not None:
                label += "." + str(self.of)
            self._range = RANGE(label)
            self._range.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._t0 = time.perf_counter()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = time.time_ns()
        self.duration_s = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        _stack().pop()
        if exc_type is not None:
            self.fields.setdefault("error", exc_type.__name__)
        rec = {"ts": time.time(), "kind": "span", "name": self.name,
               "id": self.id, "parent": self.parent,
               "start_ns": self.start_ns, "end_ns": self.end_ns,
               "duration_s": self.duration_s}
        if self.of is not None:
            rec["of"] = self.of
        rec.update(self.fields)
        self.tracer._append(rec)
        return False


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

    def span(self, name: str, of=None, **fields) -> Span:
        """Time a region; on exit record a ``kind="span"`` event with its
        ``start_ns``, ``end_ns``, ``duration_s``, ``id`` and ``parent``.
        ``of`` names what the span is of (a node, a wrapper), recorded as
        a field and appended to the profiler range's name."""
        return Span(self, name, of, fields)

    def event(self, name: str, **fields) -> None:
        """Record a point-in-time event (no duration)."""
        self._emit({"kind": "event", "name": name, **fields})

    def metric_record(self, name: str, payload: dict) -> None:
        """Append one metric snapshot record to the ring/JSONL (used by
        ``Telemetry.flush_metrics`` so the event log carries final
        instrument values alongside the spans)."""
        self._emit({"kind": "metric", "name": name, **payload})

    def _emit(self, rec: dict) -> None:
        self._append({"ts": time.time(), **rec})

    def _append(self, rec: dict) -> None:
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

    def clear(self) -> None:
        """Empty the ring (the event log keeps what it has)."""
        with self._lock:
            self.ring.clear()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
