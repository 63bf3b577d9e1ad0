"""The measured window of a closed loop, shared by every kind of mix.

Unit ``i`` (a batch or a step) is issued once unit ``i - in_flight`` is
done on the device, for ``cell.window_s`` seconds of the host's clock;
each unit's completion is a mark on the device's clock (``Clock``).  The
benchmark's spans (``window``, ``wait``, ``make_input``, ``issue``) wrap
the steps when the cell is traced."""

from __future__ import annotations

import dataclasses
import time

from bench_dcnn.clock import Clock
from bench_dcnn.tracing import Trace, Tracer


@dataclasses.dataclass
class Window:
    setup_s: float       # process start to the window's start
    done_ms: list        # each unit's completion, from the window's start
    issue_s: float       # the host's seconds inside the issue calls
    trace: Trace | None  # the profiler's reduction, when traced


def closed_loop(cell, clock: Clock, in_flight: int, make_input,
                issue) -> Window:
    """Run the window: ``issue(i, make_input(i))`` for unit ``i``."""
    marks: list = []
    issue_s = 0.0
    with Tracer(cell.trace, cell.device) as tracer:
        clock.sync()
        setup_s = time.perf_counter() - cell.t_start
        with tracer.span("window"):
            clock.start()
            end = time.perf_counter() + cell.window_s
            i = 0
            while time.perf_counter() < end:
                if i >= in_flight:
                    with tracer.span("wait"):
                        clock.wait(marks[i - in_flight])
                with tracer.span("make_input"):
                    x = make_input(i)
                t = time.perf_counter()
                with tracer.span("issue"):
                    issue(i, x)
                    marks.append(clock.mark())
                issue_s += time.perf_counter() - t
                i += 1
            clock.sync()
    return Window(setup_s=setup_s, done_ms=[clock.ms(m) for m in marks],
                  issue_s=issue_s, trace=tracer.summary())
