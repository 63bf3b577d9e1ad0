"""What the program itself recorded over the traced window: its spans and
counters (``repro_torch.obs``), on the profiler's clock.

While a profiler records, the program's sites (the engine's ``compile``,
``apply`` and ``node``, the ops' ``relayout``, the wrappers' ``launch``,
the train step's ``forward``, ``loss``, ``backward`` and ``update``)
record into ``repro_torch.obs.profiling_telemetry()``, and nowhere
otherwise; the recorder empties itself as a profile starts.  In this
harness that holds the traced window alone: the profiler starts after
set-up's warm passes.  ``recorder`` returns None where the program has
no such recorder, or it holds nothing, or its ring filled and dropped
records (said on stderr); each reader then returns None.

The idle readers rebuild the device's idle gaps between the window's
kernels (``ctx.kernels``, stamped on the spans' clock) and give each gap
to the train-step phase open when it began, whatever thread the
innermost span was on; a gap that began in none (the benchmark's
``wait``, say), or before the first kernel or after the last, goes to
none."""

from __future__ import annotations

import bisect
import sys

PHASES = ("forward", "loss", "backward", "update")


def recorder():
    """The program's profiling ``Telemetry``, or None (see above)."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    get = getattr(obs, "profiling_telemetry", None)
    if get is None:
        return None
    tel = get()
    ring = tel.tracer.ring
    if not ring:
        return None
    if len(ring) >= ring.maxlen:
        print(f"program_spans: the program's ring of {ring.maxlen} records "
              f"filled and dropped spans; its metrics are left out",
              file=sys.stderr)
        return None
    return tel


def host_ms_per_unit(ctx, kind: str, span: str):
    """Host milliseconds a batch or step inside the program's ``span``
    spans (0 where the program recorded none of them)."""
    tel = recorder() if ctx.kind == kind and ctx.units else None
    if tel is None:
        return None
    return 1e3 * sum(e["duration_s"]
                     for e in tel.tracer.events(span)) / ctx.units


def count_per_unit(ctx, kind: str, counter: str):
    """The program's ``counter``, over all its labels, a batch or step."""
    tel = recorder() if ctx.kind == kind and ctx.units else None
    if tel is None:
        return None
    return sum(i.value for i in tel.registry.instruments()
               if i.name == counter) / ctx.units


def idle_gaps(kernels) -> list:
    """``(start_ns, end_ns)`` of each stretch between kernels in which none
    ran, from the first kernel's start to the last one's end."""
    gaps, edge = [], None
    for _, _, a, b in sorted(kernels, key=lambda k: (k[2], k[3])):
        if edge is not None and a > edge:
            gaps.append((edge, a))
        edge = b if edge is None else max(edge, b)
    return gaps


def phase_at(phases: list, t: int):
    """The phase whose span, of ``phases`` (``(start_ns, end_ns, name)``,
    sorted, one after another), holds the instant ``t``; else None."""
    i = bisect.bisect_right(phases, (t, float("inf"), "")) - 1
    if i >= 0 and phases[i][0] <= t < phases[i][1]:
        return phases[i][2]
    return None


def idle_share_in(ctx, kind: str, phase: str):
    """% of the traced window idle in gaps that began inside ``phase``."""
    ok = ctx.kind == kind and ctx.units and ctx.kernels and ctx.window_s > 0
    tel = recorder() if ok else None
    if tel is None:
        return None
    phases = sorted((e["start_ns"], e["end_ns"], e["name"])
                    for e in tel.tracer.events()
                    if e.get("kind") == "span" and e["name"] in PHASES)
    idle = sum(b - a for a, b in idle_gaps(ctx.kernels)
               if phase_at(phases, a) == phase)
    return 100.0 * idle * 1e-9 / ctx.window_s
