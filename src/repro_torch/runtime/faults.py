"""Deterministic fault injection for engines, schedules and loops (JAX
``runtime/faults.py``; the same scripts address the same calls in both
packages).

Every failure mode the serving/training tier claims to survive is injected
here, on a *scripted*, repeatable schedule — no flaky sleeps, no "usually
fails" randomness.  A ``FaultScript`` is a list of ``FaultEvent``s, each
addressed by (channel, 1-indexed call count on that channel, optional tag
substring):

  * ``kind="error"``          raise ``InjectedDispatchError`` on call k
                              (the transient/persistent dispatch failure);
  * ``kind="compile_error"``  raise ``InjectedCompileError`` when a
                              matching geometry compiles (call k on the
                              ``compile`` channel);
  * ``kind="slow"``           sleep ``factor`` seconds before returning
                              (drives straggler watchdogs and deadline
                              pressure);
  * ``kind="nan"``            poison ``rows`` of the call's output with
                              ``fill`` (NaN by default) — the output-guard
                              path;
  * ``kind="signal"``         deliver ``signum`` to this process (drives
                              the train loop's preemption path).

``FaultScript.from_seed`` derives a script from a seed with fixed
per-call probabilities, so "a scripted mix of everything" is one integer.
Wrappers:

  * ``wrap_schedule(apply, script, tag=...)`` — any compiled schedule /
    callable, injecting on the ``dispatch`` channel;
  * ``wrap_step(step_fn, script)`` — a training step function, injecting
    on the ``step`` channel (slow steps, signals, errors);
  * ``FaultyEngine(engine, script)`` — a ``UniformEngine`` whose
    ``conv``/``deconv`` calls pass through the ``dispatch`` channel.

The sleep and kill effects are injectable so tests can record instead of
waiting/killing.  Outputs may be tensors on the card: ``corrupt`` poisons
a clone on the tensor's own device, and the guards read a host copy.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal as _signal
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch


class InjectedFault(Exception):
    """Base of every scripted failure the fault layer raises."""


class InjectedDispatchError(InjectedFault):
    """A scripted (transient or persistent) dispatch failure."""


class InjectedCompileError(InjectedFault):
    """A scripted compilation failure for a geometry."""


_DEFAULT_CHANNEL = {
    "error": "dispatch",
    "slow": "dispatch",
    "nan": "dispatch",
    "compile_error": "compile",
    "signal": "step",
}

KINDS = tuple(_DEFAULT_CHANNEL)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted failure.

    ``at_call`` is 1-indexed over the calls on the event's channel whose
    tag contains ``match`` ("" matches every call); ``count`` is how many
    consecutive matching calls it fires on (0 = forever from ``at_call``).
    """
    kind: str
    at_call: int = 1
    channel: str = ""               # "" = the kind's default channel
    match: str = ""                 # substring of the call tag ("" = any)
    count: int = 1
    factor: float = 0.25            # sleep seconds for kind="slow"
    rows: tuple[int, ...] = (0,)    # poisoned batch rows for kind="nan"
    fill: float = float("nan")      # poison value for kind="nan"
    signum: int = int(_signal.SIGTERM)

    def __post_init__(self):
        if self.kind not in _DEFAULT_CHANNEL:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {KINDS}")
        if self.at_call < 1:
            raise ValueError(f"at_call is 1-indexed, got {self.at_call}")
        if not self.channel:
            object.__setattr__(self, "channel", _DEFAULT_CHANNEL[self.kind])

    def fires(self, k: int) -> bool:
        """Does the event fire on matching call number ``k``?"""
        if k < self.at_call:
            return False
        return self.count == 0 or k < self.at_call + self.count


class FaultScript:
    """A deterministic schedule of ``FaultEvent``s with per-channel call
    counters.  One script instance carries state (call counts, the fired
    log) — build a fresh one per experiment."""

    def __init__(self, events: Sequence[FaultEvent] = (),
                 sleep: Callable[[float], None] = time.sleep,
                 kill: Callable[[int, int], None] = os.kill):
        self.events = list(events)
        self._sleep = sleep
        self._kill = kill
        # calls counted per (channel, match-key): "" counts every call on
        # the channel; a non-empty key counts only calls whose tag
        # contains it (so `at_call` is "the k-th call touching THIS
        # geometry", not "the k-th call overall")
        self._calls: dict[tuple[str, str], int] = {}
        self.fired: list[tuple[FaultEvent, int, str]] = []

    @classmethod
    def from_seed(cls, seed: int, calls: int = 32, *,
                  p_error: float = 0.0, p_slow: float = 0.0,
                  p_nan: float = 0.0, p_compile_error: float = 0.0,
                  slow_s: float = 0.05, rows: tuple[int, ...] = (0,),
                  **kw) -> "FaultScript":
        """Derive a scripted mix from one integer: for each of ``calls``
        dispatch slots (and compile slots), draw each fault kind with its
        probability via ``random.Random(seed)`` — same seed, same script,
        forever."""
        rng = random.Random(seed)
        events = []
        for k in range(1, calls + 1):
            if rng.random() < p_error:
                events.append(FaultEvent("error", at_call=k))
            if rng.random() < p_slow:
                events.append(FaultEvent("slow", at_call=k, factor=slow_s))
            if rng.random() < p_nan:
                events.append(FaultEvent("nan", at_call=k, rows=rows))
            if rng.random() < p_compile_error:
                events.append(FaultEvent("compile_error", at_call=k))
        return cls(events, **kw)

    # -- call accounting ----------------------------------------------------

    def calls(self, channel: str, match: str = "") -> int:
        return self._calls.get((channel, match), 0)

    def _tick(self, channel: str, tag: str) -> list[FaultEvent]:
        keys = {""} | {e.match for e in self.events
                       if e.channel == channel and e.match}
        hits: list[FaultEvent] = []
        for key in keys:
            if key and key not in tag:
                continue
            k = self._calls[(channel, key)] = \
                self._calls.get((channel, key), 0) + 1
            for e in self.events:
                if e.channel == channel and e.match == key and e.fires(k):
                    hits.append(e)
                    self.fired.append((e, k, tag))
        return hits

    def on_call(self, channel: str, tag: str = "") -> list[FaultEvent]:
        """Account one call on ``channel``; apply side-effecting faults
        (sleep, signal), raise injected errors, and return the events the
        caller must apply to the call's OUTPUT (the ``nan`` poisons)."""
        out: list[FaultEvent] = []
        raise_exc: InjectedFault | None = None
        for e in self._tick(channel, tag):
            if e.kind == "slow":
                self._sleep(e.factor)
            elif e.kind == "signal":
                self._kill(os.getpid(), e.signum)
            elif e.kind == "nan":
                out.append(e)
            elif e.kind == "error" and raise_exc is None:
                raise_exc = InjectedDispatchError(
                    f"injected dispatch error (call "
                    f"{self.calls(channel)} on {channel!r}, tag {tag!r})")
            elif e.kind == "compile_error" and raise_exc is None:
                raise_exc = InjectedCompileError(
                    f"injected compile error (call "
                    f"{self.calls(channel)} on {channel!r}, tag {tag!r})")
        if raise_exc is not None:
            raise raise_exc
        return out

    # -- output corruption ---------------------------------------------------

    @staticmethod
    def corrupt(y, events: Sequence[FaultEvent]):
        """Apply the returned ``nan`` events to a batch output ``y``
        (leading dim = batch rows).  Returns a poisoned copy: a clone on
        the tensor's device, or a numpy copy; no events -> ``y``
        unchanged."""
        if not events:
            return y
        out = y.clone() if torch.is_tensor(y) else np.array(y, copy=True)
        for e in events:
            for r in e.rows:
                if 0 <= r < out.shape[0]:
                    out[r] = e.fill
        return out

    # -- wrappers ------------------------------------------------------------

    def wrap_schedule(self, apply: Callable, tag: str = "") -> Callable:
        """Wrap a compiled schedule (or any callable): scripted dispatch
        errors raise, slow events sleep, nan events poison the output."""
        def wrapped(*args, **kw):
            events = self.on_call("dispatch", tag)
            y = apply(*args, **kw)
            return self.corrupt(y, events)
        return wrapped

    def wrap_step(self, step_fn: Callable) -> Callable:
        """Wrap a training step function on the ``step`` channel: slow
        events sleep before the step (straggler injection), signal events
        deliver ``signum`` to this process (preemption injection)."""
        def wrapped(*args, **kw):
            self.on_call("step")
            return step_fn(*args, **kw)
        return wrapped


class FaultyEngine:
    """A ``UniformEngine`` proxy whose op calls run through a
    ``FaultScript``'s dispatch channel — "wraps any engine".  Planning,
    config and the plan cache pass through untouched, so a ``FaultyEngine``
    drops into any code path that takes an engine."""

    def __init__(self, engine, script: FaultScript):
        self.engine = engine
        self.script = script

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def _op(self, name, *args, **kw):
        events = self.script.on_call("dispatch",
                                     f"{self.engine.config.method}:{name}")
        y = getattr(self.engine, name)(*args, **kw)
        return self.script.corrupt(y, events)

    def conv(self, *args, **kw):
        return self._op("conv", *args, **kw)

    def deconv(self, *args, **kw):
        return self._op("deconv", *args, **kw)

    def __call__(self, layer, x, w, b=None):
        # as the reference's: w_scale and the layer's precision override
        # are not passed on
        op = self.deconv if layer.op == "deconv" else self.conv
        epi = layer.epilogue
        return op(x, w, layer.stride, layer.padding, dilation=layer.dilation,
                  groups=layer.groups, bias=b, activation=epi.activation,
                  alpha=epi.alpha)


def _host(y) -> np.ndarray:
    if torch.is_tensor(y):
        if y.dtype == torch.bfloat16:       # numpy has no bfloat16
            y = y.to(torch.float32)
        return y.detach().cpu().numpy()
    return np.asarray(y)


def has_poison(y) -> bool:
    """True when a served output carries NaN/Inf (the output guard)."""
    arr = _host(y)
    if not np.issubdtype(arr.dtype, np.floating):
        return False
    return not bool(np.isfinite(arr).all())


def poisoned_rows(y) -> list[int]:
    """Batch rows of ``y`` (leading dim) containing NaN/Inf."""
    arr = _host(y)
    if not np.issubdtype(arr.dtype, np.floating):
        return []
    flat = np.isfinite(arr.reshape(arr.shape[0], -1)).all(axis=1)
    return [i for i, ok in enumerate(flat) if not ok]
