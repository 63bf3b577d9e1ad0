"""Fault-tolerant training loop (JAX ``runtime/train_loop.py``).

  * checkpoint every N steps, async (writer thread off the critical path),
    atomic (tmp dir + rename), validated manifests; the final checkpoint
    is not written again when the last step's is already there and
    valid;
  * SIGTERM/SIGINT -> finish the in-flight step, write a final checkpoint,
    exit cleanly (preemption handling);
  * restart: scan for the newest *valid* checkpoint, restore params +
    optimizer state and the step counter, continue (the data pipeline is
    restartable from a step index);
  * straggler watchdog: per-step wall-time EMA; steps slower than
    ``straggler_factor x EMA`` are logged and counted.

A step's time is taken on the host clock around the step function and a
``torch.cuda.synchronize()`` (the JAX loop's ``block_until_ready``), so it
covers the card's work.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time

import torch

from repro_torch import tree as _tree
from repro_torch.checkpoint import Checkpointer


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    checkpoint_dir: str = "checkpoints"
    async_checkpoint: bool = True


def _block_until_ready(tree) -> None:
    devices = {t.device for t in _tree.leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class Trainer:
    def __init__(self, step_fn, params, opt_state, data,
                 loop_cfg: TrainLoopConfig, telemetry=None, specs=None,
                 mesh=None):
        """step_fn(params, opt_state, batch) -> (params, opt_state, metrics);
        data.next() -> batch; data restartable from a step index.
        ``telemetry`` (a ``repro_torch.obs.Telemetry``) records a
        ``train_step_seconds`` histogram, a ``train_stragglers_total``
        counter and per-metric gauges at log points.  ``specs`` (the
        partition specs of ``{"params": ..., "opt": ...}``) and ``mesh``
        make the checkpoints whole trees of the ranks' blocks
        (``Checkpointer``); every rank then runs the loop."""
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.cfg = loop_cfg
        self.telemetry = telemetry
        self._step_hist = (telemetry.histogram("train_step_seconds")
                           if telemetry is not None else None)
        self._straggler_ctr = (telemetry.counter("train_stragglers_total")
                               if telemetry is not None else None)
        self.ckpt = Checkpointer(loop_cfg.checkpoint_dir,
                                 async_save=loop_cfg.async_checkpoint,
                                 specs=specs, mesh=mesh)
        self.step = 0
        self._saved_step = None
        self.metrics_log: list[dict] = []
        self._ema = None
        self.straggler_events = 0
        self._preempted = False
        self._orig_handlers = {}

    # -- fault-tolerance hooks -----------------------------------------------

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig_handlers[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread

    def _restore_signal_handlers(self):
        for sig, h in self._orig_handlers.items():
            signal.signal(sig, h)
        self._orig_handlers = {}

    def maybe_resume(self):
        """Restore the newest valid checkpoint if one exists."""
        latest = self.ckpt.latest_valid_step()
        if latest is None:
            return False
        state = self.ckpt.restore(
            latest, {"params": self.params, "opt": self.opt_state})
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = latest
        return True

    def _checkpoint(self, blocking=False):
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state}, blocking=blocking)
        self._saved_step = self.step

    # -- loop -----------------------------------------------------------------

    def run(self):
        self._install_signal_handlers()
        try:
            while self.step < self.cfg.total_steps and not self._preempted:
                batch = self.data.next()
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                _block_until_ready(metrics)
                dt = time.perf_counter() - t0
                self.step += 1
                if self._step_hist is not None:
                    self._step_hist.observe(dt)

                # straggler watchdog
                if self._ema is None:
                    self._ema = dt
                slow = dt > self.cfg.straggler_factor * self._ema \
                    and self.step > 3
                if slow:
                    self.straggler_events += 1
                    if self._straggler_ctr is not None:
                        self._straggler_ctr.inc()
                    print(f"[watchdog] step {self.step} took {dt:.3f}s "
                          f"(EMA {self._ema:.3f}s) — straggler #"
                          f"{self.straggler_events}")
                self._ema = 0.9 * self._ema + 0.1 * dt

                if self.step % self.cfg.log_every == 0 or slow:
                    rec = {"step": self.step, "dt_s": dt,
                           **{k: float(v) for k, v in metrics.items()}}
                    self.metrics_log.append(rec)
                    print(json.dumps(rec))
                    if self.telemetry is not None:
                        for k, v in rec.items():
                            if k != "step":
                                self.telemetry.gauge(
                                    f"train_{k}").set(float(v))
                if self.step % self.cfg.checkpoint_every == 0:
                    self._checkpoint()
        finally:
            # preemption or normal exit: final blocking checkpoint, unless
            # the step just written asynchronously is there and valid (the
            # reference writes it a second time: 14.8 GB for llama3.2-1b)
            self.ckpt.wait()
            if not (self._saved_step == self.step
                    and self.ckpt.validate(self.step)):
                self._checkpoint(blocking=True)
            if hasattr(self.data, "close"):
                self.data.close()
            self._restore_signal_handlers()
        return self.params, self.opt_state
