"""Marks on the device's own clock.

On the card a mark is a CUDA event recorded on the current stream, so
the time it reads is when the device reached it, whatever the host was
doing; the window's first mark is recorded on an idle stream, so host
and device start together.  On the CPU, where the plain versions run
synchronously, a mark is the host clock."""

from __future__ import annotations

import time

import torch


class Clock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.t0 = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        """Drain the device, then mark the window's start."""
        self.sync()
        self.t0 = self.mark()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def ms(self, mark) -> float:
        """Milliseconds from the start to ``mark`` (reached)."""
        if self.cuda:
            return self.t0.elapsed_time(mark)
        return (mark - self.t0) * 1e3
