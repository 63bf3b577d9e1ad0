"""Batched LM serving loop (JAX ``runtime/serve_loop.py``): request queue
-> padded batch -> prefill -> decode.

Requests accumulate in a bounded queue; a batch of up to ``max_batch``
prefills together and decodes lock-step for the largest
``max_new_tokens`` it holds.  The admission path is the port's shared
serving primitives (``runtime.serving``): ``submit`` raises
``QueueFullError`` at ``max_queue`` and ``InvalidRequestError`` for an
empty or over-long prompt, and expired requests complete with
``DeadlineExceededError`` in ``expired_log``.  ``stats()`` exposes the
counters; the instruments keep the reference's names
(``lm_rejected_total``, ``lm_queue_wait_seconds``, ``lm_step_seconds``,
``lm_queue_depth``).

The batch keeps the reference's behaviour: prompts are left-padded with
token 0 and attended over with no mask, positions counting from 0 across
the pads, so a request's tokens depend on its batch-mates' prompt
lengths (an SSM's prefill state runs over the unmasked pads too).
Prefill runs f32 and returns an f32 cache; ``splice`` casts its keys and
values into the bf16 decode cache and hands over its recurrent states
(xLSTM, the hybrid's Mamba-2 layers) and Whisper's cross keys and values
as they are, f32.  ``step`` makes ``max_new`` decode calls and drops the
last call's token.  The decode cache is written in place on the device.
Everything runs on ``device`` (the card by default), where the
parameters must already be.  The reference's ``extra_batch`` argument,
which it stores and never reads, has no counterpart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.runtime.serving import (
    DeadlineExceededError,
    InvalidRequestError,
    RequestQueue,
)


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1           # read by no path, as in the reference
    deadline_s: float | None = None


class Server:
    def __init__(self, params, cfg: ModelConfig, max_batch: int = 8,
                 max_len: int = 256, max_queue: int = 64,
                 telemetry: "_obs.Telemetry | None" = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        T.check_family(cfg)
        self.device = torch.device(device)
        where = params["embed"].device
        if where.type != self.device.type:
            raise ValueError(f"the parameters are on {where}, the server "
                             f"on {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self._queue = RequestQueue(max_queue, clock)
        self.telemetry = (telemetry if telemetry is not None
                          else _obs.Telemetry.create())
        self._rejected = self.telemetry.counter("lm_rejected_total")
        self._queue_wait = self.telemetry.histogram("lm_queue_wait_seconds")
        self._step_time = self.telemetry.histogram("lm_step_seconds")
        # expired requests complete here with their typed error:
        # (Request, DeadlineExceededError) pairs
        self.expired_log: list[tuple[Request, DeadlineExceededError]] = []

    def _prefill(self, params, batch):
        return T.forward(params, self.cfg, batch, mode="prefill",
                         param_dtype=torch.float32)

    def _decode(self, params, cache, batch):
        logits, cache = T.forward(params, self.cfg, batch, mode="decode",
                                  cache=cache, param_dtype=torch.float32)
        return torch.argmax(logits[:, -1], dim=-1), cache

    def submit(self, req: Request):
        """Validate + enqueue.  Raises ``InvalidRequestError`` for an
        empty prompt or one whose prompt + generation can't fit the
        serving window, ``QueueFullError`` when the bounded queue sheds."""
        if not req.prompt:
            self._rejected.inc()
            raise InvalidRequestError("empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            self._rejected.inc()
            raise InvalidRequestError(
                f"prompt ({len(req.prompt)} tokens) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the serving window "
                f"max_len={self.max_len}")
        self._queue.submit(req, deadline_s=req.deadline_s)

    def _pad_batch(self, reqs):
        lens = [len(r.prompt) for r in reqs]
        s = max(lens)
        toks = np.zeros((len(reqs), s), np.int64)
        for i, r in enumerate(reqs):
            toks[i, -len(r.prompt):] = r.prompt     # left-pad
        return torch.from_numpy(toks).to(self.device), lens

    def _sweep(self):
        now = self._queue.clock()
        for t in self._queue.sweep_expired():
            self.expired_log.append((t.item, DeadlineExceededError(
                f"request expired after {now - t.submitted:.3f}s in queue")))

    @torch.inference_mode()
    def step(self) -> list[list[int]]:
        """Serve one batch from the queue; returns generated tokens per
        request (in submit order).  Expired requests are swept into
        ``expired_log`` with their typed error first."""
        self._sweep()
        tickets = self._queue.take(self.max_batch)
        if not tickets:
            return []
        t_start = time.perf_counter()
        now = self._queue.clock()
        for t in tickets:
            self._queue_wait.observe(now - t.submitted)
        reqs = [t.item for t in tickets]
        tokens, lens = self._pad_batch(reqs)
        b, s = tokens.shape
        batch = {"tokens": tokens, **self._extra_for(b, s)}
        logits_last, prefill_cache = self._prefill(self.params, batch)
        tok = torch.argmax(logits_last[:, -1], dim=-1)

        # decode continues against a fixed-size cache: the prefill kv
        # spliced into a max_len cache (pos = s)
        cache = T.init_cache(self.params, self.cfg, b, self.max_len)
        cache = self._splice(cache, prefill_cache, s)

        max_new = max(r.max_new_tokens for r in reqs)
        toks = []
        for _ in range(max_new):
            toks.append(tok)
            dbatch = {"tokens": tok[:, None], **self._extra_for(b, 1)}
            tok, cache = self._decode(self.params, cache, dbatch)
        # one copy to the host, after the last decode call as well
        rows = torch.stack([*toks, tok], dim=1).tolist()
        self._step_time.observe(time.perf_counter() - t_start)
        return [row[:r.max_new_tokens] for row, r in zip(rows, reqs)]

    @property
    def rejected(self) -> int:
        return int(self._rejected.value)

    def stats(self) -> dict:
        """Queue depth + the shed/expired/rejected counters."""
        self.telemetry.gauge("lm_queue_depth").set(self._queue.depth)
        return {
            "queue_depth": self._queue.depth,
            "submitted": self._queue.submitted,
            "shed": self._queue.shed,
            "expired": self._queue.expired,
            "rejected": self.rejected,
        }

    def _extra_for(self, b, s):
        extra = {}
        if self.cfg.family == "encdec":
            # the stub frontend's frame embeddings
            extra["enc_embeds"] = torch.zeros(
                (b, self.cfg.enc_seq, self.cfg.d_model), device=self.device)
        if self.cfg.mrope:
            extra["mrope_positions"] = torch.arange(
                s, device=self.device)[None, None].expand(3, b, s)
        return extra

    def _splice(self, cache, prefill_cache, s: int):
        return splice(cache, prefill_cache, s)


def splice(cache, prefill_cache, s: int):
    """The serving cache with the prefill's in it at positions [0, s):
    the kv copied in (``[L or G, B, T, H, hd]``, cast to the cache's
    dtype), ``states`` (xLSTM), ``ssm`` (hybrid) and ``cross`` (Whisper)
    replaced by the prefill's."""
    out = dict(cache)
    if "kv" in prefill_cache:
        for big, small in zip(cache["kv"], prefill_cache["kv"]):
            big[:, :, :s] = small.to(big.dtype)
    for key in ("states", "ssm", "cross"):
        if key in prefill_cache:
            out[key] = prefill_cache[key]
    out["pos"] = s
    return out
