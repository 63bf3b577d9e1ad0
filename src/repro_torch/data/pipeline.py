"""Deterministic synthetic batches (JAX ``data/pipeline.py``): LM tokens,
GAN and V-Net batches.

Every batch is a pure function of (seed, step) (and, for the LM stream,
the process index), made with the same numpy ``RandomState`` recipe as
the JAX package, so one seed gives the same batches in both packages and
a run restarts from any step with no data state beyond the step
counter.  A background thread keeps one batch ahead
of the step function; batches are made as CPU tensors there and moved to
``device`` (``"cuda"`` unless the caller asks for the CPU) in ``next``.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class _Prefetcher:
    """One-batch-deep background prefetch."""

    def __init__(self, make_batch, start_step: int):
        self._make = make_batch
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self._make(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class _Batches:
    def __init__(self, seed: int, start_step: int, prefetch: bool, device):
        self.seed = seed
        self.device = torch.device(device)
        self._step = start_step
        self._pf = (_Prefetcher(self._host_batch, start_step) if prefetch
                    else None)

    def _host_batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v)
                for k, v in self.numpy_batch(step).items()}

    def make_batch(self, step: int) -> dict:
        return {k: v.to(self.device) for k, v in
                self._host_batch(step).items()}

    def next(self) -> dict:
        if self._pf is not None:
            batch = self._pf.next()
        else:
            batch = self._host_batch(self._step)
            self._step += 1
        return {k: v.to(self.device) for k, v in batch.items()}

    def close(self):
        if self._pf:
            self._pf.close()


def _process() -> tuple[int, int]:
    """(index, count) of this process in the ``torch.distributed`` world,
    (0, 1) when none is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class TokenBatches(_Batches):
    """Synthetic LM token stream: {tokens, labels} (int32, [B, S]) with
    next-token labels; each process of a world makes its own shard of the
    global batch.  ``extra_fn(step, local_batch, seq_len)`` adds entries
    (numpy arrays: Whisper's frames, M-RoPE positions)."""

    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, start_step: int = 0, prefetch: bool = True,
                 extra_fn=None, device="cuda"):
        self.vocab = vocab
        self.process_index, n_proc = _process()
        if global_batch % n_proc:
            raise ValueError(f"global batch {global_batch} is not a "
                             f"multiple of the {n_proc} processes")
        self.local_batch = global_batch // n_proc
        self.seq_len = seq_len
        self.extra_fn = extra_fn
        super().__init__(seed, start_step, prefetch, device)

    def numpy_batch(self, step: int) -> dict:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 7919 + self.process_index)
            % (2 ** 31))
        # a learnable toy language: token t+1 = (a*t + b) mod vocab per row
        a = rng.randint(1, 8, size=(self.local_batch, 1))
        b = rng.randint(0, self.vocab, size=(self.local_batch, 1))
        pos = np.arange(self.seq_len + 1)[None, :]
        seq = (a * pos + b) % self.vocab
        batch = {"tokens": seq[:, :-1].astype(np.int32),
                 "labels": seq[:, 1:].astype(np.int32)}
        if self.extra_fn is not None:
            batch.update(self.extra_fn(step, self.local_batch,
                                       self.seq_len))
        return batch


class DcnnBatches(_Batches):
    """GAN batches: {z, real} (real = smoothed random images)."""

    def __init__(self, batch: int, z_dim: int, out_shape, seed: int = 0,
                 start_step: int = 0, prefetch: bool = True,
                 device="cuda"):
        self.batch, self.z_dim, self.out_shape = batch, z_dim, tuple(out_shape)
        super().__init__(seed, start_step, prefetch, device)

    def numpy_batch(self, step: int) -> dict:
        rng = np.random.RandomState((self.seed + step * 7919) % (2 ** 31))
        z = rng.randn(self.batch, self.z_dim).astype(np.float32)
        real = np.tanh(rng.randn(self.batch, *self.out_shape)
                       .astype(np.float32))
        return {"z": z, "real": real}


class VolumeBatches(_Batches):
    """V-Net batches: {vol, labels} — spheres to segment."""

    def __init__(self, batch: int, spatial, seed: int = 0,
                 start_step: int = 0, prefetch: bool = True, device="cuda"):
        self.batch, self.spatial = batch, tuple(spatial)
        super().__init__(seed, start_step, prefetch, device)

    def numpy_batch(self, step: int) -> dict:
        rng = np.random.RandomState((self.seed + step * 104729) % (2 ** 31))
        h, w, d = self.spatial
        grid = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                    np.arange(d), indexing="ij"), -1)
        vols, labs = [], []
        for _ in range(self.batch):
            c = rng.rand(3) * np.array([h, w, d])
            r = (0.15 + 0.2 * rng.rand()) * min(h, w, d)
            mask = (np.linalg.norm(grid - c, axis=-1) < r)
            vol = mask.astype(np.float32) + 0.3 * rng.randn(h, w, d)
            vols.append(vol[..., None])
            labs.append(mask.astype(np.int32))
        return {"vol": np.stack(vols).astype(np.float32),
                "labels": np.stack(labs)}
