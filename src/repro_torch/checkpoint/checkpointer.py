"""Atomic, async, validated checkpoints (JAX ``checkpoint/checkpointer.py``).

Layout:  <dir>/step_<N>/leaf_<i>.npy + manifest.json
  * atomic: written into ``step_<N>.tmp`` then renamed — a crash mid-write
    never corrupts the latest checkpoint (restart scans for the newest
    directory whose manifest validates).
  * async: ``save`` copies the tensors to the host, then hands the writing
    to a thread so the train loop is not blocked on disk.
  * validated: the manifest records each leaf's shape, dtype, byte size
    and a cheap checksum; a mismatch marks the checkpoint invalid and a
    restart falls back to the previous one.

Leaves are the tensors of a tree (``repro_torch.tree`` order: params,
AdamW moments, QTensor payloads and scales, the step), stored as numpy
arrays; bfloat16 tensors are stored as their 16-bit patterns and the
manifest keeps the torch dtype.

Checkpoints hold full tensors.  A ``Checkpointer`` made with ``specs``
(a partition-spec tree of the saved tree) and a ``sharding.mesh.Mesh``
saves a partitioned tree whole: every rank gathers each leaf's blocks
(a collective: all of them call ``save``) and rank 0 writes; ``wait``
ends with a barrier, so every rank then sees the written checkpoint.
Without a mesh, under a world of replicated params, one rank saves.
``restore`` with specs and a mesh gives each rank of any world size its
own block of every leaf (elastic rescale): a checkpoint written by 2
ranks restores on 1 and on 4.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as _tree
from repro_torch.sharding import mesh as _mesh
from repro_torch.sharding.partition import (
    is_logical_leaf,
    local_block,
    logical_to_spec,
    spec_axes,
)


def _cheap_checksum(a: np.ndarray) -> int:
    # first/last bytes + length — catches truncation and swaps without a
    # full hash over large arrays (nor a copy of them)
    b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return zlib.adler32(b[:4096].tobytes() + b[-4096:].tobytes()) ^ b.size


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that the caller may go on changing (one copy:
    a card tensor's ``cpu()`` is one already)."""
    h = t.detach().cpu()
    if h.dtype == torch.bfloat16:
        h = h.view(torch.int16)
    return h.numpy().copy() if t.device.type == "cpu" else h.numpy()


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, async_save: bool = True,
                 keep: int = 3, keep_last_n: int | None = None,
                 specs=None, mesh=None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_save = async_save
        # keep_last_n is the GC window (alias of ``keep``); the newest
        # VALID checkpoint survives GC regardless of the window
        self.keep = keep if keep_last_n is None else keep_last_n
        if self.keep < 1:
            raise ValueError(f"keep_last_n must be >= 1, got {self.keep}")
        self._thread: threading.Thread | None = None
        if specs is not None and mesh is None:
            raise ValueError("a partitioned checkpointer needs the mesh")
        self.specs, self.mesh = specs, mesh

    @property
    def keep_last_n(self) -> int:
        return self.keep

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False):
        leaves = _tree.leaves(tree)
        if self.specs is not None:
            leaves = [self._whole(t, spec) for t, spec in zip(
                leaves, _tree.leaves(self.specs, is_leaf=is_logical_leaf))]
            if self.mesh.rank != 0:
                return
        host = [(_to_host(t), _dtype_name(t.dtype)) for t in leaves]
        if self.async_save and not blocking:
            self._join()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = _mesh.gather(t, self.mesh, spec_axes(entry), dim)
        return t

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self):
        """The pending write done (on every rank of a partitioned
        checkpointer: a barrier)."""
        self._join()
        if (self.mesh is not None and self.mesh.groups is not None
                and dist.get_world_size() > 1):
            dist.barrier()

    def _write(self, step: int, host):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (a, dtype) in enumerate(host):
            np.save(tmp / f"leaf_{i:05d}.npy", a)
            manifest["leaves"].append({
                "shape": list(a.shape), "dtype": dtype,
                "npy_dtype": str(a.dtype), "bytes": int(a.nbytes),
                "checksum": _cheap_checksum(a)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        """Prune to the last ``keep_last_n`` checkpoints, never the newest
        VALID one; each removal renames into a ``.tmp`` trash name first,
        so a crash mid-delete leaves nothing a restart could pick up."""
        steps = sorted(self.all_steps())
        if len(steps) <= self.keep:
            return
        newest_valid = self.latest_valid_step()
        for s in steps[:-self.keep]:
            if s == newest_valid:
                continue
            final = self.dir / f"step_{s:08d}"
            trash = self.dir / f"step_{s:08d}.gc.tmp"
            try:
                if trash.exists():
                    shutil.rmtree(trash, ignore_errors=True)
                os.rename(final, trash)
            except OSError:
                continue
            shutil.rmtree(trash, ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_valid_step(self):
        for s in reversed(self.all_steps()):
            if self.validate(s):
                return s
        return None

    def validate(self, step: int) -> bool:
        d = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            for i, spec in enumerate(manifest["leaves"]):
                a = np.load(d / f"leaf_{i:05d}.npy", mmap_mode="r")
                if (list(a.shape) != spec["shape"]
                        or str(a.dtype) != spec["npy_dtype"]
                        or int(a.nbytes) != spec["bytes"]):
                    return False
            return True
        except Exception:
            return False

    def restore(self, step: int, template, specs=None, mesh=None):
        """A tree shaped like ``template`` from the checkpoint at
        ``step``; each leaf lands on its template leaf's device.

        ``specs`` (a tree matching ``template`` whose leaves are tuples of
        logical axis names or mesh axis names, one per leading dim; the
        checkpointer's own by default) with ``mesh`` gives each leaf as
        this rank's block: a dim named by an axis is cut into that axis's
        extent and the rank keeps the block at its coordinate, whatever
        world size saved the checkpoint.  A dim the axis does not divide
        stays whole (``sharding.logical_to_spec``).  A template leaf may
        have the whole shape or the block's."""
        if specs is None:
            specs, mesh = self.specs, self.mesh
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        tmpl = _tree.leaves(template)
        if len(tmpl) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint {step} holds "
                             f"{len(manifest['leaves'])} leaves, the "
                             f"template {len(tmpl)}")
        spec_leaves = ([None] * len(tmpl) if specs is None
                       else _tree.leaves(specs, is_leaf=is_logical_leaf))
        if len(spec_leaves) != len(tmpl):
            raise ValueError(f"{len(spec_leaves)} specs for "
                             f"{len(tmpl)} leaves")
        if specs is not None and mesh is None:
            raise ValueError("restoring by specs needs the mesh")
        leaves = []
        for i, (meta, t, spec) in enumerate(zip(manifest["leaves"], tmpl,
                                                spec_leaves)):
            a = np.load(d / f"leaf_{i:05d}.npy", mmap_mode="r")
            if spec is not None:
                block = local_block(a, logical_to_spec(mesh, spec, a.shape),
                                    mesh)
                if list(t.shape) not in (meta["shape"], list(block.shape)):
                    raise ValueError(f"leaf {i}: checkpoint shape "
                                     f"{meta['shape']} (block "
                                     f"{list(block.shape)}) != "
                                     f"{list(t.shape)}")
                a = block
            elif list(t.shape) != meta["shape"]:
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{meta['shape']} != {list(t.shape)}")
            leaves.append(_from_host(a, meta["dtype"], t.device))
        return _tree.unflatten(template, leaves)
