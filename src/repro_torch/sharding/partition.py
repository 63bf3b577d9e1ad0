"""Logical axis names and the partition specs they resolve to (the DCNN
half of JAX ``sharding/partition.py``).

Parameters carry logical axis names per dim; ``logical_to_spec`` resolves
them against a mesh (``repro_torch.sharding.mesh.Mesh``, or anything with
``axis_names`` and a ``shape`` dict), dropping a mapping whose mesh extent
does not divide the dim, so an awkward layer stays replicated as real
tensor-parallel deployments keep it.  A partition spec is a plain tuple
with one mesh axis name (or ``None``, or a tuple of names) per dim,
trailing ``None``s dropped: the port's ``PartitionSpec``.

Logical axes:
  batch   -> ("pod", "data") when the pod axis exists, else ("data",)
  fsdp    -> the batch axes, only when the config enables FSDP
  model   -> "model"          (channel / tensor parallelism)
  seq     -> "data"
  None    -> replicated

The LM stack's weight-with-spec leaves (``WS``, ``split_params``,
``param_shardings``) come with the LM port.
"""

from __future__ import annotations

from typing import Sequence


def mesh_axes(mesh) -> dict[str, tuple[str, ...]]:
    names = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in names)
    return {"batch": batch, "fsdp": batch,
            "model": ("model",) if "model" in names else (),
            "seq": ("data",) if "data" in names else ()}


def _axis_size(mesh, axes: Sequence[str]) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def logical_to_spec(mesh, logical: Sequence[str | None],
                    dims: Sequence[int] | None = None,
                    fsdp_enabled: bool = True) -> tuple:
    """Resolve logical axis names to a partition spec, dropping any mapping
    that does not divide the corresponding dim.  A mesh axis name resolves
    to itself, so a partition spec passes through unchanged."""
    table = mesh_axes(mesh)
    entries = []
    for i, name in enumerate(logical):
        if name is None or (name == "fsdp" and not fsdp_enabled):
            entries.append(None)
            continue
        axes = table.get(name, (name,) if name in mesh.axis_names else ())
        if not axes or (dims is not None
                        and dims[i] % _axis_size(mesh, axes) != 0):
            entries.append(None)
            continue
        entries.append(axes[0] if len(axes) == 1 else tuple(axes))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def conv_weight_axes(rank: int, *, cin: str | None = None,
                     cout: str | None = "model") -> tuple[str | None, ...]:
    """Logical axes of a conv/deconv weight ``[*K, Cin, Cout]``: the taps
    replicated, the channel dims named as given."""
    return (None,) * rank + (cin, cout)


def constrain(x, *logical: str | None):
    """The JAX package's sharding constraint on an activation, by logical
    names.  Eager PyTorch has no sharding constraint to hand a compiler:
    each rank holds its own shard already, so ``x`` passes through."""
    return x
