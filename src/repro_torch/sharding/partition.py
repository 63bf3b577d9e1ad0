"""Logical-axis partitioning (DP / FSDP / TP / EP on one mesh; JAX
``sharding/partition.py``).

Parameters carry logical axis names per dim: the initialisers draw a tree
either as values or, with ``device="axes"``, as the same tree of
logical-axis tuples (``launch.steps.param_axes``).  ``WS`` and
``split_params`` are the reference's weight-with-spec leaves, for trees
built that way.  ``logical_to_spec`` resolves names against a mesh
(``repro_torch.sharding.mesh.Mesh``, or anything with ``axis_names`` and
a ``shape`` dict), dropping a mapping whose mesh extent does not divide
the dim, so an awkward leaf stays replicated as real tensor-parallel
deployments keep it (6 Whisper heads on a 4-way model axis, 1 granite
KV head on any).  A partition spec is a plain tuple with one mesh axis
name (or ``None``, or a tuple of names) per dim, trailing ``None``s
dropped: the port's ``PartitionSpec``.  ``param_shardings`` gives a
parameter tree's specs, ``local_block`` / ``shard_tree`` cut whole
tensors to this rank's blocks (row-major over a dim's axes, as JAX lays
them).

Logical axes:
  batch   -> ("pod", "data") when the pod axis exists, else ("data",)
  fsdp    -> the batch axes, only when the config enables FSDP
  model   -> "model"          (TP: heads / ff / vocab / experts)
  seq     -> "data"
  None    -> replicated

``use_mesh(mesh)`` makes ``mesh`` the current one (``current_mesh``),
where the model code looks for it, as the reference's looks for the
``with mesh:`` context (``get_abstract_mesh_or_none``).  It is a plain
module global, not a context variable: the autograd engine runs a
backward (and a checkpoint's recompute) on threads of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Sequence

from repro_torch import tree as _tree


@dataclasses.dataclass
class WS:
    """A weight-with-spec leaf (value + logical axis names per dim)."""
    value: Any
    logical: tuple[str | None, ...]


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


def is_logical_leaf(x) -> bool:
    """A leaf of a logical-axes (or spec) tree: a plain tuple of axis
    names, ``None``s or tuples of names."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def split_params(tree):
    """WS tree -> (value tree, logical-axes tree).  Other leaves pass
    through (their axes: ``()``, fully replicated)."""
    is_ws = lambda x: isinstance(x, WS)  # noqa: E731
    values = _tree.tree_map(lambda w: w.value if is_ws(w) else w, tree,
                            is_leaf=is_ws)
    logical = _tree.tree_map(lambda w: tuple(w.logical) if is_ws(w) else (),
                             tree, is_leaf=is_ws)
    return values, logical


def param_shardings(mesh, values, logical, fsdp_enabled: bool = True):
    """Logical tree + value tree (tensors, or anything with a ``shape``)
    -> the tree of partition specs, one per leaf."""
    leaves = _tree.leaves(logical, is_leaf=is_logical_leaf)
    shapes = [tuple(v.shape) if hasattr(v, "shape") else None
              for v in _tree.leaves(values)]
    if len(leaves) != len(shapes):
        raise ValueError(f"{len(leaves)} logical leaves for {len(shapes)} "
                         f"values")
    return _tree.unflatten(
        logical, [logical_to_spec(mesh, lg, s, fsdp_enabled)
                  for lg, s in zip(leaves, shapes)], is_leaf=is_logical_leaf)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(mesh, spec: Sequence, shape) -> tuple:
    """The index of this rank's block of an array of ``shape`` under a
    partition spec (row-major over a dim's axes, as JAX lays them)."""
    index = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        n, k = 1, 0
        for a in axes:
            n, k = n * mesh.shape[a], k * mesh.shape[a] + mesh.coords[a]
        if n == 1:
            index.append(slice(None))
            continue
        per = shape[dim] // n
        index.append(slice(k * per, (k + 1) * per))
    return tuple(index)


def local_block(t, spec: Sequence, mesh):
    """This rank's block of the whole tensor (or array) ``t`` under
    ``spec``: a view where the block is one."""
    return t[block_index(mesh, spec, t.shape)]


def spec_leaves(specs, like) -> list:
    """``specs`` flattened to the structure of the tree ``like``: the spec
    of each of its leaves, in its leaf order.  (A resolved spec whose
    entries are all axis names reads as a leaf to ``is_logical_leaf``
    even where it is a tuple of specs, as an sLSTM state's three
    ``("data",)`` are; ``like`` tells them apart.)"""
    out = []

    def walk(sp, node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(sp[k], node[k])
        elif isinstance(node, (list, tuple)):
            if len(sp) != len(node):
                raise ValueError(f"{len(sp)} specs for {len(node)} "
                                 f"subtrees")
            for a, b in zip(sp, node):
                walk(a, b)
        else:
            out.append(sp)
    walk(specs, like)
    return out


def shard_tree(tree, specs, mesh):
    """Each leaf of ``tree`` cut to this rank's block by its spec in
    ``specs`` (a spec tree of the same structure)."""
    leaves = _tree.leaves(tree)
    return _tree.unflatten(tree, [local_block(t, s, mesh) for t, s in
                                  zip(leaves, spec_leaves(specs, tree))])


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


_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh inside the block (``None``: no
    mesh)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or ``None``."""
    return _CURRENT[-1] if _CURRENT else None
