"""Analysis-mode flag (JAX ``models/flags.py``), a thin mirror.

The reference's ``UNROLL`` makes every structural loop (the layer scan,
the attention chunk map, the cross-entropy chunk scan) unroll so that
XLA's cost analysis counts each trip.  The port's loops are Python loops
already: every layer and chunk runs, and is counted, one after another.
So ``unrolled()`` changes nothing in the port's models, and
``maybe_scan`` is always a loop, whether ``UNROLL`` is set or not.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch import tree as _tree

UNROLL = False


@contextlib.contextmanager
def unrolled():
    """Set ``UNROLL`` inside the block (the reference's analysis mode)."""
    global UNROLL
    prev = UNROLL
    UNROLL = True
    try:
        yield
    finally:
        UNROLL = prev


def maybe_scan(body, carry, xs):
    """``lax.scan``'s contract in a Python loop: ``body(carry, x_i) ->
    (carry, y_i)`` over the leading dim of ``xs`` (a tree), the ``ys``
    stacked leaf for leaf."""
    n = _tree.leaves(xs)[0].shape[0]
    ys = []
    for i in range(n):
        carry, y = body(carry, _tree.tree_map(lambda a: a[i], xs))
        ys.append(y)
    return carry, _tree.tree_map(
        lambda *zs: torch.stack([torch.as_tensor(z) for z in zs]), *ys)
