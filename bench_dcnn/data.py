"""Weights and inputs from the seed, drawn on the device in a few large
calls: one normal draw for all the weights of a tree, scaled leaf by leaf
and cast to the served type, then cut into views."""

from __future__ import annotations

import math

import torch


def _put(tree, path, value):
    for i, key in enumerate(path[:-1]):
        nxt = [] if isinstance(path[i + 1], int) else {}
        if isinstance(tree, list):
            while len(tree) <= key:
                tree.append(None)
            if tree[key] is None:
                tree[key] = nxt
        else:
            tree.setdefault(key, nxt)
        tree = tree[key]
    key = path[-1]
    if isinstance(tree, list):
        while len(tree) <= key:
            tree.append(None)
    tree[key] = value


def draw_tree(specs, generator: torch.Generator, device, dtype):
    """A tree of weights from ``specs``, ``(path, shape, std)`` each:
    normal draws scaled by ``std``, in ``dtype``."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.float32)
    std = torch.tensor([s for _, _, s in specs], dtype=torch.float32,
                       device=device)
    flat.mul_(torch.repeat_interleave(
        std, torch.tensor(sizes, device=device)))
    flat = flat.to(dtype)
    tree: dict = {}
    for (path, shape, _), chunk in zip(specs, flat.split(sizes)):
        _put(tree, path, chunk.view(shape))
    return tree
