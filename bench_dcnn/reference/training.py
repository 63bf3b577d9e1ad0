"""AdamW and the first steps of training, followed in plain PyTorch.

AdamW with decoupled weight decay and bias correction:
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)``,
all in float32.  ``follow`` runs a model's ``losses_and_grads`` and this
update over given batches and returns what the benchmark compares: each
step's losses, each leaf's first gradient norm (read back from the first
moment after one step, as it is read from the program's state) and each
leaf's change after the last step."""

from __future__ import annotations

import torch

from bench_dcnn.reference.numerics import map_tree, named_leaves


def adamw(params, grads, m, v, step: int, opt: dict):
    """One AdamW update of flat dicts of leaves, in place."""
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for name, p in params.items():
        g = grads[name].to(torch.float32)
        m[name].mul_(b1).add_(g, alpha=1 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m[name] / bc1) / (torch.sqrt(v[name] / bc2) + opt["eps"])
        p.sub_(opt["lr"] * (delta + opt["weight_decay"] * p))


@torch.no_grad()
def follow(model, cfg: dict, params0, batches, opt: dict,
           precision: str = "f32") -> dict:
    """Train a float32 copy of ``params0`` over ``batches`` with
    ``model.losses_and_grads`` and AdamW."""
    start = {k: t.detach().to(torch.float32).clone()
             for k, t in named_leaves(params0).items()}
    params = {k: t.clone() for k, t in start.items()}
    m = {k: torch.zeros_like(t) for k, t in start.items()}
    v = {k: torch.zeros_like(t) for k, t in start.items()}
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches, 1):
        it = iter(params.values())
        tree = map_tree(lambda _: next(it), params0)
        values, grads = model.losses_and_grads(cfg, tree, batch, precision)
        losses.append({k: float(t) for k, t in values.items()})
        adamw(params, named_leaves(grads), m, v, step, opt)
        if step == 1:
            grad_norms = {k: float(t.norm()) / (1 - opt["b1"])
                          for k, t in m.items()}
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
