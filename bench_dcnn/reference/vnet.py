"""V-Net (Milletari et al., arXiv:1606.04797, on the FPGA paper's
uniform 3x3x3 mapping) as ``configs/vnet.json`` describes it, in plain
PyTorch.

The encoder is one 3^d conv a stage (stride 1, then 2), padding 1, relu;
each decoder stage a 3^d stride-2 deconv cropped by (0, 1) (relu), the
concatenation ``[up, skip]`` along channels, and a 3^d merge conv
(relu); a 1^d conv head gives the class logits.  The weight tree is
``{"vnet": {"enc": [{"w"}], "dec": [{"up_w", "merge_w"}], "head"}}``,
weights ``[*K, Cin, Cout]``.  The loss is dice on the foreground
probability plus the voxels' binary cross-entropy."""

from __future__ import annotations

import math

import torch

from bench_dcnn.reference import layers as L
from bench_dcnn.reference.numerics import map_tree, named_leaves


def nodes(cfg: dict) -> list[dict]:
    """The graph in execution order: each layer with its shapes, its
    weight's path in the tree and its input (``"input"`` or a node);
    each concatenation with its two inputs."""
    depth = cfg["convs_per_stage"]
    if set(depth["encoder"] + depth["decoder"]) != {1} or cfg["residual_add"]:
        raise ValueError("this reference holds one conv a stage and no "
                         "residual add")
    k = cfg["kernel"]
    sp, ci = tuple(cfg["in_spatial"]), cfg["in_channels"]
    rank = len(sp)
    out, prev, enc = [], "input", []

    def layer(name, src, co, kern, stride, pad, act, weight):
        nonlocal sp, ci
        d = {"name": name, "op": "conv" if pad != "crop" else "deconv",
             "input": src, "in_spatial": sp, "cin": ci, "cout": co,
             "kernel": (kern,) * rank, "stride": (stride,) * rank,
             "padding": ((0, 1) if pad == "crop" else (pad, pad),) * rank,
             "activation": act, "weight": weight, "bias": None}
        d["out_spatial"] = L.out_spatial(d["op"], sp, d["kernel"],
                                         d["stride"], d["padding"])
        out.append(d)
        sp, ci = d["out_spatial"], co
        return name

    for i, co in enumerate(cfg["channels"]):
        prev = layer(f"enc{i + 1}", prev, co, k, 1 if i == 0 else 2, 1,
                     "relu", ("vnet", "enc", i, "w"))
        enc.append((prev, co, sp))
    for j, (skip, skip_c, skip_sp) in enumerate(reversed(enc[:-1])):
        up = layer(f"up{j + 1}", prev, skip_c, k, 2, "crop", "relu",
                   ("vnet", "dec", j, "up_w"))
        cat = f"skip{j + 1}"
        out.append({"name": cat, "op": "concat", "inputs": (up, skip),
                    "in_spatial": skip_sp, "cin": 2 * skip_c,
                    "cout": 2 * skip_c, "out_spatial": skip_sp})
        ci = 2 * skip_c
        prev = layer(f"merge{j + 1}", cat, skip_c, k, 1, 1, "relu",
                     ("vnet", "dec", j, "merge_w"))
    layer("head", prev, cfg["num_classes"], 1, 1, 0, "none",
          ("vnet", "head"))
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def forward(cfg: dict, params, x, precision: str = "f32") -> torch.Tensor:
    """vol ``[B, *spatial, Cin]`` -> logits ``[B, *spatial, classes]``,
    float32."""
    vals = {"input": x.to(torch.float32)}
    graph = nodes(cfg)
    for nd in graph:
        if nd["op"] == "concat":
            vals[nd["name"]] = torch.cat([vals[i] for i in nd["inputs"]],
                                         dim=-1)
        else:
            vals[nd["name"]] = L.apply(nd, vals[nd["input"]],
                                       _leaf(params, nd["weight"]),
                                       precision=precision)
    return vals[graph[-1]["name"]]


def loss(logits, labels) -> torch.Tensor:
    """Dice of the foreground probability plus the voxels' binary
    cross-entropy, over the whole batch."""
    probs = torch.softmax(logits.to(torch.float32), -1)[..., 1]
    labels = labels.to(torch.float32)
    inter = torch.sum(probs * labels)
    denom = torch.sum(probs) + torch.sum(labels)
    dice = 1.0 - 2.0 * inter / torch.clamp(denom, min=1e-6)
    ce = -torch.mean(labels * torch.log(probs + 1e-8)
                     + (1 - labels) * torch.log(1 - probs + 1e-8))
    return dice + ce


def infer(cfg: dict, params, inputs, precision: str = "f32"):
    """The served output of one batch of inputs, one volume at a time."""
    return torch.cat([forward(cfg, params, inputs[i:i + 1], precision)
                      for i in range(inputs.shape[0])])


def losses_and_grads(cfg: dict, params, batch, precision: str = "f32"):
    """``({"loss": value}, grads)`` of one training step on ``batch``
    (``{"vol", "labels"}``); ``grads`` has the tree of ``params``."""
    p = map_tree(lambda t: t.detach().to(torch.float32)
                 .requires_grad_(True), params)
    with torch.enable_grad():
        value = loss(forward(cfg, p, batch["vol"], precision),
                     batch["labels"])
        leaves = list(named_leaves(p).values())
        grads = torch.autograd.grad(value, leaves)
    it = iter(grads)
    return {"loss": value.detach()}, map_tree(lambda _: next(it), p)


def work(cfg: dict, kind: str) -> list[tuple[dict, tuple[str, ...]]]:
    """Each node with the passes one batch (``kind="infer"``) or one
    training step (``"train"``) runs on it: ``fwd``, ``dx`` (the input's
    gradient; not for the first layer, whose input is data) and ``dw``."""
    if kind == "infer":
        return [(nd, ("fwd",)) for nd in nodes(cfg)]
    out = []
    for nd in nodes(cfg):
        if nd["op"] == "concat":
            out.append((nd, ("fwd", "dx")))
        elif nd.get("input") == "input":
            out.append((nd, ("fwd", "dw")))
        else:
            out.append((nd, ("fwd", "dx", "dw")))
    return out


def param_specs(cfg: dict, kind: str) -> list[tuple[tuple, tuple, float]]:
    """``(path, shape, std)`` of each weight: He's normal, its fan-in the
    taps that reach one output (a stride-s deconv's ``K / s^d``) times
    the input channels; the head at ``1 / sqrt(fan-in)``."""
    specs = []
    for nd in nodes(cfg):
        if nd["op"] == "concat":
            continue
        taps = math.prod(nd["kernel"])
        if nd["op"] == "deconv":
            taps /= math.prod(nd["stride"])
        gain = 2.0 if nd["activation"] == "relu" else 1.0
        specs.append((nd["weight"], (*nd["kernel"], nd["cin"], nd["cout"]),
                      math.sqrt(gain / (taps * nd["cin"]))))
    return specs


def inputs(cfg: dict, kind: str, count: int, batch: int,
           generator: torch.Generator, device, dtype) -> list:
    """``count`` distinct batches: volumes of normal noise and, to train,
    binary label volumes (each voxel foreground with probability 1/2)."""
    sp = tuple(cfg["in_spatial"])
    vol = torch.randn((count * batch, *sp, cfg["in_channels"]),
                      generator=generator, device=device).to(dtype)
    if kind == "infer":
        return list(vol.split(batch))
    labels = (torch.rand((count * batch, *sp), generator=generator,
                         device=device) < 0.5).to(dtype)
    return [{"vol": v, "labels": y}
            for v, y in zip(vol.split(batch), labels.split(batch))]
