"""A DCGAN generator (Radford et al., arXiv:1511.06434, on the FPGA
paper's uniform 3x3 deconvs) as ``configs/dcgan.json`` describes it, in
plain PyTorch, for inference.

``z @ proj``, reshaped to ``[B, *start, C0]`` (channels last), relu,
then stride-2 deconvs cropped by ``crop`` per dim, each with a bias,
relu on the hidden layers and tanh on the last.  The weight tree is
``{"gen": {"proj", "deconvs": [{"w", "b"}]}}``."""

from __future__ import annotations

import math

import torch

from bench_dcnn.reference import layers as L


def gen_nodes(cfg: dict) -> list[dict]:
    sp = tuple(cfg["start_spatial"])
    rank, chans = len(sp), cfg["channels"]
    out = []
    for i in range(len(chans) - 1):
        d = {"name": f"deconv{i + 1}", "op": "deconv", "in_spatial": sp,
             "cin": chans[i], "cout": chans[i + 1],
             "kernel": (cfg["kernel"],) * rank,
             "stride": (cfg["stride"],) * rank,
             "padding": (tuple(cfg["crop"]),) * rank,
             "activation": "tanh" if i == len(chans) - 2 else "relu",
             "weight": ("gen", "deconvs", i, "w"),
             "bias": ("gen", "deconvs", i, "b")}
        d["out_spatial"] = L.out_spatial("deconv", sp, d["kernel"],
                                         d["stride"], d["padding"])
        out.append(d)
        sp = d["out_spatial"]
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def generate(cfg: dict, params, z, precision: str = "f32"):
    """z ``[B, z_dim]`` -> images ``[B, *spatial, C]`` in (-1, 1)."""
    c0 = cfg["channels"][0]
    h = L.matmul(z, params["gen"]["proj"], precision)
    h = torch.relu(h.reshape(h.shape[0], *cfg["start_spatial"], c0))
    for nd in gen_nodes(cfg):
        h = L.apply(nd, h, _leaf(params, nd["weight"]),
                    _leaf(params, nd["bias"]), precision)
    return h


def infer(cfg: dict, params, inputs, precision: str = "f32"):
    """The generated images of one batch of z vectors, in blocks of 256."""
    return torch.cat([generate(cfg, params, inputs[i:i + 256], precision)
                      for i in range(0, inputs.shape[0], 256)])


def _proj(cfg: dict) -> dict:
    start = tuple(cfg["start_spatial"])
    n = math.prod(start) * cfg["channels"][0]
    return {"name": "proj", "op": "matmul", "m_per_sample": 1,
            "k": cfg["z_dim"], "n": n}


def _infer_only(kind: str) -> None:
    if kind != "infer":
        raise ValueError(f"the DCGAN reference serves inference, not "
                         f"{kind!r}")


def work(cfg: dict, kind: str) -> list[tuple[dict, tuple[str, ...]]]:
    """Each node with the passes one batch of the generator runs."""
    _infer_only(kind)
    return [(_proj(cfg), ("fwd",))] + [(nd, ("fwd",))
                                       for nd in gen_nodes(cfg)]


def param_specs(cfg: dict, kind: str) -> list[tuple[tuple, tuple, float]]:
    """``(path, shape, std)`` of each weight: He's normal, its fan-in the
    taps that reach one output (a stride-s deconv's ``K / s^d``) times
    the input channels (the tanh layer at gain 1); the biases at 0.1."""
    _infer_only(kind)
    z, c0 = cfg["z_dim"], cfg["channels"][0]
    n0 = math.prod(cfg["start_spatial"]) * c0
    specs = [(("gen", "proj"), (z, n0), math.sqrt(2.0 / z))]
    for nd in gen_nodes(cfg):
        taps = math.prod(nd["kernel"]) / math.prod(nd["stride"])
        gain = 2.0 if nd["activation"] == "relu" else 1.0
        specs.append((nd["weight"], (*nd["kernel"], nd["cin"], nd["cout"]),
                      math.sqrt(gain / (taps * nd["cin"]))))
        specs.append((nd["bias"], (nd["cout"],), 0.1))
    return specs


def inputs(cfg: dict, kind: str, count: int, batch: int,
           generator: torch.Generator, device, dtype) -> list:
    """``count`` distinct batches of normal z vectors."""
    _infer_only(kind)
    z = torch.randn((count * batch, cfg["z_dim"]), generator=generator,
                    device=device).to(dtype)
    return list(z.split(batch))
