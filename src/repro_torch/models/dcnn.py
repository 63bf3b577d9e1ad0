"""The paper's four benchmark DCNNs as trainable models (JAX
``models/dcnn.py``).

Every forward is a thin wrapper over ``core.engine.compile_network`` on a
``core.networks.UniformGraph``: the generators' transposed convolutions,
the discriminator's strided convs and the V-Net encoder/decoder with its
skip concatenations, each layer's bias and activation fused into its
kernel's epilogue.  Gradients flow through the ops' autograd
``Function``s, so a loss's backward runs on the hand kernels too.  Only
the dense z-projection, the discriminator's average pooling and head, and
the skip concats run outside the kernels (``torch.matmul``/``mean``/
``cat``), as they sit outside Pallas in the JAX package.

Parameter trees are the JAX package's, as dicts of tensors:
``{"proj", "deconvs": [{"w", "b"}, ...]}`` for a generator,
``{"convs": [{"w"}, ...], "head"}`` for the discriminator and
``{"enc", "dec", "head"}`` for V-Net.  Initialisers draw from an explicit
``torch.Generator`` onto ``device`` (``"cuda"`` unless the caller asks for
the CPU); ``generator_axes``, ``discriminator_axes`` and ``vnet_axes``
give the same trees' logical axes (``sharding.conv_weight_axes`` on the
conv weights, as the JAX initialisers annotate them), which
``checkpoint.Checkpointer.restore`` resolves against a mesh.  The engine defaults to the ``"pallas"`` method (the hand
kernels, the only one ported); the JAX models default to ``iom_phase``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch import obs as _obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import networks
from repro_torch.core.engine import UniformEngine, as_engine, compile_network
from repro_torch.models import layers as L
from repro_torch.sharding.partition import constrain, conv_weight_axes

DEFAULT_METHOD = "pallas"


def _engine(engine) -> UniformEngine:
    return as_engine(engine, default_method=DEFAULT_METHOD)


def _scaled_layers(cfg: ModelConfig) -> list[networks.UniformLayer]:
    layers = networks.benchmark_layers(cfg.dcnn)
    return networks.scale_channels(layers) if cfg.dcnn_reduced else layers


# ---------------------------------------------------------------------------
# Generators (DCGAN, GP-GAN, 3D-GAN)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _generator_graph(dcnn: str, reduced: bool) -> networks.UniformGraph:
    """The generator's deconv chain as a graph with fused epilogues:
    bias+relu on the hidden layers, bias+tanh on the output layer."""
    cfg_layers = networks.benchmark_layers(dcnn)
    if reduced:
        cfg_layers = networks.scale_channels(cfg_layers)
    glayers = [
        dataclasses.replace(
            l, epilogue=networks.Epilogue(
                bias=True,
                activation="tanh" if i == len(cfg_layers) - 1 else "relu"))
        for i, l in enumerate(cfg_layers)]
    return networks.chain_graph(glayers)


def _drawn(generator: torch.Generator, device):
    """A leaf maker that draws each leaf (``init`` a normal's scale, or
    ``"zeros"``) in the order the tree asks for them."""
    def leaf(shape, logical, init):
        if init == "zeros":
            return L.zeros_init(shape, device=device)
        return L.dense_init(generator, shape, scale=init, device=device)
    return leaf


def _axes(shape, logical, init):
    return tuple(logical)


def _generator_tree(cfg: ModelConfig, leaf):
    layers = _scaled_layers(cfg)
    first = layers[0]
    proj_out = math.prod(first.in_spatial) * first.cin
    params = {
        "proj": leaf((cfg.dcnn_z, proj_out), (None, None), 0.02),
        "deconvs": [],
    }
    for l in layers:
        params["deconvs"].append({
            "w": leaf((*l.kernel, l.cin, l.cout), conv_weight_axes(l.rank),
                      0.02),
            "b": leaf((l.cout,), ("model",), "zeros"),
        })
    return params


def init_generator(cfg: ModelConfig, generator: torch.Generator,
                   device="cuda"):
    return _generator_tree(cfg, _drawn(generator, device))


def generator_axes(cfg: ModelConfig):
    return _generator_tree(cfg, _axes)


def generator_forward(params, cfg: ModelConfig, z, engine=None):
    """z [B, dz] -> image/volume [B, *spatial, C_out] in (-1, 1).

    The deconv stack runs as ONE compiled graph on the engine, each
    layer's bias add and relu/tanh fused into its kernel's epilogue; only
    the dense z-projection (its ``project`` span) precedes the graph."""
    engine = _engine(engine)
    graph = _generator_graph(cfg.dcnn, cfg.dcnn_reduced)
    glayers = graph.layers
    first = glayers[0]
    tel = _obs.profiled(engine.config.telemetry)
    with (_obs.NO_SPAN if tel is None
          else tel.span("project", batch=z.shape[0])):
        h = torch.matmul(z, params["proj"].to(z.dtype))
        h = h.reshape(h.shape[0], *first.in_spatial, first.cin)
        h = torch.relu(h)
        h = constrain(h, "batch", *([None] * (first.rank + 1)))
    apply, _ = compile_network(graph, engine, batch=h.shape[0])
    ws = {l.name: dict(p) for l, p in zip(glayers, params["deconvs"])}
    return apply(ws, h)


def generator_schedule(cfg: ModelConfig, engine=None, batch: int = 1):
    """The generator graph's compiled ``ScheduleReport`` on the engine."""
    engine = _engine(engine)
    graph = _generator_graph(cfg.dcnn, cfg.dcnn_reduced)
    _, report = compile_network(graph, engine, batch=batch)
    return report


def _disc_chans(layers) -> list[int]:
    return [layers[-1].cout] + [max(8, layers[-1].cout * (2 ** i))
                                for i in range(1, len(layers) + 1)]


@functools.lru_cache(maxsize=None)
def _discriminator_graph(dcnn: str, reduced: bool) -> networks.UniformGraph:
    """The discriminator's strided-conv chain (leaky_relu epilogues fused);
    geometry mirrors ``init_discriminator``'s channel doubling."""
    cfg_layers = networks.benchmark_layers(dcnn)
    if reduced:
        cfg_layers = networks.scale_channels(cfg_layers)
    rank = cfg_layers[0].rank
    sp = cfg_layers[-1].out_spatial
    chans = _disc_chans(cfg_layers)
    leaky = networks.Epilogue(activation="leaky_relu", alpha=0.2)
    convs = []
    for i in range(len(chans) - 1):
        lay = networks.UniformLayer(
            name=f"disc.conv{i + 1}", in_spatial=sp, cin=chans[i],
            cout=chans[i + 1], kernel=(3,) * rank, stride=(2,) * rank,
            padding=((1, 1),) * rank, op="conv", epilogue=leaky)
        convs.append(lay)
        sp = lay.out_spatial
    return networks.chain_graph(convs)


def _discriminator_tree(cfg: ModelConfig, leaf):
    layers = _scaled_layers(cfg)
    rank = layers[0].rank
    chans = _disc_chans(layers)
    convs = []
    for i in range(len(chans) - 1):
        convs.append({
            "w": leaf((*(3,) * rank, chans[i], chans[i + 1]),
                      conv_weight_axes(rank), 0.02)})
    return {"convs": convs,
            "head": leaf((chans[-1], 1), (None, None), 0.02)}


def init_discriminator(cfg: ModelConfig, generator: torch.Generator,
                       device="cuda"):
    return _discriminator_tree(cfg, _drawn(generator, device))


def discriminator_axes(cfg: ModelConfig):
    return _discriminator_tree(cfg, _axes)


def discriminator_forward(params, cfg: ModelConfig, x, engine=None):
    """Strided-conv stack as ONE compiled graph on the engine (leaky_relu
    fused into each kernel's epilogue), then global average pooling and
    the dense head."""
    engine = _engine(engine)
    graph = _discriminator_graph(cfg.dcnn, cfg.dcnn_reduced)
    rank = x.dim() - 2
    apply, _ = compile_network(graph, engine, batch=x.shape[0])
    ws = {l.name: c["w"] for l, c in zip(graph.layers, params["convs"])}
    h = apply(ws, x)
    h = h.mean(dim=tuple(range(1, rank + 1)))                # GAP
    return torch.matmul(h, params["head"].to(h.dtype))[:, 0]


# ---------------------------------------------------------------------------
# V-Net (encoder-decoder segmenter)
# ---------------------------------------------------------------------------

VNET_ENC = [(1, 16), (16, 32), (32, 64), (64, 128), (128, 256)]


def _vnet_spatial(cfg: ModelConfig):
    return (32, 32, 16) if cfg.dcnn_reduced else (128, 128, 64)


def _vnet_chans(cfg: ModelConfig):
    if cfg.dcnn_reduced:
        return [(1, 4), (4, 8), (8, 16), (16, 32), (32, 64)]
    return VNET_ENC


@functools.lru_cache(maxsize=None)
def _vnet_graph_cached(in_spatial, chans, cin) -> networks.UniformGraph:
    return networks.vnet_graph(in_spatial=in_spatial, chans=chans, cin=cin,
                               num_classes=2)


def _vnet_weights(params, graph: networks.UniformGraph):
    """Map the ``{"enc", "dec", "head"}`` tree onto the graph's name-keyed
    weight dict."""
    ws = {}
    for i, c in enumerate(params["enc"]):
        ws[f"vnet.enc{i + 1}"] = c["w"]
    for i, c in enumerate(params["dec"]):
        ws[f"vnet.up{i + 1}"] = c["up_w"]
        ws[f"vnet.merge{i + 1}"] = c["merge_w"]
    ws["vnet.head"] = params["head"]
    return ws


def _vnet_tree(cfg: ModelConfig, leaf):
    enc_spec = _vnet_chans(cfg)
    # V-Net replicates its weights (its channels are skip-tied, so data
    # parallelism is its scaling story); the axes still come from the
    # shared conv-weight annotation
    axes = conv_weight_axes(3, cout=None)
    enc = [{"w": leaf((3, 3, 3, ci, co), axes, 0.05)} for ci, co in enc_spec]
    dec = []
    # decoder mirrors: deconv from co -> ci (skip concat) -> conv merge
    for ci, co in reversed(enc_spec[1:]):
        dec.append({
            "up_w": leaf((3, 3, 3, co, ci), axes, 0.05),
            "merge_w": leaf((3, 3, 3, 2 * ci, ci), axes, 0.05),
        })
    head = leaf((1, 1, 1, enc_spec[0][1], 2), axes, 0.05)
    return {"enc": enc, "dec": dec, "head": head}


def init_vnet(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    return _vnet_tree(cfg, _drawn(generator, device))


def vnet_axes(cfg: ModelConfig):
    return _vnet_tree(cfg, _axes)


def vnet_forward(params, cfg: ModelConfig, vol, engine=None):
    """vol [B, H, W, D, 1] -> logits [B, H, W, D, 2].

    The whole V-Net (encoder convs, decoder deconvs, skip concatenations,
    merge convs, the 1x1x1 head) is one compiled ``UniformGraph`` on one
    engine, every relu fused into its layer's kernel epilogue."""
    engine = _engine(engine)
    graph = _vnet_graph_cached(tuple(vol.shape[1:-1]),
                               tuple(co for _, co in _vnet_chans(cfg)),
                               vol.shape[-1])
    apply, _ = compile_network(graph, engine, batch=vol.shape[0])
    return apply(_vnet_weights(params, graph), vol)


def vnet_schedule(cfg: ModelConfig, engine=None, batch: int = 1):
    """The V-Net graph's compiled ``ScheduleReport`` on the engine."""
    engine = _engine(engine)
    sp = _vnet_spatial(cfg)
    graph = _vnet_graph_cached(sp, tuple(co for _, co in _vnet_chans(cfg)),
                               _vnet_chans(cfg)[0][0])
    _, report = compile_network(graph, engine, batch=batch)
    return report


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def bce(logit, target):
    """Binary cross-entropy on logits, written as the JAX package writes
    it: ``mean(max(l, 0) - l*t + log1p(exp(-|l|)))``."""
    return torch.mean(torch.clamp(logit, min=0) - logit * target
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def gan_losses(gen_params, disc_params, cfg: ModelConfig, z, real,
               engine=None):
    """Non-saturating GAN losses (generator & discriminator).

    One engine drives both halves.  As in the JAX package, the
    discriminator loss sees the fake logits through a stop-gradient."""
    engine = _engine(engine)
    fake = generator_forward(gen_params, cfg, z, engine)
    d_fake = discriminator_forward(disc_params, cfg, fake, engine)
    d_real = discriminator_forward(disc_params, cfg, real, engine)
    g_loss = bce(d_fake, torch.ones_like(d_fake))
    d_loss = 0.5 * (bce(d_real, torch.ones_like(d_real))
                    + bce(d_fake.detach(), torch.zeros_like(d_fake)))
    return g_loss, d_loss, fake


def dice_loss(logits, labels):
    """labels [B,H,W,D] in {0,1}; logits [B,H,W,D,2]."""
    probs = torch.softmax(logits.to(torch.float32), -1)[..., 1]
    labels = labels.to(torch.float32)
    inter = torch.sum(probs * labels)
    denom = torch.sum(probs) + torch.sum(labels)
    dice = 1.0 - 2.0 * inter / torch.clamp(denom, min=1e-6)
    ce = -torch.mean(labels * torch.log(probs + 1e-8)
                     + (1 - labels) * torch.log(1 - probs + 1e-8))
    return dice + ce
