"""Step builders of JAX ``launch/steps.py``: the DCNN train steps and the
LM serve steps.

``make_gan_train_step`` and ``make_vnet_train_step`` return
``step(params, opt_state, batch) -> (params, opt_state, metrics)``, the
contract ``runtime.train_loop.Trainer`` drives.  Every conv and deconv of
a step, forward and backward, runs on the engine's hand kernels through
the ops' autograd ``Function``s; the losses, the z-projection, the
discriminator head and AdamW are plain tensor code.

``make_dp_gan_train_step`` and ``make_dp_vnet_train_step`` are their
data-parallel siblings (``runtime.dp_trainer``): each rank runs the step
on its shard of the batch, the losses are averaged over the data axis and
the gradients reduced by ``dp_trainer.reduce_grads`` (through int8 with
error feedback when ``compress``), and every rank applies the same
AdamW update; ``fold_dp_step`` fits one to the ``Trainer``.

``train_step_launches`` derives from the model graphs how many times each
hand-kernel wrapper launches in one step (on each rank, at its batch), so
a run on the card can check that the step went through the kernels and
nowhere else.

``make_train_step`` gives an LM's train step (the bf16 forward's loss,
its gradients on the master leaves from ``lm_grads``, AdamW at the
cosine schedule's rate), ``make_serve_step`` its prefill and decode
steps in bf16; ``real_params`` draws an LM's parameters too (every
family of ``models.transformer``).

Given a mesh, an LM's train step is partitioned: every rank holds its
block of each parameter and moment (``param_specs``, ``opt_shardings``:
the reference's ``param_shardings`` of ``param_axes``), takes the global
batch and keeps its batch-axes shard, gathers each leaf's FSDP shards
over the batch axes (an all-gather whose backward reduce-scatters the
gradient; a stacked layer where the layer loop takes it, every other
leaf before the forward), runs the tensor-, vocab- and
expert-parallel forward and backward, sums the gradients of the leaves
that the batch axes replicate over them, and updates its blocks (an
8-bit moment's scale the whole tensor's).  Given a mesh, a serve step
takes this rank's blocks of the parameters, the batch and the cache
(``cache_specs``), gathers the FSDP leaves, and runs the partitioned
prefill or decode (``models.transformer``).

The dry run's assembly (the reference's): ``abstract_params``,
``batch_specs``, ``cache_specs`` and ``input_specs`` give whole ``meta``
trees and their partition specs; ``build_bundle`` gives one cell's step
and this rank's ``meta`` blocks of its arguments (``Bundle``), with the
reference's decode policy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Callable

import torch

from repro_torch import obs as _obs
from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import networks
from repro_torch.core.engine import shard_batch
from repro_torch.core.functional import ieee_f32
from repro_torch.sharding import mesh as _mesh
from repro_torch.sharding import partition as _part
from repro_torch.models import dcnn as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
)
from repro_torch.optim.adamw import AdamWState, QTensor
from repro_torch.runtime import dp_trainer as DP


# the hand-kernel wrappers whose launches a train step counts
LAUNCH_COUNTERS = ("deconv_fwd", "conv_fwd", "deconv_dw", "deconv_dx")


def _init_ws(cfg: ModelConfig, generator: torch.Generator, device="cuda",
             dtype=torch.float32):
    if cfg.family != "dcnn":
        return T.init_params(cfg, generator, device, dtype)
    if cfg.dcnn == "v_net":
        return {"vnet": D.init_vnet(cfg, generator, device)}
    return {"gen": D.init_generator(cfg, generator, device),
            "disc": D.init_discriminator(cfg, generator, device)}


def param_axes(cfg: ModelConfig):
    """The logical axes of ``real_params``' tree, leaf for leaf (the JAX
    package's ``split_params(...)[1]``)."""
    if cfg.family != "dcnn":
        return T.init_params(cfg, None, device=L.AXES)
    if cfg.dcnn == "v_net":
        return {"vnet": D.vnet_axes(cfg)}
    return {"gen": D.generator_axes(cfg), "disc": D.discriminator_axes(cfg)}


def param_specs(cfg: ModelConfig, mesh):
    """Each parameter's partition spec on ``mesh`` (the reference's
    ``param_shardings(mesh, values, param_axes, cfg.fsdp)``)."""
    return _part.param_shardings(mesh, _init_ws(cfg, None, device="meta"),
                                 param_axes(cfg), cfg.fsdp)


def opt_shardings(mesh, state: AdamWState, p_logical, fsdp: bool):
    """An ``AdamWState``'s partition specs (the reference's): the moments
    follow the parameters, a ``QTensor``'s payload too and its scale
    replicated, the step replicated."""
    axes = _tree.leaves(p_logical, is_leaf=_part.is_logical_leaf)
    is_q = lambda x: isinstance(x, QTensor)  # noqa: E731

    def mom(tree):
        specs = []
        for lg, v in zip(axes, _tree.leaves(tree, is_leaf=is_q)):
            if is_q(v):
                specs.append(QTensor(_part.logical_to_spec(
                    mesh, lg, v.q.shape, fsdp), ()))
            else:
                specs.append(_part.logical_to_spec(mesh, lg, v.shape, fsdp))
        return _tree.unflatten(tree, specs, is_leaf=is_q)

    return AdamWState(step=(), m=mom(state.m), v=mom(state.v))


def opt_specs(cfg: ModelConfig, mesh, opt: AdamWConfig):
    """The partition specs of an ``adamw_init`` state of the whole
    parameters (``opt_shardings``; a rank's blocks would resolve a dim
    against its block's extent)."""
    state = adamw_init(_init_ws(cfg, None, device="meta"), opt)
    return opt_shardings(mesh, state, param_axes(cfg), cfg.fsdp)


def real_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", mesh=None):
    """The model's parameter tree on ``device``, drawn from ``generator``
    (on its device: a CUDA generator draws on the card) and cast to
    ``cfg.master_dtype``; an LM's leaves are cast as they are drawn, so
    the f32 draw of a bf16 model is never held whole.  With ``mesh`` (an
    LM's) each leaf is drawn whole, then cut to this rank's block
    (``param_specs``, ``layers.drawing_blocks``): a partitioned run
    starts from the unpartitioned run's weights."""
    dt = getattr(torch, cfg.master_dtype)
    with (L.drawing_blocks(mesh, cfg.fsdp) if mesh is not None
          else contextlib.nullcontext()):
        return _tree.tree_map(lambda v: v.to(dt),
                              _init_ws(cfg, generator, device, dt))


def _wanting_grad(tree):
    """Fresh leaves of ``tree`` that record gradients (the caller's tensors
    are left as they are)."""
    return _tree.tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _grads(loss, tree):
    leaves = _tree.leaves(tree)
    return _tree.unflatten(tree, torch.autograd.grad(loss, leaves))


def shard_lm_batch(batch, mesh):
    """This rank's shard of a global LM batch over the mesh's batch axes
    (the rows of every entry; M-RoPE's ``[3, B, S]`` positions along
    their second dim)."""
    axes = mesh.batch_axes
    n, i = _mesh.axis_size(mesh, axes), _mesh.axis_index(mesh, axes)

    def cut(key, x):
        dim = 1 if key == "mrope_positions" else 0
        if x.shape[dim] % n:
            raise _mesh.MeshError(f"batch {x.shape[dim]} does not divide "
                                  f"the {n}-way batch axes")
        per = x.shape[dim] // n
        return x.narrow(dim, i * per, per)

    return {k: None if v is None else cut(k, v) for k, v in batch.items()}


def _spec_axes(spec) -> list[tuple[int, tuple[str, ...]]]:
    """(dim, mesh axes) of each partitioned dim of ``spec``."""
    return [(d, _part.spec_axes(e)) for d, e in enumerate(spec) if e]


def _per_leaf(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves and ``specs``' (a spec
    tree of the same structure)."""
    spec_leaves = _tree.leaves(specs, is_leaf=_part.is_logical_leaf)
    return _tree.unflatten(tree, [fn(t, s) for t, s in
                                  zip(_tree.leaves(tree), spec_leaves)])


def _gather_fsdp(params, specs, mesh, cfg: ModelConfig):
    """Each leaf whole along its dims partitioned over the batch axes
    (``gather_from``: the backward reduce-scatters the gradient).  The
    stacked layers of the families that loop over them
    (``transformer._layer``) are gathered there, a layer at a time
    (``transformer.FsdpLayers``); every other leaf here."""
    batch = set(mesh.batch_axes)

    def whole(t, spec):
        for d, axes in _spec_axes(spec):
            if set(axes) <= batch:
                t = _mesh.gather_from(t, mesh, axes, d)
        return t
    if cfg.family not in ("dense", "vlm", "moe"):
        return _per_leaf(whole, params, specs)
    rest = {k: v for k, v in params.items() if k != "layers"}
    out = _per_leaf(whole, rest, {k: specs[k] for k in rest})
    # a layer's specs: the stacked leaves' without their leading dim
    layer_specs = _tree.tree_map(lambda sp: sp[1:], specs["layers"],
                                 is_leaf=_part.is_logical_leaf)
    out["layers"] = T.FsdpLayers(
        params["layers"], lambda lp: _per_leaf(whole, lp, layer_specs))
    return out


def _sum_replicated(grads, specs, mesh):
    """The gradients of the leaves the batch axes replicate, summed over
    them (each rank's is its batch shard's part; the FSDP leaves' sums
    came with their gathers' backward)."""
    batch = mesh.batch_axes

    def total(g, spec):
        named = {a for _, axes in _spec_axes(spec) for a in axes}
        return g if named & set(batch) else _mesh.psum(g, mesh, batch)
    return _per_leaf(total, grads, specs)


def absmax_fns(specs, mesh) -> list:
    """Per leaf, the 8-bit moments' whole-tensor maximum from a rank's
    block maximum: a MAX all-reduce over each group of axes that
    partitions the leaf (``None`` for a whole leaf)."""
    def fn(groups):
        def whole(a):
            for axes in groups:
                a = _mesh.psum(a, mesh, axes, "max")
            return a
        return whole
    return [fn([axes for _, axes in _spec_axes(spec)])
            if _spec_axes(spec) else None
            for spec in _tree.leaves(specs, is_leaf=_part.is_logical_leaf)]


def lm_grads(params, cfg: ModelConfig, batch, param_dtype=torch.bfloat16,
             mesh=None, specs=None):
    """``(loss, metrics, grads)`` of an LM's train forward on ``batch`` at
    ``param_dtype``: the gradients of the loss on the master leaves (f32,
    arctic's bf16), the loss and ``metrics`` (``aux``) detached.  The
    backward runs inside ``functional.ieee_f32`` as the forward does, so
    the f32 products of both (scores, gates, recurrences) are IEEE f32
    whatever the process's TF32 flags.

    With ``mesh`` and ``specs`` (``param_specs``), ``params`` are this
    rank's blocks and ``batch`` its shard: the FSDP leaves are gathered
    (``_gather_fsdp``), the loss is the global batch's, and each gradient
    is the whole batch's, of this rank's block."""
    with torch.enable_grad(), ieee_f32(), _part.use_mesh(mesh):
        p = _wanting_grad(params)
        full = p if mesh is None else _gather_fsdp(p, specs, mesh, cfg)
        loss, metrics = T.forward(full, cfg, batch, mode="train",
                                  param_dtype=param_dtype)
        grads = _grads(loss, p)
    if mesh is not None:
        grads = _sum_replicated(grads, specs, mesh)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh=None,
                    param_dtype=torch.bfloat16, local_batch: bool = False):
    """An LM's train step ``step(params, opt_state, batch) -> (params,
    opt_state, {"loss", "aux"})``: ``lm_grads`` of the bf16 forward, then
    AdamW at ``lr_scale = cosine_schedule(opt_state.step)``, read before
    the step counts up (so the first step's rate is 0 and it moves no
    parameter, as the reference's).  With ``mesh`` the step takes and
    returns this rank's blocks of the parameters and moments and the
    global batch, of which it keeps its own shard.  ``param_dtype``: the
    forward's (``torch.float32`` for an f32 control).  ``local_batch``:
    the step takes this rank's batch shard instead (the dry run's)."""
    specs = None if mesh is None else param_specs(cfg, mesh)
    absmax = None if mesh is None else absmax_fns(specs, mesh)

    def train_step(params, opt_state, batch):
        if mesh is not None and not local_batch:
            batch = shard_lm_batch(batch, mesh)
        part = {} if mesh is None else {"mesh": mesh, "specs": specs}
        loss, metrics, grads = lm_grads(params, cfg, batch,
                                        param_dtype=param_dtype, **part)
        lr = cosine_schedule(opt_state.step)
        more = {} if mesh is None else {"absmax": absmax}
        # the step owns its gradients: the update frees each as it goes
        grads = _tree.leaves(grads)
        new_params, new_state = adamw_update(grads, opt_state, params, opt,
                                             lr_scale=lr, consume=True,
                                             **more)
        return new_params, new_state, {"loss": loss, **metrics}
    return train_step


def make_gan_train_step(cfg: ModelConfig, opt: AdamWConfig, engine=None):
    """One GAN step: the generator's and the discriminator's gradients,
    then an AdamW update of each.

    The losses and gradients are the JAX step's: the generator's from
    ``g_loss`` with the discriminator held fixed, the discriminator's from
    ``d_loss`` with the generator held fixed, and (as there) the fake
    logits enter ``d_loss`` through a stop-gradient, so only the real
    half gives the discriminator a gradient.  Unlike the JAX step, which
    runs the whole ``gan_losses`` once per gradient, the generator forward
    and the discriminator's pass over the fakes run once and serve both
    losses; per step that is one generator forward and two discriminator
    forwards (fake, real).  ``train_step_launches`` counts the kernel
    launches this gives.
    """
    engine = D._engine(engine)

    def train_step(params, opt_state, batch):
        g_loss, d_loss, grads = _gan_grads(params, cfg, batch, engine)
        return _gan_update(params, opt_state, grads, opt,
                           {"g_loss": g_loss, "d_loss": d_loss})
    return train_step


def _gan_grads(params, cfg: ModelConfig, batch, engine):
    """``(g_loss, d_loss, {"gen": g_grads, "disc": d_grads})`` of one GAN
    step on ``batch``, the losses detached."""
    gen_p, disc_p = params["gen"], params["disc"]
    with torch.enable_grad():
        gp = _wanting_grad(gen_p)
        fake = D.generator_forward(gp, cfg, batch["z"], engine)
        d_fake = D.discriminator_forward(
            _tree.tree_map(torch.Tensor.detach, disc_p), cfg, fake, engine)
        g_loss = D.bce(d_fake, torch.ones_like(d_fake))
        g_grads = _grads(g_loss, gp)
        dp = _wanting_grad(disc_p)
        d_real = D.discriminator_forward(dp, cfg, batch["real"], engine)
        d_fake = d_fake.detach()
        d_loss = 0.5 * (D.bce(d_real, torch.ones_like(d_real))
                        + D.bce(d_fake, torch.zeros_like(d_fake)))
        d_grads = _grads(d_loss, dp)
    return (g_loss.detach(), d_loss.detach(),
            {"gen": g_grads, "disc": d_grads})


def _gan_update(params, opt_state, grads, opt: AdamWConfig, metrics):
    gen_s, disc_s = opt_state
    new_gen, gen_s = adamw_update(grads["gen"], gen_s, params["gen"], opt)
    new_disc, disc_s = adamw_update(grads["disc"], disc_s, params["disc"],
                                    opt)
    return {"gen": new_gen, "disc": new_disc}, (gen_s, disc_s), metrics


def make_vnet_train_step(cfg: ModelConfig, opt: AdamWConfig, engine=None):
    """One V-Net step: dice + cross-entropy, its gradient, AdamW.  Where
    ``obs.profiled`` finds a recorder for the engine, the step's phases run
    in the spans ``forward``, ``loss``, ``backward`` and ``update``, each
    with ``step``, the step's number among the recorded ones."""
    engine = D._engine(engine)
    recorded = itertools.count()

    def train_step(params, opt_state, batch):
        tel = _obs.profiled(engine.config.telemetry)
        step = None if tel is None else next(recorded)
        loss, grads = _vnet_grads(params, cfg, batch, engine, tel, step)
        with (_obs.NO_SPAN if tel is None
              else tel.span("update", step=step)):
            new_p, new_s = adamw_update(grads, opt_state, params, opt)
        return new_p, new_s, {"loss": loss}
    return train_step


def _vnet_grads(params, cfg: ModelConfig, batch, engine, tel=None,
                step=None):
    """The loss and its gradients; with ``tel`` (a recorder) in the spans
    ``forward``, ``loss`` and ``backward`` of ``step``."""
    with torch.enable_grad():
        p = _wanting_grad(params)
        with (_obs.NO_SPAN if tel is None
              else tel.span("forward", step=step)):
            logits = D.vnet_forward(p["vnet"], cfg, batch["vol"], engine)
        with _obs.NO_SPAN if tel is None else tel.span("loss", step=step):
            loss = D.dice_loss(logits, batch["labels"])
        with (_obs.NO_SPAN if tel is None
              else tel.span("backward", step=step)):
            grads = _grads(loss, p)
    return loss.detach(), grads


# -- explicit data-parallel DCNN steps (runtime.dp_trainer) ------------------

def make_dp_gan_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh,
                           engine=None, compress: bool = True):
    """Data-parallel GAN step on the engine: each rank runs the GAN step's
    gradients on its batch shard (on ``"pallas"``, every conv and deconv
    on the hand kernels), the losses are averaged and the gradients
    reduced over the mesh's data axis (through int8 with error feedback
    when ``compress``), and every rank applies the same AdamW
    update.  ``step(params, opt_state, err, batch)``, ``err`` from
    ``dp_trainer.init_error_state({"gen": ..., "disc": ...}, n_data)``."""
    engine = D._engine(engine)
    group = mesh.group("data")

    def local_step(params, opt_state, err, batch):
        g_loss, d_loss, grads = _gan_grads(params, cfg, batch, engine)
        g_loss = _mesh.pmean(g_loss, group)
        d_loss = _mesh.pmean(d_loss, group)
        grads, err = DP.reduce_grads(grads, err, group, compress)
        params, opt_state, metrics = _gan_update(
            params, opt_state, grads, opt,
            {"g_loss": g_loss, "d_loss": d_loss})
        return params, opt_state, err, metrics

    return DP.make_dp_step(local_step, mesh)


def make_dp_vnet_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh,
                            engine=None, compress: bool = True):
    """V-Net sibling of ``make_dp_gan_train_step``: each rank's dice + CE
    gradients from its volume shard, reduced over the data axis."""
    engine = D._engine(engine)
    group = mesh.group("data")

    def local_step(params, opt_state, err, batch):
        loss, grads = _vnet_grads(params, cfg, batch, engine)
        loss = _mesh.pmean(loss, group)
        grads, err = DP.reduce_grads(grads, err, group, compress)
        new_p, new_s = adamw_update(grads, opt_state, params, opt)
        return new_p, new_s, err, {"loss": loss}

    return DP.make_dp_step(local_step, mesh)


def round_batch_to_mesh(cfg: ModelConfig, n_data: int) -> ModelConfig:
    """Round ``dcnn_batch`` up to a multiple of the data axis's extent, so
    every rank gets an equal shard."""
    if cfg.dcnn_batch % n_data == 0:
        return cfg
    return dataclasses.replace(
        cfg, dcnn_batch=-(-cfg.dcnn_batch // n_data) * n_data)


def fold_dp_step(dp_step, n_data: int, params, mesh=None):
    """Fit a dp step to the ``Trainer``'s three-argument contract by
    folding the error-feedback state into the optimizer state:
    ``step(params, (opt_state, err), batch) -> (params, (opt_state, err),
    metrics)``.  Returns ``(step_fn, err_state)``.  With ``mesh`` the
    folded step takes the global batch (a data pipeline's) and hands the
    dp step this rank's shard of it."""
    err0 = DP.init_error_state(params, n_data)

    def step(params, state, batch):
        opt_state, err = state
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        params, opt_state, err, metrics = dp_step(params, opt_state, err,
                                                  batch)
        if not isinstance(metrics, dict):
            metrics = {"loss": metrics}
        return params, (opt_state, err), metrics

    return step, err0


def _graph_launches(graph, input_needs_grad: bool):
    """Launches of one forward+backward of ``graph`` per wrapper: the
    forward kernel of each layer, its dw, and its dx when its input needs
    a gradient (every layer's but the first, whose input needs one only
    when ``input_needs_grad``); none for an empty layer.  ``deconv_fwd``
    also runs each conv's dx and ``conv_fwd`` each deconv's
    (``deconv_dx``)."""
    n = dict.fromkeys(LAUNCH_COUNTERS, 0)
    needs = {graph.INPUT: input_needs_grad}
    for name in graph.order:
        preds = graph.edges[name]
        nd = graph.nodes[name]
        if isinstance(nd, networks.MergeNode):
            needs[name] = any(needs[p] for p in preds)
            continue
        needs[name] = True                  # its weights want a gradient
        if nd.empty:                        # no sum: nothing launches
            continue
        n[f"{nd.op}_fwd"] += 1
        n["deconv_dw"] += 1
        if needs[preds[0]]:
            n["conv_fwd" if nd.op == "deconv" else "deconv_fwd"] += 1
            n["deconv_dx"] += nd.op == "deconv"
    return n


def train_graphs(cfg: ModelConfig) -> dict[str, networks.UniformGraph]:
    """The conv/deconv graphs one train step of ``cfg`` runs: ``vnet``
    for V-Net, ``gen`` and ``disc`` for a GAN."""
    if cfg.dcnn == "v_net":
        chans = D._vnet_chans(cfg)
        return {"vnet": D._vnet_graph_cached(
            D._vnet_spatial(cfg), tuple(co for _, co in chans),
            chans[0][0])}
    return {"gen": D._generator_graph(cfg.dcnn, cfg.dcnn_reduced),
            "disc": D._discriminator_graph(cfg.dcnn, cfg.dcnn_reduced)}


def train_step_launches(cfg: ModelConfig) -> dict[str, int]:
    """Hand-kernel launches of one train step, per wrapper (``deconv_fwd``,
    ``conv_fwd``, ``deconv_dw``, ``deconv_dx``), derived from the graphs."""
    graphs = train_graphs(cfg)
    if "vnet" in graphs:
        return _graph_launches(graphs["vnet"], input_needs_grad=False)
    gen = _graph_launches(graphs["gen"], input_needs_grad=True)
    # the pass over the fakes: forward and dx only (weights held fixed)
    fake = dict.fromkeys(LAUNCH_COUNTERS, 0)
    for l in graphs["disc"].layers:
        if l.empty:
            continue
        fake[f"{l.op}_fwd"] += 1
        fake["deconv_fwd" if l.op == "conv" else "conv_fwd"] += 1
        fake["deconv_dx"] += l.op == "deconv"
    real = _graph_launches(graphs["disc"], input_needs_grad=False)
    return {k: gen[k] + fake[k] + real[k] for k in LAUNCH_COUNTERS}


def kv_seq_axes(c_specs) -> tuple[str, ...]:
    """The mesh axes a cache's KV sequence dim is cut over, from its
    specs (``cache_specs``): ``()`` where it is whole or there is no KV."""
    if c_specs is None or "kv" not in c_specs:
        return ()
    spec = c_specs["kv"][0]
    return _part.spec_axes(spec[2]) if len(spec) > 2 else ()


def serve_forward(params, cfg: ModelConfig, batch, mode: str, cache=None,
                  mesh=None, specs=None, c_specs=None,
                  param_dtype=torch.bfloat16):
    """``(logits, cache)`` of a prefill or decode ``T.forward``; with
    ``mesh``, of this rank's blocks (``specs``: ``param_specs``;
    ``c_specs``: the cache's, ``cache_specs``'), the FSDP leaves
    gathered first, the logits whole over the vocab for this rank's
    rows."""
    with _part.use_mesh(mesh):
        if mesh is not None and cfg.fsdp:
            params = _gather_fsdp(params, specs, mesh, cfg)
        return T.forward(params, cfg, batch, mode=mode, cache=cache,
                         param_dtype=param_dtype,
                         kv_seq=kv_seq_axes(c_specs))


def make_serve_step(cfg: ModelConfig, kind: str, mesh=None, c_specs=None):
    """An LM's serve step at bf16 weights: ``kind="prefill"`` gives ``step(params, batch) -> (token, cache)``,
    otherwise ``step(params, cache, batch) -> (token, cache)``; the token
    is each row's greedy argmax.  With ``mesh`` the step takes this
    rank's blocks of the parameters (``param_specs``), of the batch and
    of the cache (``c_specs``, ``cache_specs``'), gathers the FSDP
    leaves, runs the partitioned forward and returns its rows' tokens and
    its block of the cache."""
    specs = None if mesh is None else param_specs(cfg, mesh)

    def run(params, batch, mode, cache=None):
        logits, cache = serve_forward(params, cfg, batch, mode, cache, mesh,
                                      specs, c_specs)
        return torch.argmax(logits[:, -1], dim=-1), cache

    if kind == "prefill":
        def prefill_step(params, batch):
            return run(params, batch, "prefill")
        return prefill_step

    def decode_step(params, cache, batch):
        return run(params, batch, "decode", cache)
    return decode_step


# ---------------------------------------------------------------------------
# Abstract trees, specs and bundles (the dry run's assembly)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig):
    """(the whole parameters as ``meta`` tensors in the initialisers'
    dtype, their logical axes), without allocating."""
    return _init_ws(cfg, None, device="meta"), param_axes(cfg)


def _cast_master(cfg: ModelConfig, tree):
    dt = getattr(torch, cfg.master_dtype)
    return _tree.tree_map(lambda v: v.to(dt), tree)


def meta_blocks(tree, specs, mesh):
    """This rank's blocks of a whole ``meta`` tree under ``specs``, each
    a ``meta`` tensor of its own (non-tensor leaves as they are)."""
    out = []
    for t, sp in zip(_tree.leaves(tree), _part.spec_leaves(specs, tree)):
        if isinstance(t, torch.Tensor):
            t = torch.empty(t[_part.block_index(mesh, sp, t.shape)].shape,
                            dtype=t.dtype, device="meta")
        out.append(t)
    return _tree.unflatten(tree, out)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(the whole batch of one input shape as ``meta`` tensors, its
    partition specs): tokens int32 (and labels for train), Whisper's
    bf16 ``enc_embeds``, M-RoPE's positions."""
    gb, s = shape.global_batch, shape.seq_len
    sq = s if shape.kind != "decode" else 1

    def spec(logical, dims):
        return _part.logical_to_spec(mesh, logical, dims)
    batch = {"tokens": _meta((gb, sq), torch.int32)}
    shard = {"tokens": spec(("batch", None), (gb, sq))}
    if shape.kind == "train":
        batch["labels"] = _meta((gb, s), torch.int32)
        shard["labels"] = shard["tokens"]
    if cfg.family == "encdec":
        dims = (gb, cfg.enc_seq, cfg.d_model)
        batch["enc_embeds"] = _meta(dims, torch.bfloat16)
        shard["enc_embeds"] = spec(("batch", None, None), dims)
    if cfg.mrope:
        batch["mrope_positions"] = _meta((3, gb, sq), torch.int32)
        shard["mrope_positions"] = spec((None, "batch", None), (3, gb, sq))
    return batch, shard


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(the whole decode cache of one input shape as ``meta`` tensors,
    its partition specs by ``transformer.cache_logical``; one sequence
    (``global_batch`` 1) cuts the KV sequence dim over ``data``)."""
    gb = shape.global_batch
    cache = T.init_cache(None, cfg, gb, shape.seq_len, device="meta")
    logical = T.cache_logical(cfg, seq_shard=gb == 1)
    return cache, _part.param_shardings(mesh, cache, logical,
                                        fsdp_enabled=False)


def input_specs(arch_or_cfg, shape_name: str = "train_4k", mesh=None):
    """Whole ``meta`` stand-ins for every model input of one (arch x
    shape) cell, and their partition specs:

        specs, shardings = input_specs("llama3.2-1b", "train_4k", mesh)

    ``mesh`` defaults to the 16 x 16 production layout, without a
    world."""
    from repro_torch.configs import SHAPES, get_config
    cfg = (get_config(arch_or_cfg) if isinstance(arch_or_cfg, str)
           else arch_or_cfg)
    shape = SHAPES[shape_name]
    if mesh is None:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(world=False)
    batch, shard = batch_specs(cfg, shape, mesh)
    if shape.kind == "decode":
        c_shapes, c_shard = cache_specs(cfg, shape, mesh)
        return {"batch": batch, "cache": c_shapes}, \
            {"batch": shard, "cache": c_shard}
    return {"batch": batch}, {"batch": shard}


@dataclasses.dataclass
class Bundle:
    """One cell's step and this rank's ``meta`` blocks of its arguments,
    their partition specs (``in_shardings``, ``out_shardings``) and
    ``meta``: the whole model's ``params`` and ``active_params``, the
    step's ``kind``, the indices of the arguments it hands back in place
    (``donate``, the reference's donation) and the config it runs
    (``cfg``, after the decode policy)."""
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    meta: dict


def decode_policy(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ModelConfig:
    """The reference's decode-bundle policy: FSDP off while a model shard
    of the bf16 weights is at most 8 GB, and the KV cache's sequence dim
    on the model axis where the KV heads do not divide it."""
    model_size = mesh.shape.get("model", 1)
    n_params = T.param_count(abstract_params(cfg)[0])
    per_shard_gb = n_params * 2 / model_size / 1e9      # bf16 weights
    kv_seq = (cfg.n_kv_heads > 0 and cfg.n_kv_heads % model_size != 0
              and shape.global_batch > 1)
    return dataclasses.replace(cfg, fsdp=cfg.fsdp and per_shard_gb > 8.0,
                               kv_seq_shard=cfg.kv_seq_shard or kv_seq)


def _dcnn_bundle(cfg: ModelConfig, mesh, opt: AdamWConfig) -> Bundle:
    """The DCNN's data-parallel train step (``make_dp_*_train_step``,
    uncompressed) over the mesh's ``data`` axis, the batch rounded up to
    it, the ``model`` (and ``pod``) axis replicating it, as the port's
    launcher runs a DCNN on a mesh; the reference's GSPMD partition
    differs (``meta["partition"]``)."""
    from repro_torch.core.engine import EngineConfig, UniformEngine
    n_data = mesh.shape.get("data", 1)
    cfg = round_batch_to_mesh(cfg, n_data)
    engine = UniformEngine(EngineConfig(method=cfg.dcnn_method,
                                        device="meta"))
    p_shapes, p_logical = abstract_params(cfg)
    p_shapes = _cast_master(cfg, p_shapes)
    replicated = _tree.tree_map(lambda _: (), p_shapes)
    b = cfg.dcnn_batch // n_data
    if cfg.dcnn == "v_net":
        sp = D._vnet_spatial(cfg)
        batch = {"vol": _meta((b, *sp, 1), torch.float32),
                 "labels": _meta((b, *sp), torch.int32)}
        dp = make_dp_vnet_train_step(cfg, opt, mesh, engine=engine,
                                     compress=False)
        state = adamw_init(p_shapes, opt)
    else:
        layers = D._scaled_layers(cfg)
        batch = {"z": _meta((b, cfg.dcnn_z), torch.float32),
                 "real": _meta((b, *layers[-1].out_spatial,
                                layers[-1].cout), torch.float32)}
        dp = make_dp_gan_train_step(cfg, opt, mesh, engine=engine,
                                    compress=False)
        state = (adamw_init(p_shapes["gen"], opt),
                 adamw_init(p_shapes["disc"], opt))

    def step(params, opt_state, batch):
        # uncompressed: no error-feedback state to carry
        params, opt_state, _, metrics = dp(params, opt_state, None, batch)
        return params, opt_state, metrics

    b_shard = _tree.tree_map(lambda v: ("data",), batch)
    return Bundle(
        fn=step, args=(p_shapes, state, batch),
        in_shardings=(replicated, None, b_shard),
        out_shardings=(replicated, None, None),
        meta={"params": T.param_count(p_shapes), "kind": "train",
              "donate": (0, 1), "cfg": cfg,
              "partition": f"data-parallel over data ({n_data}), "
                           f"batch {cfg.dcnn_batch}; model axis "
                           f"replicates"})


def build_bundle(cfg: ModelConfig, shape: ShapeConfig | None, mesh,
                 opt: AdamWConfig | None = None,
                 policy: bool = True) -> Bundle:
    """Everything needed to trace one (arch x shape) cell as one rank of
    ``mesh``: the step and this rank's ``meta`` blocks of its arguments
    (the whole batch's shard, the cache's block).  ``policy=False``:
    ``cfg`` as it is, without the decode policy (a probe of a config the
    policy has already set)."""
    opt = opt or AdamWConfig(state_bits=cfg.opt_state_bits)
    if cfg.family == "dcnn":
        return _dcnn_bundle(cfg, mesh, opt)
    if shape.kind == "decode" and policy:
        cfg = decode_policy(cfg, shape, mesh)

    p_shapes, p_logical = abstract_params(cfg)
    p_shapes = _cast_master(cfg, p_shapes)
    p_shard = _part.param_shardings(mesh, p_shapes, p_logical, cfg.fsdp)
    params = meta_blocks(p_shapes, p_shard, mesh)
    batch, b_shard = batch_specs(cfg, shape, mesh)
    batch = meta_blocks(batch, b_shard, mesh)
    meta = {"params": T.param_count(p_shapes),
            "active_params": T.active_param_count(p_shapes, cfg),
            "kind": shape.kind, "cfg": cfg}
    # a mesh of one rank runs the unpartitioned step (the trainer's and
    # the server's own)
    step_mesh = mesh if mesh.size > 1 else None

    if shape.kind == "train":
        step = make_train_step(cfg, opt, step_mesh, local_batch=True)
        state = adamw_init(params, opt)
        os_shard = opt_specs(cfg, mesh, opt)
        return Bundle(fn=step, args=(params, state, batch),
                      in_shardings=(p_shard, os_shard, b_shard),
                      out_shardings=(p_shard, os_shard, None),
                      meta={**meta, "donate": (0, 1)})

    if shape.kind == "prefill":
        step = make_serve_step(cfg, "prefill", step_mesh)
        return Bundle(fn=step, args=(params, batch),
                      in_shardings=(p_shard, b_shard),
                      out_shardings=None, meta={**meta, "donate": ()})

    c_shapes, c_shard = cache_specs(cfg, shape, mesh)
    step = make_serve_step(cfg, "decode", step_mesh, c_shard)
    tok_out = _part.logical_to_spec(mesh, ("batch",), (shape.global_batch,))
    return Bundle(fn=step, args=(params, meta_blocks(c_shapes, c_shard,
                                                     mesh), batch),
                  in_shardings=(p_shard, c_shard, b_shard),
                  out_shardings=(tok_out, c_shard),
                  meta={**meta, "donate": (1,)})
