"""Mixture-of-experts block (JAX ``models/moe.py``): top-k routing with
sort-based capacity dispatch.

Dispatch is the dropping flavour (GShard capacity) without the
O(T*E*C) one-hot tensor: the (token, k) pairs are sorted by expert id
(stable), ranked within their expert by a running offset, and written
into a dense ``[E, C, D]`` buffer; pairs past an expert's capacity go to
an overflow row that is dropped.  Every expert runs on its whole
capacity buffer, empty rows included, as in the reference.

The combine adds each token's ``top_k`` weighted expert rows in a fixed
order, ascending expert id (the order of the stable sort, in which the
reference's ``segment_sum`` adds them): a gather through the inverse of
the sort, then a sum over ``k``, so no atomics and the same bits on
every run.  arctic-480b adds a dense residual MLP in parallel
(``cfg.residual_mlp``, in ``models.transformer``).

``moe_dispatch`` honours ``cfg.moe_impl``.  ``moe`` routes every token
of the (global) batch together: on a mesh it gathers the batch's tokens
over the batch axes, and where the experts divide the ``model`` axis each
rank runs its own experts' capacity buffers and the combine is summed
over the axis.  ``moe_shardmap`` is the reference's explicit expert
parallelism: each data shard routes its own tokens, in ``moe_groups``
token groups of its own capacity, every model shard routes them
redundantly and keeps only its local experts' buffer, the combine is
summed over the model axis with one all-reduce, and the load-balance
term is the mean over the batch axes of the shards' terms.  Its
semantics are ``moe``'s only with one data shard and one group; without
a mesh (or where the experts do not divide the axis) it is ``moe``, as
the reference's.  ``moe_shardmap_plain`` computes it in one process,
every shard's body in turn, for tests and the card's check.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import mesh as _mesh
from repro_torch.sharding.partition import current_mesh

MODEL = ("model",)


class MoeParams(NamedTuple):
    w_router: torch.Tensor          # [D, E]
    w_in: torch.Tensor              # [E, D, F]
    w_gate: torch.Tensor | None     # [E, D, F]
    w_out: torch.Tensor             # [E, F, D]


def init_moe(generator: torch.Generator, cfg: ModelConfig, device="cuda",
             stack: tuple[int, ...] = (), dtype=torch.float32) -> MoeParams:
    """One MoE block's weights, or ``stack`` of them stacked in front,
    cast to ``dtype``.  The expert weights are drawn at the reference's
    scale, 1/sqrt of their leading (expert) extent."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(shape, logical, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return L.dense_init(generator, (*stack, *shape), scale=scale,
                            dtype=dtype, device=device, logical=logical)

    col = ("model", "fsdp", None)
    return MoeParams(
        w_router=w((d, e), (None, None), 0.02),
        w_in=w((e, d, f), col),
        w_gate=w((e, d, f), col) if cfg.gated_mlp else None,
        w_out=w((e, f, d), ("model", None, "fsdp")),
    )


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    c = min(max(-(-c // 128) * 128, 128), n_tokens * cfg.top_k)
    return c


def route(xf: torch.Tensor, w_router: torch.Tensor, k: int):
    """Router of ``xf`` [T, D]: (probs [T, E] f32, top_p [T, k]
    renormalised, top_e [T, k]).  Ties go to the lower expert index, as
    ``lax.top_k`` gives them: a stable descending sort."""
    probs = torch.softmax(xf.float() @ w_router.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def dispatch(top_e: torch.Tensor, n_experts: int, c: int, e0: int = 0,
             e_loc: int | None = None):
    """The capacity dispatch of ``top_e`` [T, k]: (sort_idx, keep, dest)
    over the T*k pairs in stable expert order; ``dest`` is each sorted
    pair's row in the buffer of experts ``e0 .. e0 + e_loc`` (all by
    default), ``e_loc * c`` (the overflow row) where the expert is full
    or not among them."""
    e_loc = n_experts if e_loc is None else e_loc
    flat_e = top_e.reshape(-1)
    dev = flat_e.device
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    offs = torch.searchsorted(sorted_e, torch.arange(n_experts, device=dev))
    rank = torch.arange(flat_e.numel(), device=dev) - offs[sorted_e]
    keep = (rank < c) & (sorted_e >= e0) & (sorted_e < e0 + e_loc)
    dest = torch.where(keep, (sorted_e - e0) * c + rank,
                       torch.full_like(rank, e_loc * c))
    return sort_idx, keep, dest


def combine(weighted: torch.Tensor, sort_idx: torch.Tensor,
            k: int) -> torch.Tensor:
    """The reference's ``segment_sum(weighted, sort_idx // k)``: each
    token's k rows of ``weighted`` [T*k, D] (in sorted pair order) added
    one after another in their dtype, in the order they stand there
    (ascending expert id), with no atomics -> [T, D]."""
    n = sort_idx.numel()
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(n, device=sort_idx.device)
    rows = weighted[torch.sort(inv.reshape(n // k, k), dim=-1).values]
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def _group(xf, wr, wi, wg, wo, cfg: ModelConfig, e0: int, dtype):
    """One token group ``xf`` [T, D] through the experts ``e0 ..`` whose
    weights ``wi``/``wg``/``wo`` hold (all of them, or a model shard's):
    (this shard's part of the combine [T, D] in ``dtype``, the group's
    load-balance term)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = wi.shape[0]
    probs, top_p, top_e = route(xf, wr, k)
    c = capacity(t, cfg)
    sort_idx, _, dest = dispatch(top_e, e, c, e0, e_loc)
    tok = sort_idx // k

    buf = torch.zeros((e_loc * c + 1, d), dtype=dtype, device=xf.device)
    # the overflow row alone takes several; each token's k copies are
    # gathered with a deterministic backward (layers.embed_lookup)
    buf[dest] = L.embed_lookup(xf, tok)
    buf = buf[:e_loc * c].reshape(e_loc, c, d)

    act = L.activation(cfg.mlp_activation)
    h = torch.bmm(buf, wi.to(dtype))
    if wg is not None:
        h = act(torch.bmm(buf, wg.to(dtype))) * h
    else:
        h = act(h)
    y_e = torch.bmm(h, wo.to(dtype))

    y_flat = torch.cat([y_e.reshape(e_loc * c, d), y_e.new_zeros((1, d))])
    weighted = y_flat[dest] * top_p.reshape(-1)[sort_idx][:, None].to(
        y_e.dtype)                                      # [T*k, D], sorted
    out = combine(weighted, sort_idx, k).to(dtype)

    # load-balance auxiliary loss (Switch/GShard form)
    # the expert counts (bincount's, which has no meta kernel)
    ids = top_e.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    frac = counts.float() / (t * k)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return out, aux


def _groups(xf, wr, p: MoeParams, cfg: ModelConfig, e0: int, n: int,
            dtype):
    """``_group`` over ``n`` equal token groups of ``xf`` in turn (each
    checkpointed while autograd records, as the reference's scan body):
    (the parts of the combine concatenated, the mean of the terms)."""
    if n <= 1:
        return _group(xf, wr, p.w_in, p.w_gate, p.w_out, cfg, e0, dtype)
    outs, auxs = [], []
    for xg in xf.chunk(n):
        o, a = L.remat(lambda xg_, wr_, wi, wg, wo: _group(
            xg_, wr_, wi, wg, wo, cfg, e0, dtype), xg, wr, p.w_in,
            p.w_gate, p.w_out)
        outs.append(o)
        auxs.append(a)
    return torch.cat(outs), torch.stack(auxs).mean()


def _model_shard(p: MoeParams, cfg: ModelConfig, mesh):
    """(mesh, model-axis size, first local expert) where ``p`` holds one
    model shard's experts, else (None, 1, 0)."""
    e_loc = p.w_in.shape[0]
    if e_loc == cfg.n_experts:
        return None, 1, 0
    return mesh, cfg.n_experts // e_loc, _mesh.axis_index(mesh, MODEL) * e_loc


def moe(p: MoeParams, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar): every token of the
    batch routed together (on a mesh, the whole batch's, gathered over the
    batch axes; each model shard runs its own experts)."""
    b, s, d = x.shape
    mesh = current_mesh()
    if mesh is None:
        out, aux = L.blk_region(cfg, lambda x_, p_: _group(
            x_.reshape(b * s, d), p_.w_router, p_.w_in, p_.w_gate, p_.w_out,
            cfg, 0, x.dtype), x, p)
        return out.reshape(b, s, d), aux
    batch = mesh.batch_axes
    nb, i = _mesh.axis_size(mesh, batch), _mesh.axis_index(mesh, batch)
    xg = _mesh.gather_from(x, mesh, batch, 0)
    tp, m, e0 = _model_shard(p, cfg, mesh)
    xg = _mesh.copy_to(xg, tp, MODEL)
    wr = _mesh.copy_to(p.w_router, tp, MODEL)
    out, aux = L.blk_region(cfg, lambda xg_, wr_, p_: _group(
        xg_.reshape(-1, d), wr_, p_.w_in, p_.w_gate, p_.w_out, cfg, e0,
        x.dtype), xg, wr, p)
    out = _mesh.reduce_from(out, tp, MODEL, "blk_out").reshape(-1, s, d)
    # every rank computes the whole term: 1 / (m nb) of its gradient each
    return out[i * b:(i + 1) * b], _mesh.scale_grad(aux, 1 / (m * nb))


def moe_shardmap(p: MoeParams, x: torch.Tensor, cfg: ModelConfig):
    """The reference's ``moe_shardmap``: x [B_loc, S, D] (this data
    shard's) -> (y, the batch axes' mean of the shards' load-balance
    terms); ``moe`` without a mesh or where the experts do not divide the
    model axis."""
    mesh = current_mesh()
    if (mesh is None or "model" not in mesh.axis_names
            or cfg.n_experts % mesh.shape["model"]):
        return moe(p, x, cfg)
    b, s, d = x.shape
    t = b * s
    n = cfg.moe_groups if t % max(cfg.moe_groups, 1) == 0 else 1
    tp, m, e0 = _model_shard(p, cfg, mesh)
    xf = _mesh.copy_to(x.reshape(t, d), tp, MODEL)
    wr = _mesh.copy_to(p.w_router, tp, MODEL)
    out, aux = L.blk_region(cfg, lambda xf_, wr_, p_: _groups(
        xf_, wr_, p_, cfg, e0, n, x.dtype), xf, wr, p)
    out = _mesh.reduce_from(out, tp, MODEL, "blk_out")    # THE collective
    batch = mesh.batch_axes
    aux = _mesh.reduce_from(_mesh.scale_grad(aux, 1 / m), mesh, batch)
    return out.reshape(b, s, d), aux / _mesh.axis_size(mesh, batch)


def moe_shardmap_plain(p: MoeParams, x: torch.Tensor, cfg: ModelConfig,
                       n_data: int, n_model: int):
    """``moe_shardmap`` on an ``n_data x n_model`` mesh, in one process:
    each data shard's rows of ``x`` (the whole batch) through each model
    shard's experts in turn, the parts of the combine added in shard
    order, the load-balance terms averaged over the data shards."""
    if cfg.n_experts % n_model:
        return moe(p, x, cfg)
    b, s, d = x.shape
    e_loc = cfg.n_experts // n_model
    outs, auxs = [], []
    for xd in x.chunk(n_data):
        xf = xd.reshape(-1, d)
        n = cfg.moe_groups if xf.shape[0] % max(cfg.moe_groups, 1) == 0 \
            else 1
        out = None
        for j in range(n_model):
            pj = MoeParams(p.w_router, *(
                None if w is None else w[j * e_loc:(j + 1) * e_loc]
                for w in (p.w_in, p.w_gate, p.w_out)))
            o, a = _groups(xf, p.w_router, pj, cfg, j * e_loc, n, x.dtype)
            out = o if out is None else out + o
        outs.append(out.reshape(-1, s, d))
        auxs.append(a)
    return torch.cat(outs), torch.stack(auxs).mean()


def moe_dispatch(p: MoeParams, x: torch.Tensor, cfg: ModelConfig):
    """Entry point honouring ``cfg.moe_impl``."""
    if cfg.moe_impl == "shardmap":
        return moe_shardmap(p, x, cfg)
    return moe(p, x, cfg)
