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

On one card there is no mesh with a ``model`` axis, where the
reference's ``moe_shardmap`` falls back to ``moe``: ``moe_dispatch``
runs ``moe`` for both ``moe_impl`` values.  Expert parallelism is the
parameter-partitioning slice of ROADMAP item 15.6.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


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

    def w(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return L.dense_init(generator, (*stack, *shape), scale=scale,
                            dtype=dtype, device=device)

    return MoeParams(
        w_router=w((d, e), 0.02),
        w_in=w((e, d, f)),
        w_gate=w((e, d, f)) if cfg.gated_mlp else None,
        w_out=w((e, f, d)),
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


def dispatch(top_e: torch.Tensor, n_experts: int, c: int):
    """The capacity dispatch of ``top_e`` [T, k]: (sort_idx, keep, dest)
    over the T*k pairs in stable expert order; ``dest`` is each sorted
    pair's buffer row, ``n_experts * c`` (the overflow row) where the
    expert is full."""
    flat_e = top_e.reshape(-1)
    dev = flat_e.device
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    offs = torch.searchsorted(sorted_e, torch.arange(n_experts, device=dev))
    rank = torch.arange(flat_e.numel(), device=dev) - offs[sorted_e]
    keep = rank < c
    dest = torch.where(keep, sorted_e * c + rank,
                       torch.full_like(rank, n_experts * c))
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


def moe(p: MoeParams, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(t, d)
    probs, top_p, top_e = route(xf, p.w_router, k)
    c = capacity(t, cfg)
    sort_idx, _, dest = dispatch(top_e, e, c)
    tok = sort_idx // k

    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    # the overflow row alone takes several; each token's k copies are
    # gathered with a deterministic backward (layers.embed_lookup)
    buf[dest] = L.embed_lookup(xf, tok)
    buf = buf[:e * c].reshape(e, c, d)

    act = L.activation(cfg.mlp_activation)
    h = torch.bmm(buf, p.w_in.to(x.dtype))
    if p.w_gate is not None:
        h = act(torch.bmm(buf, p.w_gate.to(x.dtype))) * h
    else:
        h = act(h)
    y_e = torch.bmm(h, p.w_out.to(x.dtype))

    y_flat = torch.cat([y_e.reshape(e * c, d), y_e.new_zeros((1, d))])
    weighted = y_flat[dest] * top_p.reshape(-1)[sort_idx][:, None].to(
        y_e.dtype)                                      # [T*k, D], sorted
    out = combine(weighted, sort_idx, k).to(x.dtype).reshape(b, s, d)

    # load-balance auxiliary loss (Switch/GShard form)
    frac = torch.bincount(top_e.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return out, aux


def moe_dispatch(p: MoeParams, x: torch.Tensor, cfg: ModelConfig):
    """Entry point for both ``cfg.moe_impl`` values: ``moe`` (one card
    has no ``model`` axis to spread the experts over)."""
    return moe(p, x, cfg)
