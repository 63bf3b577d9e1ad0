"""GQA/MQA attention with RoPE / M-RoPE, chunked softmax (no O(S^2)
materialisation), KV caches and cross-attention (JAX
``models/attention.py``).

The dtypes are the reference's: scores and softmax in f32, the probs cast
to ``v``'s dtype, their product with ``v`` summed in f32 and cast to
``v``'s dtype.  In decode ``v`` is the bf16 cache, so probs and outputs
round to bf16 there.  A decode step writes its keys and values into the
cache in place (the reference donates the cache instead); the write
index is clamped into the cache as ``jax.lax.dynamic_update_slice``
clamps it.

On a mesh with a ``model`` axis (``sharding.partition.current_mesh``,
train mode) the heads are column-parallel and ``wo`` row-parallel: each
rank holds its heads' blocks of ``wq``, ``wk``, ``wv`` and ``wo`` (the
reference's logical axes), attends with its own heads and sums the
out-projection over the axis with one all-reduce.  Where the KV heads
do not divide the axis they stay whole (``logical_to_spec``: granite's
one KV head, qwen2-vl's two on a 4-way axis) and each rank takes the KV
heads its own query heads read under GQA, their weights' gradients
summed over the axis.  Where the query heads do not divide it either,
every rank computes the whole block.

A serve step on a mesh (``KvLayout``: prefill and decode) keeps each
rank's KV cache in ``transformer.cache_logical``'s layout.  Head-
parallel: the rank's KV heads, or every KV head where they stay whole
(then each rank computes them all, and attends with those its query
heads read).  Split-KV, where the cache's sequence dim is cut over mesh
axes (``KvLayout.seq``: ``model`` under ``cfg.kv_seq_shard``, ``data``
for one long sequence): the new token's keys and values go to the rank
whose block holds its position; each rank attends over its positions
(with every query head where the cut is over ``model``, gathered over
it), and the softmax is combined over the cut's axes (``_attend_split``:
the maximum, then the sum of the max-shifted terms, then the probs'
product with V summed), each rank keeping its own heads.  On a mesh of
one the decode is the unpartitioned one, op for op.
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

_NEG = -1e30
_Q_CHUNK = 512


class AttnParams(NamedTuple):
    wq: torch.Tensor     # [D, Hq, hd]
    wk: torch.Tensor     # [D, Hkv, hd]
    wv: torch.Tensor     # [D, Hkv, hd]
    wo: torch.Tensor     # [Hq, hd, D]


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   device="cuda", d_model=None, n_heads=None, n_kv=None,
                   stack: tuple[int, ...] = (),
                   dtype=torch.float32) -> AttnParams:
    """One attention block's weights, or ``stack`` of them stacked in
    front (the reference's ``[L, ...]`` leaves), cast to ``dtype``."""
    d = d_model or cfg.d_model
    hq = n_heads or cfg.n_heads
    hkv = n_kv or cfg.n_kv_heads
    hd = cfg.resolved_head_dim

    def w(shape, scale, logical):
        return L.dense_init(generator, (*stack, *shape), scale=scale,
                            dtype=dtype, device=device, logical=logical)

    col = ("fsdp", "model", None)
    return AttnParams(
        wq=w((d, hq, hd), 1.0 / math.sqrt(d), col),
        wk=w((d, hkv, hd), 1.0 / math.sqrt(d), col),
        wv=w((d, hkv, hd), 1.0 / math.sqrt(d), col),
        wo=w((hq, hd, d), 1.0 / math.sqrt(hq * hd), ("model", None, "fsdp")),
    )


def _split_gqa(q, n_kv):
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def _softmax_attend(q, k, v, mask):
    """q [B,Sq,Hkv,G,hd]; k/v [B,T,Hkv,hd]; mask [B or 1,Sq,T] or None."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if mask is not None:
        neg = torch.where(mask, 0.0, _NEG)
        scores = scores + neg[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def _attend_chunked(q, k, v, *, causal: bool, q_offset: int = 0):
    """Query chunks one after another, so scores never exceed
    O(chunk * T).  q [B,Sq,Hkv,G,hd]; k/v [B,T,Hkv,hd].  Under autograd
    each chunk of several is checkpointed, as in the reference: the
    backward recomputes one chunk's scores at a time instead of saving
    all S*T probs."""
    sq = q.shape[1]
    t = k.shape[1]
    chunk = min(_Q_CHUNK, sq)
    if sq % chunk != 0:
        chunk = sq  # irregular small seqs: single chunk
    t_idx = torch.arange(t, device=q.device)
    outs = []
    for start in range(0, sq, chunk):
        mask = None
        if causal:
            q_idx = q_offset + start + torch.arange(chunk, device=q.device)
            mask = (t_idx[None, :] <= q_idx[:, None])[None]
        qc = q[:, start:start + chunk]
        outs.append(L.remat(_softmax_attend, qc, k, v, mask) if sq > chunk
                    else _softmax_attend(qc, k, v, mask))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``new`` [B, s, ...] into ``cache`` [B, T, ...] at ``pos`` along the
    sequence, in place; the index clamped into the cache."""
    start = min(max(pos, 0), cache.shape[1] - new.shape[1])
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) in x's dtype."""
    b, s, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _kv_heads(cfg: ModelConfig, hq_loc: int, r: int):
    """The whole KV heads rank ``r``'s query heads ``r * hq_loc ..`` read
    under GQA: a slice where they fall in equal runs (``_split_gqa``
    groups them), else one index per query head."""
    g = cfg.n_heads // cfg.n_kv_heads
    heads = [(r * hq_loc + j) // g for j in range(hq_loc)]
    first, last = heads[0], heads[-1]
    if hq_loc % (last - first + 1) == 0 and all(
            heads.count(h) == hq_loc // (last - first + 1)
            for h in range(first, last + 1)):
        return slice(first, last + 1)
    return heads


class KvLayout(NamedTuple):
    """A serve step's KV cache on the mesh: ``seq``, the mesh axes its
    sequence dim is cut over (``()``: whole on every rank)."""
    seq: tuple[str, ...] = ()


def _tp(p: AttnParams, cfg: ModelConfig):
    """The mesh when ``p`` holds this rank's heads only, else ``None``."""
    if p.wq.shape[1] == cfg.n_heads:
        return None
    return current_mesh()


def _kv_weights(p: AttnParams, cfg: ModelConfig, mesh):
    """This rank's ``wk`` and ``wv``: its blocks, or where the KV heads
    stay whole, the heads its query heads read (gradients summed over
    the model axis)."""
    if mesh is None or p.wk.shape[1] != cfg.n_kv_heads:
        return p.wk, p.wv
    sel = _kv_heads(cfg, p.wq.shape[1], _mesh.axis_index(mesh, MODEL))
    return tuple(_mesh.copy_to(w, mesh, MODEL)[:, sel] for w in (p.wk, p.wv))


def cross_kv(p: AttnParams, enc_out: torch.Tensor, cfg: ModelConfig,
             serve: bool = False):
    """Cross-attention keys and values of ``enc_out`` for this rank's
    heads (all of them without a model axis; in a serve step, all of
    them where the KV heads stay whole, as its cache holds them)."""
    mesh = _tp(p, cfg)
    enc = _mesh.copy_to(enc_out, mesh, MODEL)
    ws = (p.wk, p.wv) if serve else _kv_weights(p, cfg, mesh)
    return tuple(project_heads(enc, w) for w in ws)


def _write_owned(cache: torch.Tensor, new: torch.Tensor, pos: int, mesh,
                 seq: tuple[str, ...]) -> None:
    """``new`` [B, 1, ...] into the rank's block ``cache`` [B, T_loc, ...]
    of a cache cut over ``seq``, if its block holds ``pos`` (clamped into
    the whole cache, as ``_write`` clamps)."""
    t_loc = cache.shape[1]
    n = _mesh.axis_size(mesh, seq)
    pos = min(max(pos, 0), t_loc * n - 1)
    if pos // t_loc == _mesh.axis_index(mesh, seq):
        _write(cache, new, pos % t_loc)


def _attend_split(q, k, v, valid, mesh, seq: tuple[str, ...]):
    """One query position against a cache cut over ``seq``: q
    [B,1,Hkv,G,hd]; k/v this rank's positions [B,T_loc,Hkv,hd]; valid
    [T_loc].  The softmax over every rank's positions: the maximum of
    the ranks' maxima, each rank's sum of ``exp(s - max)`` summed, each
    rank's probs (rounded to ``v``'s dtype, as ``_softmax_attend``
    rounds them) times its V summed, in f32, cast to ``v``'s dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    scores = scores + torch.where(valid, 0.0, _NEG)
    mx = _mesh.psum(scores.amax(dim=-1, keepdim=True), mesh, seq, "max")
    e = torch.exp(scores - mx)
    probs = e / _mesh.psum(e.sum(dim=-1, keepdim=True), mesh, seq)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return _mesh.psum(out, mesh, seq).to(v.dtype)


def attention(p: AttnParams, x: torch.Tensor, cfg: ModelConfig, *,
              cos=None, sin=None, causal=True, kv_cache=None,
              cache_pos: int | None = None, xattn_kv=None,
              kv_layout: KvLayout | None = None):
    """Returns (out, new_kv_cache).

    modes:
      * prefill: x [B,S,D]; kv_cache None -> the cache returned is (k, v)
      * decode: x [B,1,D]; kv_cache (k_cache, v_cache) [B,T,Hkv,hd], which
        this call writes at ``cache_pos`` (an int) in place and returns
      * cross-attention: xattn_kv = (k, v) precomputed from an encoder
        (``cross_kv``).
    ``kv_layout``: a serve step's on a mesh (see the module docstring);
    ``None`` in train mode and without a mesh.  Where
    ``layers.blk_out`` keeps its result (``save_outs``, train) the cache
    returned is ``None``.
    """
    b, s, d = x.shape
    mesh = _tp(p, cfg)
    x = _mesh.copy_to(x, mesh, MODEL)
    cm = current_mesh()
    seq = kv_layout.seq if kv_layout is not None else ()
    split = (kv_cache is not None and bool(seq)
             and _mesh.axis_size(cm, seq) > 1)
    # the query heads gathered over the model axis, where the cache's
    # positions are cut over it and the weights' heads are
    gather_q = split and mesh is not None and "model" in seq
    kv_whole = p.wk.shape[1] == cfg.n_kv_heads
    if kv_layout is None:
        wk, wv = _kv_weights(p, cfg, mesh)
        sel = None
    else:
        # a serve step's cache holds the rank's KV heads, or every one
        # where they stay whole or its positions are cut over the axis
        wk, wv = p.wk, p.wv
        sel = (_kv_heads(cfg, p.wq.shape[1], _mesh.axis_index(cm, MODEL))
               if mesh is not None and kv_whole and not gather_q else None)
    gather_kv = gather_q and not kv_whole
    caches = []

    def core(x, wq, wk, wv, xattn_kv):
        """The attention output before ``wo``: [B, S, Hq_loc * hd]."""
        q = project_heads(x, wq)
        if xattn_kv is None:
            k, v = project_heads(x, wk), project_heads(x, wv)
            if cos is not None:
                q = L.apply_rope(q, cos, sin)
                k = L.apply_rope(k, cos, sin)
            if gather_kv:
                k, v = (_mesh.gather(t, cm, MODEL, 2) for t in (k, v))
            caches.append((k, v))
            if kv_cache is not None:
                ck, cv = kv_cache
                for c, new in ((ck, k), (cv, v)):
                    if split:
                        _write_owned(c, new, cache_pos, cm, seq)
                    else:
                        _write(c, new, cache_pos)
                caches[-1] = (ck, cv)
                k, v = ck, cv
        else:
            k, v = xattn_kv
            if cos is not None:
                q = L.apply_rope(q, cos, sin)
            caches.append(None)
        if gather_q:
            q = _mesh.gather(q, cm, MODEL, 2)
        if sel is not None:
            k, v = k[:, :, sel], v[:, :, sel]
        qg = _split_gqa(q, k.shape[2])
        if split:
            t_loc = k.shape[1]
            t0 = _mesh.axis_index(cm, seq) * t_loc
            valid = torch.arange(t0, t0 + t_loc, device=x.device) \
                <= cache_pos
            out = _attend_split(qg, k, v, valid, cm, seq)
        elif kv_cache is not None and s == 1:
            # decode: mask positions beyond cache_pos
            mask = (torch.arange(k.shape[1], device=x.device) <= cache_pos)
            out = _softmax_attend(qg, k, v, mask[None, None])
        else:
            out = _attend_chunked(qg, k, v,
                                  causal=causal and xattn_kv is None)
        if gather_q:
            hl, r = wq.shape[1], _mesh.axis_index(cm, MODEL)
            out = out.reshape(b, s, -1, out.shape[-1])[
                :, :, r * hl:(r + 1) * hl]
        return out.reshape(b, s, -1).to(x.dtype)

    y = L.blk_out(cfg, core, (x, p.wq, wk, wv, xattn_kv),
                  p.wo.to(x.dtype).reshape(-1, d))
    y = _mesh.reduce_from(y, mesh, MODEL, "blk_out")
    return y, caches[0] if len(caches) == 1 else None


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device="cuda"):
    hd = cfg.resolved_head_dim
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
