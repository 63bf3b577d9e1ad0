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


def _tp(p: AttnParams, cfg: ModelConfig, kv_cache):
    """The mesh when ``p`` holds this rank's heads only, else ``None``."""
    if p.wq.shape[1] == cfg.n_heads:
        return None
    if kv_cache is not None:
        raise NotImplementedError("attention over a model axis is "
                                  "partitioned in train mode only: the "
                                  "server runs on no mesh")
    return current_mesh()


def _kv_weights(p: AttnParams, cfg: ModelConfig, mesh):
    """This rank's ``wk`` and ``wv``: its blocks, or where the KV heads
    stay whole, the heads its query heads read (gradients summed over
    the model axis)."""
    if mesh is None or p.wk.shape[1] != cfg.n_kv_heads:
        return p.wk, p.wv
    sel = _kv_heads(cfg, p.wq.shape[1], _mesh.axis_index(mesh, MODEL))
    return tuple(_mesh.copy_to(w, mesh, MODEL)[:, sel] for w in (p.wk, p.wv))


def cross_kv(p: AttnParams, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention keys and values of ``enc_out`` for this rank's
    heads (all of them without a model axis)."""
    mesh = _tp(p, cfg, None)
    enc = _mesh.copy_to(enc_out, mesh, MODEL)
    return tuple(project_heads(enc, w) for w in _kv_weights(p, cfg, mesh))


def attention(p: AttnParams, x: torch.Tensor, cfg: ModelConfig, *,
              cos=None, sin=None, causal=True, kv_cache=None,
              cache_pos: int | None = None, xattn_kv=None):
    """Returns (out, new_kv_cache).

    modes:
      * prefill: x [B,S,D]; kv_cache None -> the cache returned is (k, v)
      * decode: x [B,1,D]; kv_cache (k_cache, v_cache) [B,T,Hkv,hd], which
        this call writes at ``cache_pos`` (an int) in place and returns
      * cross-attention: xattn_kv = (k, v) precomputed from an encoder
        (``cross_kv``).
    Where ``layers.blk_out`` keeps its result (``save_outs``, train) the
    cache returned is ``None``.
    """
    b, s, d = x.shape
    mesh = _tp(p, cfg, kv_cache)
    x = _mesh.copy_to(x, mesh, MODEL)
    wk, wv = _kv_weights(p, cfg, mesh)
    caches = []

    def core(x, wq, wk, wv, xattn_kv):
        """The attention output before ``wo``: [B, S, Hq_loc * hd]."""
        q = project_heads(x, wq)
        if xattn_kv is None:
            k, v = project_heads(x, wk), project_heads(x, wv)
            if cos is not None:
                q = L.apply_rope(q, cos, sin)
                k = L.apply_rope(k, cos, sin)
            caches.append((k, v))
            if kv_cache is not None:
                ck, cv = kv_cache
                _write(ck, k, cache_pos)
                _write(cv, v, cache_pos)
                caches[-1] = (ck, cv)
                k, v = ck, cv
        else:
            k, v = xattn_kv
            if cos is not None:
                q = L.apply_rope(q, cos, sin)
            caches.append(None)
        qg = _split_gqa(q, k.shape[2])
        if kv_cache is not None and s == 1:
            # decode: mask positions beyond cache_pos
            mask = (torch.arange(k.shape[1], device=x.device) <= cache_pos)
            out = _softmax_attend(qg, k, v, mask[None, None])
        else:
            out = _attend_chunked(qg, k, v,
                                  causal=causal and xattn_kv is None)
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
