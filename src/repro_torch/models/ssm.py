"""Recurrent blocks (JAX ``models/ssm.py``): a chunkwise gated-linear-
attention (GLA) engine shared by xLSTM's mLSTM and Mamba-2's SSD, and
the sLSTM step recurrence.

All are states of the form  S_t = exp(ld_t) * S_{t-1} + k_t v_t^T,
y_t = q_t @ S_t, computed chunkwise (within a chunk a masked decay
matrix, across chunks a loop over states); decode is one ``gla_step``
per token.  The recurrences run in f32; xLSTM's exponential input gate
is the reference's sigmoid gate folded into k.

The dtypes are the reference's op by op: the gates, ``softplus`` and
``log_sigmoid`` in f32, ``k / sqrt(dk)`` and ``k * i_g`` in the
activations' dtype, the GLA output cast to it before the head norm, the
conv caches bf16 until a prefill's tail replaces them.  ``silu`` is the
reference's op sequence (``layers.silu``), so bf16 rounds as XLA's does.

The prefill's conv tail (the last three pre-conv inputs) comes from the
projection the block has already computed; the reference computes that
projection a second time, with equal values.

On a mesh with a ``model`` axis (train mode) the blocks are
tensor-parallel under the reference's logical axes.  mLSTM: each rank's
columns of ``w_up`` (its block of the concatenated ``[a | z]``) are
gathered, the rank keeps its channel block of ``a`` and ``z``, its
conv channels and its rows of ``wq``/``wk``/``wv``/``w_gates`` give
partial products summed over the axis, the recurrence runs on every
head on every rank, and the rank's channels of the gated output go
through its rows of ``w_down`` (an all-reduce).  sLSTM: the recurrence
on every rank, the MLP column- and row-parallel.  Mamba-2: ``w_in``'s
column blocks gathered, the SSM on every rank, the rank's channels of
the gated output through its rows of ``w_out``.  A leaf whose dim the
axis does not divide stays whole, and its product runs on every rank.
The serve steps (prefill, decode) keep the caches in
``transformer.cache_logical``'s layout: the mLSTM's state whole and its
conv cache the rank's channels, as the train path computes them; the
Mamba-2 state the rank's heads where the axis divides them, so the
serve path runs the SSM on those heads alone (``_m2_heads``; the conv
cache whole), its gated output this rank's channels for its rows of
``w_out``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import project_heads
from repro_torch.sharding import mesh as _mesh
from repro_torch.sharding.partition import current_mesh

_CONV = 4           # the depthwise causal conv's width
MODEL = ("model",)


def _model_shard(sharded: bool):
    """(mesh, axis size, this rank's index) where a block's leaves are
    this rank's blocks, else (None, 1, 0)."""
    if not sharded:
        return None, 1, 0
    mesh = current_mesh()
    return (mesh, _mesh.axis_size(mesh, MODEL),
            _mesh.axis_index(mesh, MODEL))


def _own(t: torch.Tensor, start: int, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s block of ``n`` channels of ``t``'s last dim, from
    ``start``."""
    return t[..., start + r * n:start + (r + 1) * n]


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x):
    return -_softplus(-x)


# ---------------------------------------------------------------------------
# Chunkwise GLA engine
# ---------------------------------------------------------------------------

def gla_chunked(q, k, v, log_decay, chunk: int, state0=None):
    """q,k [B,S,H,dk]; v [B,S,H,dv]; log_decay [B,S,H] (<= 0).

    Returns (y [B,S,H,dv], final_state [B,H,dk,dv]), all f32.  The
    sequence is zero-padded to a multiple of ``chunk`` (a padded step
    has decay 1 and k = 0, so it leaves the state as it is) and y cropped
    back.  Above the diagonal ``b_l - b_m`` is positive and its ``exp``
    may overflow, so the exponent is masked to ``-inf`` before the
    ``exp``: the reference masks after it, which leaves the forward's
    values as these but makes its gradient NaN (a zero cotangent times
    an infinite decay) once a chunk's decay sums past f32's ``exp`` limit
    (zamba2's Mamba-2 decay, ~-0.7 a token at init, over its 256-token
    chunk)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    q, k, v, log_decay = (a.float() for a in (q, k, v, log_decay))
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_decay = F.pad(log_decay, (0, 0, 0, pad))
    state = (state0 if state0 is not None
             else q.new_zeros((b, h, dk, dv)))
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=q.device))
    ys = []
    for start in range(0, s + pad, chunk):
        sl = slice(start, start + chunk)
        qi, ki, vi = q[:, sl], k[:, sl], v[:, sl]            # [B,L,H,*]
        bi = torch.cumsum(log_decay[:, sl], dim=1)  # inclusive prefix
        bl = bi[:, -1]                                       # [B,H]
        # inter-chunk: y += (q_i * exp(b_i)) @ S_prev
        y_inter = torch.einsum("blhk,bhkv->blhv",
                               qi * torch.exp(bi)[..., None], state)
        # intra-chunk: att_lm = (q_l . k_m) exp(b_l - b_m), m <= l
        att = torch.einsum("blhk,bmhk->bhlm", qi, ki)
        ldiff = (bi[:, :, None] - bi[:, None, :]).permute(0, 3, 1, 2)
        att = att * torch.exp(torch.where(lower, ldiff, -math.inf))
        att = torch.where(lower, att, 0.0)
        y_intra = torch.einsum("bhlm,bmhv->blhv", att, vi)
        # state update with end-of-chunk decay alignment
        kscale = ki * torch.exp(bl[:, None] - bi)[..., None]
        state = state * torch.exp(bl)[..., None, None] + torch.einsum(
            "bmhk,bmhv->bhkv", kscale, vi)
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1)[:, :s], state


def gla_step(state, q, k, v, log_decay):
    """One decode step: q,k [B,H,dk]; v [B,H,dv]; log_decay [B,H]."""
    state = state * torch.exp(log_decay.float())[..., None, None] + \
        k.float()[..., :, None] * v.float()[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return state, y


def gla_reference(q, k, v, log_decay, state0=None):
    """Naive per-step oracle (tests)."""
    b, s, h, dk = q.shape
    state = (state0 if state0 is not None
             else q.new_zeros((b, h, dk, v.shape[-1]), dtype=torch.float32))
    ys = []
    for t in range(s):
        state, y = gla_step(state, q[:, t], k[:, t], v[:, t],
                            log_decay[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


def causal_conv1d(x, kernel, cache=None):
    """x [B,S,C]; kernel [W,C] depthwise causal conv.  With ``cache``
    ([B,W-1,C]) runs one decode step (S==1) and returns (y, new_cache);
    the cache takes the promoted dtype of it and ``x``, as in the
    reference."""
    w = kernel.shape[0]
    if cache is not None:
        window = torch.cat([cache, x], dim=1)               # [B,W,C]
        y = torch.einsum("bwc,wc->bc", window.float(), kernel.float())
        return y[:, None].to(x.dtype), window[:, 1:]
    xp = F.pad(x, (0, 0, w - 1, 0))
    s = x.shape[1]
    y = sum(xp[:, i:i + s].float() * kernel[i].float() for i in range(w))
    return y.to(x.dtype), None


def _conv_tail(a):
    """The last W-1 positions of the conv's input [B,S,C], zero-padded in
    front when S < W-1: the decode cache a prefill leaves."""
    tail = a[:, -(_CONV - 1):]
    return F.pad(tail, (0, 0, _CONV - 1 - tail.shape[1], 0))


# ---------------------------------------------------------------------------
# mLSTM (xLSTM) block
# ---------------------------------------------------------------------------

class MLstmParams(NamedTuple):
    norm: torch.Tensor        # [D]
    w_up: torch.Tensor        # [D, 2*Di]
    conv: torch.Tensor        # [4, Di]
    wq: torch.Tensor          # [Di, H, dk]
    wk: torch.Tensor          # [Di, H, dk]
    wv: torch.Tensor          # [Di, H, dv]
    w_gates: torch.Tensor     # [Di, 2*H]  (input, forget)
    b_gates: torch.Tensor     # [2*H]
    head_norm: torch.Tensor   # [H, dv]
    w_down: torch.Tensor      # [Di, D]


def init_mlstm(generator: torch.Generator, cfg: ModelConfig, device="cuda",
               dtype=torch.float32) -> MLstmParams:
    d = cfg.d_model
    di = 2 * d
    h = cfg.n_heads
    dk = dv = di // h

    def w(shape, logical, scale=None):
        return L.dense_init(generator, shape, scale=scale, dtype=dtype,
                            device=device, logical=logical)

    heads = ("model", None, None)
    return MLstmParams(
        norm=L.ones_init((d,), dtype, device),
        w_up=w((d, 2 * di), ("fsdp", "model")),
        conv=w((_CONV, di), (None, "model"), 0.5),
        wq=w((di, h, dk), heads),
        wk=w((di, h, dk), heads),
        wv=w((di, h, dv), heads),
        w_gates=w((di, 2 * h), ("model", None)),
        b_gates=L.zeros_init((2 * h,), dtype, device),
        head_norm=L.ones_init((h, dv), dtype, device),
        w_down=w((di, d), ("model", "fsdp")),
    )


def _mlstm_qkv(p: MLstmParams, x, cfg, conv_cache=None):
    """(q, k, v_ext, log_f, z, new_conv, a): the reference's six and the
    conv's input ``a``, whose tail a prefill keeps (on a model axis: this
    rank's channels of ``z`` and ``a``)."""
    mesh, m, r = _model_shard(p.wq.shape[0] != 2 * cfg.d_model)
    h0 = _mesh.copy_to(L.rmsnorm(x, p.norm, cfg.norm_eps), mesh, MODEL)
    up = _mesh.gather_from(h0 @ p.w_up.to(x.dtype), mesh, MODEL, -1)
    di = up.shape[-1] // 2
    a, z = _own(up, 0, di // m, r), _own(up, di, di // m, r)
    a_c, new_conv = causal_conv1d(a, p.conv, conv_cache)
    a_c = L.silu(a_c)
    dk = p.wq.shape[-1]
    nh = p.wq.shape[1]

    def part(t):
        """A product over this rank's channels, summed over the axis."""
        return _mesh.reduce_from(t, mesh, MODEL)
    q = part(project_heads(a_c, p.wq))
    k = part(project_heads(a_c, p.wk)) / math.sqrt(dk)
    v = part(project_heads(a, p.wv))
    gates = part(a_c.float() @ p.w_gates.float()) + p.b_gates
    i_g = torch.sigmoid(gates[..., :nh])                 # input gate
    log_f = _log_sigmoid(gates[..., nh:] + 3.0)          # forget gate (log)
    k = k * i_g[..., None].to(k.dtype)
    # normalizer channel: extend v with ones
    v_ext = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    return q, k, v_ext, log_f, z, new_conv, a


def _mlstm_out(p: MLstmParams, y_ext, z, x, cfg):
    mesh, m, r = _model_shard(p.wq.shape[0] != 2 * cfg.d_model)
    dv = p.wv.shape[-1]
    y, n = y_ext[..., :dv], y_ext[..., dv:]
    y = y / torch.clamp(torch.abs(n), min=1.0)
    y = L.rmsnorm(y, p.head_norm, cfg.norm_eps).to(x.dtype)
    y = y.reshape(*y.shape[:-2], -1)
    y = _own(_mesh.copy_to(y, mesh, MODEL), 0, y.shape[-1] // m, r)
    out = L._mm_out(y * L.silu(z), p.w_down.to(x.dtype))
    return x + _mesh.reduce_from(out, mesh, MODEL, "blk_out")


def mlstm_block(p: MLstmParams, x, cfg: ModelConfig, state=None):
    """Prefill: x [B,S,D]; returns (y, (gla_state, conv_tail))."""
    q, k, v_ext, log_f, z, _, a = _mlstm_qkv(p, x, cfg)
    st0 = state[0] if state is not None else None
    y_ext, st = gla_chunked(q, k, v_ext, log_f, cfg.ssm_chunk, st0)
    return _mlstm_out(p, y_ext.to(x.dtype), z, x, cfg), (st, _conv_tail(a))


def mlstm_decode(p: MLstmParams, x, cfg: ModelConfig, state):
    """x [B,1,D]; state (gla_state [B,H,dk,dv+1], conv_cache [B,3,Di])."""
    gla_st, conv_cache = state
    q, k, v_ext, log_f, z, new_conv, _ = _mlstm_qkv(p, x, cfg, conv_cache)
    st, y = gla_step(gla_st, q[:, 0], k[:, 0], v_ext[:, 0], log_f[:, 0])
    return _mlstm_out(p, y[:, None].to(x.dtype), z, x, cfg), (st, new_conv)


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

class SLstmParams(NamedTuple):
    norm: torch.Tensor        # [D]
    w_x: torch.Tensor         # [D, 4*D] (z, i, f, o pre-activations)
    w_r: torch.Tensor         # [H, dh, 4*dh] recurrent, block-diagonal
    bias: torch.Tensor        # [4*D]
    w_mlp_in: torch.Tensor    # [D, F]
    w_mlp_gate: torch.Tensor
    w_mlp_out: torch.Tensor
    norm2: torch.Tensor


def init_slstm(generator: torch.Generator, cfg: ModelConfig, device="cuda",
               dtype=torch.float32) -> SLstmParams:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    f = 2 * d

    def w(shape, logical):
        return L.dense_init(generator, shape, dtype=dtype, device=device,
                            logical=logical)

    return SLstmParams(
        norm=L.ones_init((d,), dtype, device),
        w_x=w((d, 4 * d), ("fsdp", None)),
        w_r=w((h, dh, 4 * dh), (None, None, None)),
        bias=L.zeros_init((4 * d,), dtype, device),
        w_mlp_in=w((d, f), ("fsdp", "model")),
        w_mlp_gate=w((d, f), ("fsdp", "model")),
        w_mlp_out=w((f, d), ("model", "fsdp")),
        norm2=L.ones_init((d,), dtype, device),
    )


def _slstm_cell(p: SLstmParams, xt, hcn, cfg):
    """One step: xt [B,4D] (pre-projected), state (h, c, n) each [B,D]."""
    h_prev, c_prev, n_prev = hcn
    b = xt.shape[0]
    nh, dh = p.w_r.shape[0], p.w_r.shape[1]
    hh = h_prev.reshape(b, nh, dh)
    rec = torch.einsum("bhd,hdg->bhg", hh, p.w_r.float())
    rec = rec.reshape(b, nh, 4, dh).transpose(1, 2).reshape(b, 4 * nh * dh)
    pre = xt + rec + p.bias
    d = nh * dh
    z = torch.tanh(pre[:, :d])
    i = torch.sigmoid(pre[:, d:2 * d])
    f = torch.sigmoid(pre[:, 2 * d:3 * d] + 3.0)
    o = torch.sigmoid(pre[:, 3 * d:])
    c = f * c_prev + i * z
    n = f * n_prev + i
    h = o * c / torch.clamp(n, min=1e-6)
    return (h, c, n)


def slstm_block(p: SLstmParams, x, cfg: ModelConfig, state=None):
    """x [B,S,D] -> (y, state): a loop over time (the sLSTM has no
    parallel form), then the block's gated MLP."""
    b, s, d = x.shape
    h0 = L.rmsnorm(x, p.norm, cfg.norm_eps)
    xt = h0.float() @ p.w_x.float()
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    hs = []
    for step in range(s):
        state = _slstm_cell(p, xt[:, step], state, cfg)
        hs.append(state[0])
    x = x + torch.stack(hs, dim=1).to(x.dtype)
    # post MLP (column- and row-parallel on a model axis)
    mesh, _, _ = _model_shard(p.w_mlp_in.shape[1] != 2 * cfg.d_model)
    h2 = _mesh.copy_to(L.rmsnorm(x, p.norm2, cfg.norm_eps), mesh, MODEL)
    g = h2 @ p.w_mlp_gate.to(x.dtype)
    u = h2 @ p.w_mlp_in.to(x.dtype)
    out = L._mm_out(L.silu(g) * u, p.w_mlp_out.to(x.dtype))
    return x + _mesh.reduce_from(out, mesh, MODEL, "blk_out"), state


def slstm_decode(p: SLstmParams, x, cfg: ModelConfig, state):
    return slstm_block(p, x, cfg, state)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block: zamba2
# ---------------------------------------------------------------------------

class Mamba2Params(NamedTuple):
    norm: torch.Tensor
    w_in: torch.Tensor        # [D, Di(z) + Di(x) + 2N + H(dt)]
    conv: torch.Tensor        # [4, Di + 2N]
    a_log: torch.Tensor       # [H]
    dt_bias: torch.Tensor     # [H]
    d_skip: torch.Tensor      # [H]
    w_out: torch.Tensor       # [Di, D]


def _m2_dims(cfg: ModelConfig):
    d = cfg.d_model
    di = 2 * d
    head_p = 64
    h = di // head_p
    n = cfg.ssm_state
    return d, di, h, head_p, n


def init_mamba2(generator: torch.Generator, cfg: ModelConfig, device="cuda",
                stack: tuple[int, ...] = (),
                dtype=torch.float32) -> Mamba2Params:
    """One Mamba-2 block's weights, or ``stack`` of them stacked in
    front."""
    d, di, h, hp, n = _m2_dims(cfg)

    def w(shape, logical, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return L.dense_init(generator, (*stack, *shape), scale=scale,
                            dtype=dtype, device=device, logical=logical)

    def const(init, shape):
        return init((*stack, *shape), dtype, device)

    return Mamba2Params(
        norm=const(L.ones_init, (d,)),
        w_in=w((d, 2 * di + 2 * n + h), ("fsdp", "model")),
        conv=w((_CONV, di + 2 * n), (None, None), 0.5),
        a_log=const(L.zeros_init, (h,)),
        dt_bias=const(L.zeros_init, (h,)),
        d_skip=const(L.ones_init, (h,)),
        w_out=w((di, d), ("model", "fsdp")),
    )


def _m2_proj(p: Mamba2Params, x, cfg, conv_cache=None, normed=False):
    """(q, k, v, log_decay, xs, z, new_conv, xbc): the reference's seven
    and the conv's input ``xbc``, whose tail a prefill keeps (``normed``:
    ``x`` is the block's normed input already).  On a model axis the
    ranks' column blocks of the projection are gathered, and everything
    after it runs whole on every rank (1 / n of its gradient each)."""
    d, di, h, hp, n = _m2_dims(cfg)
    mesh, m, _ = _model_shard(p.w_in.shape[1] != 2 * di + 2 * n + h)
    h0 = x if normed else L.rmsnorm(x, p.norm, cfg.norm_eps)
    h0 = _mesh.copy_to(h0, mesh, MODEL)
    up = _mesh.scale_grad(_mesh.gather_from(h0 @ p.w_in.to(x.dtype), mesh,
                                            MODEL, -1), 1 / m)
    z = up[..., :di]
    xbc_in = up[..., di:di + di + 2 * n]
    dt_raw = up[..., di + di + 2 * n:]
    xbc, new_conv = causal_conv1d(xbc_in, p.conv, conv_cache)
    xbc = L.silu(xbc)
    xs = xbc[..., :di]
    bmat = xbc[..., di:di + n]
    cmat = xbc[..., di + n:]
    bsz, s = x.shape[:2]
    xs = xs.reshape(bsz, s, h, hp)
    dt = _softplus(dt_raw.float() + p.dt_bias)                 # [B,S,H]
    log_decay = -torch.exp(p.a_log.float()) * dt
    # roles: q = C, k = B, v = dt * x   (state [N, P] per head)
    q = cmat[:, :, None].expand(bsz, s, h, n)
    k = bmat[:, :, None].expand(bsz, s, h, n)
    v = xs * dt[..., None].to(xs.dtype)
    return q, k, v, log_decay, xs, z, new_conv, xbc_in


def _m2_gated(p: Mamba2Params, y, xs, z, x, cfg, heads=slice(None)):
    """The block's output before ``w_out``: the skip and the z gate (of
    the SSM heads ``heads``, whose channels ``y``, ``xs`` and ``z`` hold)."""
    y = y + xs.float() * p.d_skip[heads][None, None, :, None]
    y = y.reshape(*y.shape[:2], -1).to(x.dtype)
    return y * L.silu(z)


def _m2_rows(p: Mamba2Params, y: torch.Tensor, cfg) -> torch.Tensor:
    """This rank's channels of the gated output, for its rows of
    ``w_out`` (all of them without a model axis)."""
    mesh, m, r = _model_shard(p.w_out.shape[0] != _m2_dims(cfg)[1])
    return _own(_mesh.copy_to(y, mesh, MODEL), 0, y.shape[-1] // m, r)


def _m2_sum(p: Mamba2Params, out: torch.Tensor, cfg) -> torch.Tensor:
    mesh, _, _ = _model_shard(p.w_out.shape[0] != _m2_dims(cfg)[1])
    return _mesh.reduce_from(out, mesh, MODEL, "blk_out")


def _m2_out(p: Mamba2Params, y, xs, z, x, cfg, heads=None):
    """The block's output; ``heads``: the serve path's SSM heads
    (``_m2_heads``), whose channels are this rank's rows of ``w_out``."""
    if heads is None:
        rows = _m2_rows(p, _m2_gated(p, y, xs, z, x, cfg), cfg)
    else:
        rows = _m2_gated(p, y, xs, z, x, cfg, heads)
    return x + _m2_sum(p, L._mm_out(rows, p.w_out.to(x.dtype)), cfg)


def _m2_heads(cfg: ModelConfig):
    """The SSM heads a serve step runs on this rank: its block where the
    ``model`` axis divides them (the state's layout), else ``None``
    (every head, the train path's way)."""
    mesh = current_mesh()
    h = _m2_dims(cfg)[2]
    if mesh is None or mesh.shape.get("model", 1) == 1 \
            or h % mesh.shape["model"]:
        return None
    hl = h // mesh.shape["model"]
    r = _mesh.axis_index(mesh, MODEL)
    return slice(r * hl, (r + 1) * hl)


def _m2_serve_proj(p: Mamba2Params, x, cfg, conv_cache=None):
    """``_m2_proj``, its per-head values cut to ``_m2_heads`` (and ``z``
    to their channels): (heads, q, k, v, log_decay, xs, z, new_conv,
    xbc)."""
    q, k, v, ld, xs, z, new_conv, xbc = _m2_proj(p, x, cfg, conv_cache)
    heads = _m2_heads(cfg)
    if heads is not None:
        hp = _m2_dims(cfg)[3]
        q, k, v, ld, xs = (t[:, :, heads] for t in (q, k, v, ld, xs))
        z = z[..., heads.start * hp:heads.stop * hp]
    return heads, q, k, v, ld, xs, z, new_conv, xbc


def mamba2_block(p: Mamba2Params, x, cfg: ModelConfig, state=None):
    """Prefill: x [B,S,D]; returns (y, (gla_state, conv_tail))."""
    heads, q, k, v, log_decay, xs, z, _, xbc_in = _m2_serve_proj(p, x, cfg)
    st0 = state[0] if state is not None else None
    y, st = gla_chunked(q, k, v, log_decay, cfg.ssm_chunk, st0)
    return _m2_out(p, y, xs, z, x, cfg, heads), (st, _conv_tail(xbc_in))


def mamba2_train(p: Mamba2Params, x, cfg: ModelConfig):
    """``mamba2_block``'s output alone, its out-projection a
    ``layers.blk_out`` (kept under ``remat_policy="save_outs"``)."""
    def core(h0, p):
        q, k, v, log_decay, xs, z, _, _ = _m2_proj(p, h0, cfg, normed=True)
        y, _ = gla_chunked(q, k, v, log_decay, cfg.ssm_chunk)
        return _m2_rows(p, _m2_gated(p, y, xs, z, h0, cfg), cfg)
    h0 = L.rmsnorm(x, p.norm, cfg.norm_eps)
    out = L.blk_out(cfg, core, (h0, p), p.w_out.to(x.dtype))
    return x + _m2_sum(p, out, cfg)


def mamba2_decode(p: Mamba2Params, x, cfg: ModelConfig, state):
    gla_st, conv_cache = state
    heads, q, k, v, log_decay, xs, z, new_conv, _ = _m2_serve_proj(
        p, x, cfg, conv_cache)
    st, y = gla_step(gla_st, q[:, 0], k[:, 0], v[:, 0], log_decay[:, 0])
    return _m2_out(p, y[:, None], xs, z, x, cfg, heads), (st, new_conv)


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return (z, z, z)


def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda"):
    """Decode state of one layer of the configured SSM family: (the GLA
    state in f32, the conv cache in bf16)."""
    if cfg.ssm_block == "mamba2":
        d, di, h, hp, n = _m2_dims(cfg)
        shapes = ((batch, h, n, hp), (batch, _CONV - 1, di + 2 * n))
    elif cfg.ssm_block == "xlstm":
        di = 2 * cfg.d_model
        dk = di // cfg.n_heads
        shapes = ((batch, cfg.n_heads, dk, dk + 1), (batch, _CONV - 1, di))
    else:
        raise ValueError(cfg.ssm_block)
    return (torch.zeros(shapes[0], dtype=torch.float32, device=device),
            torch.zeros(shapes[1], dtype=torch.bfloat16, device=device))
