"""LM assembly for all the assigned families (JAX
``models/transformer.py``).

* dense / vlm:      pre-norm GQA attention + MLP over stacked ``[L, ...]``
                    layer weights
* moe:              attention + top-k MoE (+ arctic's dense residual MLP)
* ssm (xlstm):      a list of mixed mLSTM/sLSTM layers
* hybrid (zamba2):  groups of ``attn_every`` Mamba-2 layers, one *shared*
                    attention + MLP block applied after each group (its KV
                    cache has one slot per application, not per layer)
* encdec (whisper): an encoder stack over stub frame embeddings and a
                    causal decoder with per-layer cross attention

The parameter trees are the reference's leaf for leaf (its NamedTuples'
names and field order, the xLSTM layer list), so weights cross
unchanged.  Modes: prefill (last-position logits + cache) and decode
(one token + cache); ``mode="train"`` is the LM training slice of ROADMAP
item 15 and raises ``NotImplementedError`` naming it.  The layers run
one after another in Python (the reference scans over them; without a
trace to build, remat and scanning have no counterpart here).

A forward scopes IEEE f32 in cuBLAS itself (``functional.ieee_f32``), as
the lowerings do: its results do not depend on the process's TF32 flags.
A decode cache (``init_cache``) holds ``"pos"`` (an int) and, by family,
``"kv"`` (K and V, ``[L, B, T, Hkv, hd]``; the hybrid's ``[G, B, T, Hkv,
hd]``, bf16 tensors that decode writes in place), ``"states"`` (xLSTM:
one state per layer), ``"ssm"`` (hybrid: the Mamba-2 states ``[G, A,
B, ...]``) and ``"cross"`` (Whisper: the encoder's keys and values per
decoder layer).

One divergence, deliberate: the reference re-encodes ``enc_embeds`` on
every Whisper decode call and never reads the result (decode takes the
cross keys and values from the cache); the port encodes at prefill only,
with equal logits.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.functional import ieee_f32
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.mlp import init_mlp, mlp

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is an LM family."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def _check_mode(cfg: ModelConfig, mode: str) -> None:
    check_family(cfg)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is the LM training slice "
                                  f"of ROADMAP item 15")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, generator, device, dtype, stack=(),
                ffn="mlp") -> dict:
    """norm1, attn, norm2 and ``ffn`` (an MLP or a MoE block; arctic's
    residual MLP too), stacked ``stack`` deep."""
    d = cfg.d_model
    kw = dict(device=device, stack=stack, dtype=dtype)
    p = {"norm1": L.ones_init((*stack, d), dtype, device),
         "attn": A.init_attention(generator, cfg, **kw),
         "norm2": L.ones_init((*stack, d), dtype, device)}
    if ffn == "moe":
        p["moe"] = MOE.init_moe(generator, cfg, **kw)
        if cfg.residual_mlp:
            p["res_mlp"] = init_mlp(generator, cfg, **kw)
    else:
        p["mlp"] = init_mlp(generator, cfg, **kw)
    return p


def _init_decoder_layers(cfg: ModelConfig, generator, device, dtype) -> dict:
    n, d = cfg.n_layers, cfg.d_model
    kw = dict(device=device, stack=(n,), dtype=dtype)
    return {"norm1": L.ones_init((n, d), dtype, device),
            "self_attn": A.init_attention(generator, cfg, **kw),
            "norm_x": L.ones_init((n, d), dtype, device),
            "cross_attn": A.init_attention(generator, cfg, **kw),
            "norm2": L.ones_init((n, d), dtype, device),
            "mlp": init_mlp(generator, cfg, **kw)}


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return bool(cfg.slstm_every) and i % cfg.slstm_every == 0


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device="cuda", dtype=torch.float32) -> dict:
    """The model's parameters drawn from ``generator`` (on its device,
    each leaf cast to ``dtype`` as it is drawn, then moved to ``device``;
    ``device="meta"`` gives shapes without drawing)."""
    check_family(cfg)
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": L.dense_init(generator, (cfg.vocab, d), scale=0.02,
                              dtype=dtype, device=device),
        "final_norm": L.ones_init((d,), dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (cfg.vocab, d),
                                         scale=0.02, dtype=dtype,
                                         device=device)
    fam = cfg.family
    n = cfg.n_layers
    if fam in ("dense", "vlm"):
        params["layers"] = _init_block(cfg, generator, device, dtype, (n,))
    elif fam == "moe":
        params["layers"] = _init_block(cfg, generator, device, dtype, (n,),
                                       ffn="moe")
    elif fam == "ssm":
        if cfg.ssm_block != "xlstm":
            raise ValueError(cfg.ssm_block)
        params["layers"] = [
            (S.init_slstm if _is_slstm(cfg, i) else S.init_mlstm)(
                generator, cfg, device, dtype=dtype) for i in range(n)]
    elif fam == "hybrid":
        if cfg.ssm_block != "mamba2" or not cfg.attn_every \
                or n % cfg.attn_every:
            raise ValueError(f"a hybrid takes Mamba-2 layers in groups of "
                             f"attn_every: {cfg.ssm_block}, {n}, "
                             f"{cfg.attn_every}")
        params["layers"] = S.init_mamba2(generator, cfg, device, stack=(n,),
                                         dtype=dtype)
        params["shared_attn"] = _init_block(cfg, generator, device, dtype)
    else:                                       # encdec
        params["encoder_layers"] = _init_block(
            cfg, generator, device, dtype, (cfg.n_enc_layers,))
        params["layers"] = _init_decoder_layers(cfg, generator, device,
                                                dtype)
        params["enc_pos"] = L.dense_init(generator, (cfg.enc_seq, d),
                                         scale=0.02, dtype=dtype,
                                         device=device)
        params["enc_final_norm"] = L.ones_init((d,), dtype, device)
    return params


def param_count(values) -> int:
    return sum(v.numel() for v in _tree.leaves(values))


def active_param_count(values, cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = param_count(values)
    if cfg.family != "moe":
        return total
    expert = sum(v.numel() for f in ("w_in", "w_gate", "w_out")
                 for v in _extract_moe_leaves(values, f))
    return total - expert + int(expert * cfg.top_k / cfg.n_experts)


def _extract_moe_leaves(values, field):
    out = []

    def visit(node):
        if isinstance(node, MOE.MoeParams):
            v = getattr(node, field)
            if v is not None:
                out.append(v)
        elif isinstance(node, dict):
            for x in node.values():
                visit(x)
        elif isinstance(node, (list, tuple)):
            for x in node:
                visit(x)
    visit(values)
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_block(p, h, cfg, cos, sin, kv=None, pos=None):
    """The attention half of a block: h + attn(norm1(h)), and its kv."""
    a, new_kv = A.attention(
        p["attn"], L.rmsnorm(h, p["norm1"], cfg.norm_eps), cfg,
        cos=cos, sin=sin, kv_cache=kv, cache_pos=pos)
    return h + a, new_kv


def _dense_block(lp, h, cfg, cos, sin, kv=None, pos=None):
    h, new_kv = _attn_block(lp, h, cfg, cos, sin, kv, pos)
    m = mlp(lp["mlp"], L.rmsnorm(h, lp["norm2"], cfg.norm_eps), cfg)
    return h + m, new_kv


def _moe_block(lp, h, cfg, cos, sin, kv=None, pos=None):
    h, new_kv = _attn_block(lp, h, cfg, cos, sin, kv, pos)
    hn = L.rmsnorm(h, lp["norm2"], cfg.norm_eps)
    m, aux = MOE.moe_dispatch(lp["moe"], hn, cfg)
    if "res_mlp" in lp:
        m = m + mlp(lp["res_mlp"], hn, cfg)
    return h + m, new_kv, aux


def _rope(cfg: ModelConfig, positions, mrope_positions=None):
    hd = cfg.resolved_head_dim
    if cfg.mrope:
        if mrope_positions is None:
            mrope_positions = positions[None].expand(3, *positions.shape)
        return L.mrope_cos_sin(mrope_positions, hd, cfg.mrope_sections,
                               cfg.rope_theta)
    return L.rope_cos_sin(positions, hd, cfg.rope_theta)


def _layer(tree, i):
    """Layer ``i`` of a stacked ``[L, ...]`` tree."""
    return _tree.tree_map(lambda v: v[i], tree)


def _stack(trees):
    """Trees of one structure -> one tree of their leaves stacked."""
    return _tree.tree_map(lambda *vs: torch.stack(vs), *trees)


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def backbone(params, cfg: ModelConfig, h, *, mode: str, cache=None,
             positions, mrope_positions=None, enc_out=None):
    """h [B,S,D] -> (h, new_cache, aux_loss).  ``enc_out`` (Whisper's
    encoder output) is read by the prefill only."""
    _check_mode(cfg, mode)
    cos, sin = _rope(cfg, positions, mrope_positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    fam = cfg.family
    decode = mode == "decode"
    pos = int(cache["pos"]) if decode else None
    new_pos = pos + 1 if decode else h.shape[1]
    layers = params["layers"]

    if fam in ("dense", "vlm", "moe"):
        kvs = cache["kv"] if decode else None
        out = []
        for i in range(cfg.n_layers):
            kv = (kvs[0][i], kvs[1][i]) if decode else None
            if fam == "moe":
                h, kv, a = _moe_block(_layer(layers, i), h, cfg, cos, sin,
                                      kv, pos)
                aux = aux + a
            else:
                h, kv = _dense_block(_layer(layers, i), h, cfg, cos, sin,
                                     kv, pos)
            out.append(kv)
        if not decode:
            kvs = (torch.stack([k for k, _ in out]),
                   torch.stack([v for _, v in out]))
        return h, {"kv": kvs, "pos": new_pos}, aux

    if fam == "ssm":
        states = cache["states"] if decode else [None] * cfg.n_layers
        new_states = []
        for i, lp in enumerate(layers):
            if _is_slstm(cfg, i):
                step = S.slstm_decode if decode else S.slstm_block
            else:
                step = S.mlstm_decode if decode else S.mlstm_block
            h, st = step(lp, h, cfg, states[i])
            new_states.append(st)
        return h, {"states": new_states, "pos": new_pos}, aux

    if fam == "hybrid":
        groups, per = cfg.n_layers // cfg.attn_every, cfg.attn_every
        sp = params["shared_attn"]
        new_ssm, new_kv = [], []
        for g in range(groups):
            sts = []
            for a in range(per):
                lp = _layer(layers, g * per + a)
                if decode:
                    st = _tree.tree_map(lambda v: v[g, a], cache["ssm"])
                    h, st = S.mamba2_decode(lp, h, cfg, st)
                else:
                    h, st = S.mamba2_block(lp, h, cfg)
                sts.append(st)
            new_ssm.append(_stack(sts))
            # the shared attention block after each group
            kv = (cache["kv"][0][g], cache["kv"][1][g]) if decode else None
            h, kv = _attn_block(sp, h, cfg, cos, sin, kv, pos)
            h = h + mlp(sp["mlp"], L.rmsnorm(h, sp["norm2"], cfg.norm_eps),
                        cfg)
            new_kv.append(kv)
        kvs = cache["kv"] if decode else _stack(new_kv)
        return h, {"ssm": _stack(new_ssm), "kv": kvs, "pos": new_pos}, aux

    # encdec
    kvs, cross = (cache["kv"], cache["cross"]) if decode else (None, None)
    out = []
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        a, kv = A.attention(
            lp["self_attn"], L.rmsnorm(h, lp["norm1"], cfg.norm_eps), cfg,
            cos=cos, sin=sin, cache_pos=pos,
            kv_cache=(kvs[0][i], kvs[1][i]) if decode else None)
        h = h + a
        if decode:
            xkv = (cross[0][i], cross[1][i])
        else:
            xkv = tuple(A.project_heads(enc_out, w) for w in
                        (lp["cross_attn"].wk, lp["cross_attn"].wv))
        c, _ = A.attention(lp["cross_attn"],
                           L.rmsnorm(h, lp["norm_x"], cfg.norm_eps), cfg,
                           xattn_kv=xkv)
        h = h + c
        h = h + mlp(lp["mlp"], L.rmsnorm(h, lp["norm2"], cfg.norm_eps), cfg)
        out.append((kv, xkv))
    if not decode:
        kvs = _stack([kv for kv, _ in out])
        cross = _stack([xkv for _, xkv in out])
    return h, {"kv": kvs, "cross": cross, "pos": new_pos}, aux


def encode(params, cfg: ModelConfig, enc_embeds):
    """Whisper encoder over stub frame embeddings [B, T, D]: bidirectional
    attention with no rotary, then the final norm."""
    h = enc_embeds + params["enc_pos"].to(enc_embeds.dtype)[None]
    enc = params["encoder_layers"]
    for i in range(cfg.n_enc_layers):
        lp = _layer(enc, i)
        a, _ = A.attention(lp["attn"],
                           L.rmsnorm(h, lp["norm1"], cfg.norm_eps), cfg,
                           causal=False)
        h = h + a
        h = h + mlp(lp["mlp"], L.rmsnorm(h, lp["norm2"], cfg.norm_eps), cfg)
    return L.rmsnorm(h, params["enc_final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Heads / entry points
# ---------------------------------------------------------------------------

def logits_fn(params, cfg: ModelConfig, h):
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    table = params.get("lm_head", params["embed"])
    return h @ table.to(h.dtype).T


def forward(params, cfg: ModelConfig, batch: dict, *, mode: str = "train",
            cache=None, param_dtype=torch.bfloat16):
    """Unified entry point: ``(logits, cache)`` for ``mode`` "prefill"
    (the last position's logits) or "decode" (one token against
    ``cache``).

    batch keys: tokens [B,S]; enc_embeds [B,T,D] (encdec prefill; a
    decode ignores it); mrope_positions [3,B,S] (vlm); prefix_embeds
    [B,P,D] (vlm: stands in for the first P tokens).
    """
    _check_mode(cfg, mode)
    with ieee_f32():
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = L.embed_lookup(params["embed"], tokens).to(param_dtype)

        if batch.get("prefix_embeds") is not None:
            pe = batch["prefix_embeds"].to(h.dtype)
            h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)

        if mode == "decode":
            positions = torch.full((b, 1), int(cache["pos"]),
                                   device=tokens.device)
        else:
            positions = torch.arange(s, device=tokens.device)[None].expand(
                b, s)

        mrope_positions = batch.get("mrope_positions")
        if mrope_positions is not None and mode == "decode":
            mrope_positions = torch.full((3, b, 1), int(cache["pos"]),
                                         device=tokens.device)

        enc_out = None
        if cfg.family == "encdec" and mode == "prefill":
            enc_out = encode(params, cfg,
                             batch["enc_embeds"].to(param_dtype))

        h, new_cache, _ = backbone(
            params, cfg, h, mode=mode, cache=cache, positions=positions,
            mrope_positions=mrope_positions, enc_out=enc_out)
        if mode == "prefill":
            h = h[:, -1:]
        return logits_fn(params, cfg, h), new_cache


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int):
    """Decode cache (zeros) for one new token against a ``max_len``
    context, on the device of ``params``."""
    check_family(cfg)
    dev = params["embed"].device
    bf16 = torch.bfloat16
    cache: dict[str, Any] = {"pos": max_len - 1}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "encdec"):
        cache["kv"] = A.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                      device=dev)
    if fam == "ssm":
        cache["states"] = [
            S.init_slstm_state(cfg, batch, dev) if _is_slstm(cfg, i)
            else S.init_ssm_state(cfg, batch, dev)
            for i in range(cfg.n_layers)]
    elif fam == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        st, conv = S.init_ssm_state(cfg, batch, dev)
        cache["ssm"] = tuple(
            v[None, None].repeat(groups, cfg.attn_every,
                                 *([1] * v.dim())) for v in (st, conv))
        cache["kv"] = A.init_kv_cache(cfg, batch, max_len, groups,
                                      device=dev)
    elif fam == "encdec":
        shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache["cross"] = (torch.zeros(shape, dtype=bf16, device=dev),
                          torch.zeros(shape, dtype=bf16, device=dev))
    return cache
