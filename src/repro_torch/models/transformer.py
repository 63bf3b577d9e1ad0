"""LM assembly of the dense and VLM families (JAX ``models/transformer.py``).

* dense / vlm: pre-norm GQA attention + MLP over stacked ``[L, ...]``
  layer weights, the reference's parameter tree leaf for leaf.

Modes: prefill (last-position logits + cache) and decode (one token +
cache).  The other families (MoE, xLSTM/SSM, the Zamba2 hybrid, Whisper
enc-dec) and ``mode="train"`` are later slices of ROADMAP item 15 and
raise ``NotImplementedError`` naming theirs.  The layers run one after
another in Python (the reference scans over them; without a trace to
build, remat and scanning have no counterpart here).

A forward scopes IEEE f32 in cuBLAS itself (``functional.ieee_f32``), as
the lowerings do: its results do not depend on the process's TF32 flags.
A decode cache holds ``{"kv": (K, V), "pos": int}``, K and V
``[L, B, T, Hkv, hd]`` bf16 tensors that decode writes in place.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.functional import ieee_f32
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.mlp import init_mlp, mlp

# the ROADMAP item 15 slice that ports each family not ported yet
_LATER_SLICES = {
    "moe": "the MoE slice",
    "ssm": "the xLSTM/SSM slice",
    "hybrid": "the Zamba2 hybrid slice",
    "encdec": "the Whisper enc-dec slice",
}
def check_family(cfg: ModelConfig) -> None:
    """Raise unless this module runs ``cfg``'s family (the error names the
    slice that will)."""
    if cfg.family not in ("dense", "vlm"):
        later = _LATER_SLICES.get(cfg.family)
        if later is None:
            raise ValueError(cfg.family)
        raise NotImplementedError(f"{cfg.family!r} models are {later} of "
                                  f"ROADMAP item 15")


def _check_mode(cfg: ModelConfig, mode: str) -> None:
    check_family(cfg)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is the LM training slice "
                                  f"of ROADMAP item 15")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _init_dense_layers(cfg: ModelConfig, generator, device) -> dict:
    n, d = cfg.n_layers, cfg.d_model
    return {"norm1": L.ones_init((n, d), device=device),
            "attn": A.init_attention(generator, cfg, device, stack=(n,)),
            "norm2": L.ones_init((n, d), device=device),
            "mlp": init_mlp(generator, cfg, device, stack=(n,))}


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device="cuda") -> dict:
    """The model's parameters drawn from ``generator`` (on the CPU, then
    moved to ``device``; ``device="meta"`` gives shapes without drawing)."""
    check_family(cfg)
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": L.dense_init(generator, (cfg.vocab, d), scale=0.02,
                              device=device),
        "final_norm": L.ones_init((d,), device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (cfg.vocab, d),
                                         scale=0.02, device=device)
    params["layers"] = _init_dense_layers(cfg, generator, device)
    return params


def param_count(values) -> int:
    return sum(v.numel() for v in _tree.leaves(values))


def active_param_count(values, cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    if cfg.family == "moe":
        raise NotImplementedError(f"'moe' models are {_LATER_SLICES['moe']} "
                                  f"of ROADMAP item 15")
    return param_count(values)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _dense_block(lp, h, cfg, cos, sin, kv=None, pos=None):
    a, new_kv = A.attention(
        lp["attn"], L.rmsnorm(h, lp["norm1"], cfg.norm_eps), cfg,
        cos=cos, sin=sin, kv_cache=kv, cache_pos=pos)
    h = h + a
    m = mlp(lp["mlp"], L.rmsnorm(h, lp["norm2"], cfg.norm_eps), cfg)
    return h + m, new_kv


def _rope(cfg: ModelConfig, positions, mrope_positions=None):
    hd = cfg.resolved_head_dim
    if cfg.mrope:
        if mrope_positions is None:
            mrope_positions = positions[None].expand(3, *positions.shape)
        return L.mrope_cos_sin(mrope_positions, hd, cfg.mrope_sections,
                               cfg.rope_theta)
    return L.rope_cos_sin(positions, hd, cfg.rope_theta)


def backbone(params, cfg: ModelConfig, h, *, mode: str, cache=None,
             positions, mrope_positions=None):
    """h [B,S,D] -> (h, new_cache, aux_loss)."""
    _check_mode(cfg, mode)
    cos, sin = _rope(cfg, positions, mrope_positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = params["layers"]
    if mode == "decode":
        pos = int(cache["pos"])
        ks, vs = cache["kv"]
        for i in range(cfg.n_layers):
            lp = _tree.tree_map(lambda v: v[i], layers)
            h, _ = _dense_block(lp, h, cfg, cos, sin, (ks[i], vs[i]), pos)
        return h, {"kv": (ks, vs), "pos": pos + 1}, aux
    kvs = []
    for i in range(cfg.n_layers):
        lp = _tree.tree_map(lambda v: v[i], layers)
        h, kv = _dense_block(lp, h, cfg, cos, sin)
        kvs.append(kv)
    new_cache = {"kv": (torch.stack([k for k, _ in kvs]),
                        torch.stack([v for _, v in kvs])),
                 "pos": h.shape[1]}
    return h, new_cache, aux


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

    batch keys: tokens [B,S]; mrope_positions [3,B,S] (vlm);
    prefix_embeds [B,P,D] (vlm: stands in for the first P tokens).
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

        h, new_cache, _ = backbone(
            params, cfg, h, mode=mode, cache=cache, positions=positions,
            mrope_positions=mrope_positions)
        if mode == "prefill":
            h = h[:, -1:]
        return logits_fn(params, cfg, h), new_cache


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int):
    """Decode cache (zeros) for one new token against a ``max_len``
    context, on the device of ``params``."""
    check_family(cfg)
    kv = A.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                         device=params["embed"].device)
    return {"kv": kv, "pos": max_len - 1}
