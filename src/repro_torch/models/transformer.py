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
unchanged.  Modes: train (the loss, ``chunked_xent`` plus the MoE
load-balance term), prefill (last-position logits + cache) and decode
(one token + cache).  The layers run one after another in Python, where
the reference scans over them.  In train mode ``cfg.remat`` checkpoints
each layer's body where the reference's ``_remat`` does (saving nothing:
the backward runs the layer again), ``cfg.remat_segments`` nests them in
segments whose inputs alone are kept, and the attention's query chunks
and the cross-entropy's token chunks are checkpointed as there; the
values and gradients are those without remat, bit for bit.
``remat_policy="save_outs"`` keeps each block's output after its
out-projection and all-reduce (``layers.blk_out``) instead of
checkpointing the whole layer: the backward runs the block's work again
up to the projection, neither the projection nor its collective.

On a mesh (``sharding.partition.use_mesh``) each rank holds its blocks
of the parameters and its shard of the batch (in a serve step, where
the batch divides the batch axes; one long sequence is whole on every
rank).  FSDP gathers come from ``launch.steps``: the
stacked layers of the dense, VLM and MoE families as an ``FsdpLayers``,
whose layer is gathered where the loop takes it, inside the layer's
remat (so one layer is whole at a time and the backward gathers it
again), every other leaf before the forward.
The embedding is vocab-parallel where the table's rows are sharded
(each rank looks up the ids in its rows, the parts summed over the
``model`` axis), the loss is ``_xent_vocab_parallel`` where the
reference's is (a ``model`` axis whose extent divides the vocab), the
attention, MLP, MoE and recurrent blocks are tensor- and
expert-parallel (``models.attention``, ``mlp``, ``moe``, ``ssm``), and
the token sum is summed over the batch axes before the division by the
global token count.  A serve step on a mesh keeps each rank's block of
the cache in ``cache_logical``'s layout (``models.attention``: head-
parallel, or split-KV over ``kv_seq``, the mesh axes the KV cache's
sequence dim is cut over; ``models.ssm``: the Mamba-2 state's heads),
and its logits are gathered whole over the ``model`` axis where the
table's rows are cut.  A rank's backward takes the gradient of its own
batch shard's part of the loss (``sharding.mesh.reduce_from`` over the
batch axes); the step sums them.

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

import dataclasses
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
from repro_torch.sharding import mesh as _mesh
from repro_torch.sharding.partition import current_mesh

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
MODEL = ("model",)


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is an LM family."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def _check_mode(cfg: ModelConfig, mode: str) -> None:
    check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)


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
    ``device="meta"`` gives shapes without drawing, ``device=L.AXES``
    each leaf's logical axes, the reference's ``split_params(...)[1]``)."""
    check_family(cfg)
    d = cfg.d_model
    vocab = ("model", "fsdp")
    params: dict[str, Any] = {
        "embed": L.dense_init(generator, (cfg.vocab, d), scale=0.02,
                              dtype=dtype, device=device, logical=vocab),
        "final_norm": L.ones_init((d,), dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (cfg.vocab, d),
                                         scale=0.02, dtype=dtype,
                                         device=device, logical=vocab)
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

def _attn_block(p, h, cfg, cos, sin, kv=None, pos=None, layout=None):
    """The attention half of a block: h + attn(norm1(h)), and its kv."""
    a, new_kv = A.attention(
        p["attn"], L.rmsnorm(h, p["norm1"], cfg.norm_eps), cfg,
        cos=cos, sin=sin, kv_cache=kv, cache_pos=pos, kv_layout=layout)
    return h + a, new_kv


def _dense_block(lp, h, cfg, cos, sin, kv=None, pos=None, layout=None):
    h, new_kv = _attn_block(lp, h, cfg, cos, sin, kv, pos, layout)
    m = mlp(lp["mlp"], L.rmsnorm(h, lp["norm2"], cfg.norm_eps), cfg)
    return h + m, new_kv


def _moe_block(lp, h, cfg, cos, sin, kv=None, pos=None, layout=None):
    h, new_kv = _attn_block(lp, h, cfg, cos, sin, kv, pos, layout)
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


class FsdpLayers:
    """A stacked ``[L, ...]`` layer tree of this rank's FSDP blocks and
    ``gather``, which makes one layer's blocks whole (``launch.steps``:
    an all-gather whose backward reduce-scatters)."""

    def __init__(self, tree, gather):
        self.tree, self.gather = tree, gather


def _layer(tree, i):
    """Layer ``i`` of a stacked ``[L, ...]`` tree (of an ``FsdpLayers``,
    gathered whole)."""
    if isinstance(tree, FsdpLayers):
        return tree.gather(_layer(tree.tree, i))
    return _tree.tree_map(lambda v: v[i], tree)


def _stack(trees):
    """Trees of one structure -> one tree of their leaves stacked."""
    return _tree.tree_map(lambda *vs: torch.stack(vs), *trees)


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _remat(fn, cfg: ModelConfig, train: bool):
    """``fn`` checkpointed per call under ``cfg.remat`` in train mode
    (``save_outs``: not as a whole, its blocks' outputs kept by
    ``layers.blk_out``)."""
    if not (train and cfg.remat) or L.saves_outs(cfg):
        return fn
    return lambda *args: L.remat(fn, *args)


def backbone(params, cfg: ModelConfig, h, *, mode: str, cache=None,
             positions, mrope_positions=None, enc_out=None, kv_seq=()):
    """h [B,S,D] -> (h, new_cache, aux_loss).  ``enc_out`` (Whisper's
    encoder output) is read by the prefill and train modes; train mode
    builds no cache (``{}``).  ``kv_seq``: the mesh axes a decode
    cache's KV sequence dim is cut over."""
    _check_mode(cfg, mode)
    # a serve step's cache layout on a mesh (models.attention)
    layout = (A.KvLayout(tuple(kv_seq)) if mode != "train"
              and current_mesh() is not None else None)
    cos, sin = _rope(cfg, positions, mrope_positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    fam = cfg.family
    decode, train = mode == "decode", mode == "train"
    pos = int(cache["pos"]) if decode else None
    new_pos = pos + 1 if decode else h.shape[1]
    layers = params["layers"]

    if fam in ("dense", "vlm", "moe"):
        kvs = cache["kv"] if decode else None

        def block(lp, hh, kv=None):
            """(h, kv, aux term) of one layer."""
            if fam == "moe":
                return _moe_block(lp, hh, cfg, cos, sin, kv, pos, layout)
            return (*_dense_block(lp, hh, cfg, cos, sin, kv, pos, layout),
                    None)

        if train:
            # the layer taken inside its remat: an FSDP layer's gather too
            layer = _remat(lambda i, hh: block(_layer(layers, i), hh), cfg,
                           train)

            def run(lo, hi, hh, aa):
                """Layers lo..hi-1, each remat'ed: (h, aux)."""
                for i in range(lo, hi):
                    hh, _, a = layer(i, hh)
                    if a is not None:
                        aa = aa + a
                return hh, aa

            n, seg = cfg.n_layers, cfg.remat_segments
            if seg and n % seg == 0 and seg < n:
                # nested remat: the residual stream is kept once per
                # segment (seg saves instead of L); the backward runs a
                # segment's forward again, each layer remat'ed inside it
                g = n // seg
                for lo in range(0, n, g):
                    h, aux = L.remat(run, lo, lo + g, h, aux)
            else:
                h, aux = run(0, n, h, aux)
            return h, {}, aux
        out = []
        for i in range(cfg.n_layers):
            kv = (kvs[0][i], kvs[1][i]) if decode else None
            h, kv, a = block(_layer(layers, i), h, kv)
            if a is not None:
                aux = aux + a
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
        if train:
            return h, {}, aux
        return h, {"states": new_states, "pos": new_pos}, aux

    if fam == "hybrid":
        groups, per = cfg.n_layers // cfg.attn_every, cfg.attn_every
        sp = params["shared_attn"]
        shared_cfg = dataclasses.replace(cfg, remat_policy="nothing")
        # train: each Mamba-2 layer remat'ed, the shared block not (as in
        # the reference), no states kept
        mamba = _remat(lambda lp, hh: S.mamba2_train(lp, hh, cfg), cfg,
                       train)
        new_ssm, new_kv = [], []
        for g in range(groups):
            sts = []
            for a in range(per):
                lp = _layer(layers, g * per + a)
                if train:
                    h = mamba(lp, h)
                    continue
                if decode:
                    st = _tree.tree_map(lambda v: v[g, a], cache["ssm"])
                    h, st = S.mamba2_decode(lp, h, cfg, st)
                else:
                    h, st = S.mamba2_block(lp, h, cfg)
                sts.append(st)
            if not train:
                new_ssm.append(_stack(sts))
            # the shared attention block after each group (never remat'ed:
            # its out-projections are not kept apart either)
            kv = (cache["kv"][0][g], cache["kv"][1][g]) if decode else None
            h, kv = _attn_block(sp, h, shared_cfg, cos, sin, kv, pos, layout)
            h = h + mlp(sp["mlp"], L.rmsnorm(h, sp["norm2"], cfg.norm_eps),
                        shared_cfg)
            new_kv.append(kv)
        if train:
            return h, {}, aux
        kvs = cache["kv"] if decode else _stack(new_kv)
        return h, {"ssm": _stack(new_ssm), "kv": kvs, "pos": new_pos}, aux

    # encdec
    kvs, cross = (cache["kv"], cache["cross"]) if decode else (None, None)

    def dec_layer(lp, hh, kv_cache=None, xkv=None):
        """(h, kv, cross kv) of one decoder layer."""
        a, kv = A.attention(
            lp["self_attn"], L.rmsnorm(hh, lp["norm1"], cfg.norm_eps), cfg,
            cos=cos, sin=sin, cache_pos=pos, kv_cache=kv_cache,
            kv_layout=layout)
        hh = hh + a
        if xkv is None:
            xkv = A.cross_kv(lp["cross_attn"], enc_out, cfg,
                             serve=layout is not None)
        c, _ = A.attention(lp["cross_attn"],
                           L.rmsnorm(hh, lp["norm_x"], cfg.norm_eps), cfg,
                           xattn_kv=xkv, kv_layout=layout)
        hh = hh + c
        hh = hh + mlp(lp["mlp"], L.rmsnorm(hh, lp["norm2"], cfg.norm_eps),
                      cfg)
        return hh, kv, xkv

    if train:
        layer = _remat(lambda lp, hh: dec_layer(lp, hh)[0], cfg, train)
        for i in range(cfg.n_layers):
            h = layer(_layer(layers, i), h)
        return h, {}, aux
    out = []
    for i in range(cfg.n_layers):
        h, kv, xkv = dec_layer(
            _layer(layers, i), h,
            *(((kvs[0][i], kvs[1][i]), (cross[0][i], cross[1][i]))
              if decode else ()))
        out.append((kv, xkv))
    if not decode:
        kvs = _stack([kv for kv, _ in out])
        cross = _stack([xkv for _, xkv in out])
    return h, {"kv": kvs, "cross": cross, "pos": new_pos}, aux


def encode(params, cfg: ModelConfig, enc_embeds, train: bool = False):
    """Whisper encoder over stub frame embeddings [B, T, D]: bidirectional
    attention with no rotary, then the final norm; ``train`` remats each
    layer under ``cfg.remat``."""
    def layer(lp, hh):
        a, _ = A.attention(lp["attn"],
                           L.rmsnorm(hh, lp["norm1"], cfg.norm_eps), cfg,
                           causal=False)
        hh = hh + a
        return hh + mlp(lp["mlp"], L.rmsnorm(hh, lp["norm2"], cfg.norm_eps),
                        cfg)

    h = enc_embeds + params["enc_pos"].to(enc_embeds.dtype)[None]
    enc, layer = params["encoder_layers"], _remat(layer, cfg, train)
    for i in range(cfg.n_enc_layers):
        h = layer(_layer(enc, i), h)
    return L.rmsnorm(h, params["enc_final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Heads / losses / entry points
# ---------------------------------------------------------------------------

def logits_fn(params, cfg: ModelConfig, h):
    """The logits of ``h``, over the whole vocab: where the table's rows
    are cut over the ``model`` axis, each rank's columns gathered."""
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    table = params.get("lm_head", params["embed"])
    logits = h @ table.to(h.dtype).T
    if table.shape[0] != cfg.vocab:
        logits = _mesh.gather(logits, current_mesh(), MODEL, -1)
    return logits


def cross_entropy(logits, labels, mask=None):
    """Mean (or ``mask``-weighted mean) token cross-entropy, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask),
                                                    min=1.0)
    return torch.mean(loss)


_XENT_CHUNK = 8192


def _xent_sum(hc, lc, table):
    """Summed cross-entropy of one token chunk ``hc`` [C, D]."""
    logits = (hc @ table.to(hc.dtype).T).float()
    ll = torch.gather(logits, -1, lc.long()[:, None])[:, 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - ll)


def chunked_xent(params, cfg: ModelConfig, h, labels):
    """Training cross-entropy without the whole [T, V] logits at once.
    The final norm, then on a mesh whose ``model`` extent divides the
    vocab ``_xent_vocab_parallel``; otherwise the whole logits when the
    T = B*S tokens are at most ``cfg.xent_chunk`` or not a multiple of
    it, else a loop over chunks of that many tokens, each checkpointed,
    summed in f32 and divided by T (on a mesh: the sum over the batch
    axes, divided by the global T)."""
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    table = params.get("lm_head", params["embed"])
    b, s, d = h.shape
    t = b * s
    hf, lf = h.reshape(t, d), labels.reshape(t)
    chunk = cfg.xent_chunk or _XENT_CHUNK
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names \
            and cfg.vocab % mesh.shape["model"] == 0:
        return _xent_vocab_parallel(mesh, hf, lf, table, chunk)
    if mesh is None and (t % chunk != 0 or t <= chunk):
        return cross_entropy(hf @ table.to(h.dtype).T, lf)
    if t % chunk != 0 or t <= chunk:
        acc = _xent_sum(hf, lf, table)
    else:
        acc = torch.zeros((), dtype=torch.float32, device=h.device)
        for start in range(0, t, chunk):
            sl = slice(start, start + chunk)
            acc = acc + L.remat(_xent_sum, hf[sl], lf[sl], table)
    if mesh is None:
        return acc / t
    batch = mesh.batch_axes
    return (_mesh.reduce_from(acc, mesh, batch)
            / (t * _mesh.axis_size(mesh, batch)))


def _xent_vocab_parallel(mesh, hf, lf, table, chunk):
    """The reference's vocab-parallel cross-entropy (Megatron-style):
    this rank's tokens ``hf`` [T_loc, D] against its rows of the table,
    in chunks of ``chunk`` tokens (each checkpointed), the logsumexp
    distributed over the ``model`` axis (a max of the gradient-free
    per-rank maxima, then a sum), the label logit taken on the one rank
    whose rows hold it; the token sum summed over the batch axes and
    divided by the global token count."""
    batch = mesh.batch_axes
    t_loc, d = hf.shape
    v_loc = table.shape[0]
    v0 = _mesh.axis_index(mesh, MODEL) * v_loc
    hf = _mesh.copy_to(hf, mesh, MODEL)
    tbl = table.to(hf.dtype)
    c = chunk if t_loc % chunk == 0 and t_loc > chunk else t_loc

    def body(hc, lc, tbl):
        logits = (hc @ tbl.T).float()
        mx = _mesh.psum(logits.detach().amax(dim=-1), mesh, MODEL, "max")
        ssum = _mesh.reduce_from(
            torch.sum(torch.exp(logits - mx[:, None]), dim=-1), mesh, MODEL)
        lse = mx + torch.log(ssum)
        mine = (lc >= v0) & (lc < v0 + v_loc)
        idx = torch.clamp(lc.long() - v0, 0, v_loc - 1)
        ll = torch.gather(logits, -1, idx[:, None])[:, 0]
        ll = _mesh.reduce_from(torch.where(mine, ll, 0.0), mesh, MODEL)
        return torch.sum(lse - ll)

    acc = torch.zeros((), dtype=torch.float32, device=hf.device)
    for start in range(0, t_loc, c):
        sl = slice(start, start + c)
        acc = acc + L.remat(body, hf[sl], lf[sl], tbl)
    acc = _mesh.reduce_from(acc, mesh, batch)
    return acc / (t_loc * _mesh.axis_size(mesh, batch))


def embed(params, cfg: ModelConfig, tokens, dtype):
    """The token embeddings in ``dtype``: where the table's rows are
    sharded over the ``model`` axis, each rank's lookup in its rows,
    summed over the axis."""
    table = params["embed"]
    if table.shape[0] == cfg.vocab:
        return L.embed_lookup(table, tokens).to(dtype)
    mesh = current_mesh()
    v0 = _mesh.axis_index(mesh, MODEL) * table.shape[0]
    part = L.vocab_parallel_lookup(table, tokens, v0).to(dtype)
    return _mesh.reduce_from(part, mesh, MODEL)


def forward(params, cfg: ModelConfig, batch: dict, *, mode: str = "train",
            cache=None, param_dtype=torch.bfloat16, kv_seq=()):
    """Unified entry point: ``(loss, {"aux": aux})`` for ``mode`` "train"
    (the mean next-token cross-entropy plus ``router_aux_weight`` times
    the MoE load-balance term per layer), ``(logits, cache)`` for
    "prefill" (the last position's logits) or "decode" (one token against
    ``cache``).  Gradients of the train loss are taken by the caller
    (``launch.steps.lm_grads``, inside ``functional.ieee_f32``).

    batch keys: tokens [B,S]; labels [B,S] (train); enc_embeds [B,T,D]
    (encdec train and prefill; a decode ignores it); mrope_positions
    [3,B,S] (vlm); prefix_embeds [B,P,D] (vlm: stands in for the first P
    tokens).  ``kv_seq``: on a mesh, the axes a decode cache's KV
    sequence dim is cut over (``backbone``).
    """
    _check_mode(cfg, mode)
    with ieee_f32():
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = embed(params, cfg, tokens, param_dtype)

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
        if cfg.family == "encdec" and mode != "decode":
            enc_out = encode(params, cfg,
                             batch["enc_embeds"].to(param_dtype),
                             train=mode == "train")

        h, new_cache, aux = backbone(
            params, cfg, h, mode=mode, cache=cache, positions=positions,
            mrope_positions=mrope_positions, enc_out=enc_out,
            kv_seq=kv_seq)
        if mode == "train":
            loss = chunked_xent(params, cfg, h, batch["labels"])
            loss = loss + cfg.router_aux_weight * aux / max(cfg.n_layers, 1)
            return loss, {"aux": aux}
        if mode == "prefill":
            h = h[:, -1:]
        return logits_fn(params, cfg, h), new_cache


def cache_logical(cfg: ModelConfig, seq_shard: bool = False):
    """The logical axes of ``init_cache``'s tree, the reference's (its
    ``kv_seq_shard`` and ``seq_shard`` branches): a serve step on a mesh
    holds each rank's block of the cache by them
    (``launch.steps.cache_specs``).

    ``seq_shard=True`` (long_500k: one sequence) puts the KV sequence dim
    on the data axis instead of the batch dim; ``cfg.kv_seq_shard`` puts
    it on the model axis where the KV heads cannot shard (MQA/GQA heads
    fewer than the axis)."""
    check_family(cfg)
    seq = "seq" if seq_shard else None
    bat = None if seq_shard else "batch"
    if cfg.kv_seq_shard and not seq_shard:
        kv = (None, bat, "model", None, None)
    else:
        kv = (None, bat, seq, "model", None)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return {"kv": (kv, kv), "pos": ()}
    if fam == "ssm":
        return {"states": [
            (("batch", None),) * 3 if _is_slstm(cfg, i)
            else (("batch", None, None, None), ("batch", None, "model"))
            for i in range(cfg.n_layers)], "pos": ()}
    if fam == "hybrid":
        return {"ssm": ((None, None, "batch", "model", None, None),
                        (None, None, "batch", None, None)),
                "kv": (kv, kv), "pos": ()}
    cross = (None, "batch", None, "model", None)
    return {"kv": (kv, kv), "cross": (cross, cross), "pos": ()}


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               device=None):
    """Decode cache (zeros) for one new token against a ``max_len``
    context, on ``device`` (default: the device of ``params``;
    ``"meta"``: shapes only)."""
    check_family(cfg)
    dev = device if device is not None else params["embed"].device
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
