"""The port's LM serving slice against the JAX package on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
``repro_torch`` at ``reduced()`` sizes: the layers (norms, activations,
rotary and M-RoPE), the MLP, attention (prefill, chunked prefill, decode
against a bf16 cache, GQA and MQA, cross-attention) and
``transformer.forward`` of all ten configs (dense, VLM, MoE, xLSTM, the
Zamba2 hybrid, Whisper enc-dec), whose parameters are drawn once in
numpy and carried to both packages (the port's through
``convert.params_from_numpy``).  Tolerances are relative to max |y|:
1e-5 for f32, 1e-3 for a decode that reads the bf16 cache (its rounding
ties), 1e-2 for the bf16 serve steps.

The JAX bf16 steps are compiled with ``xla_allow_excess_precision`` off,
so that every op rounds to bf16 where the program says it does.  By
default XLA's CPU compile drops some of those roundings inside its
fusions (the keys' rotation reaches the scores in f32), and its logits
then read 1.1e-2 to 1.4e-2 of max |logit| from the port's at these sizes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL as JAX_ALL  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from jax_lm_helpers import exact_jit, numpy_params  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ALL, ASSIGNED, get_config  # noqa: E402
from repro_torch.convert import WeightShapeError, params_from_numpy  # noqa
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.serve_loop import splice  # noqa: E402

ARCHS = ["llama3_2_1b", "stablelm_1_6b", "minitron_8b", "granite_20b",
         "qwen2_vl_2b", "arctic_480b", "dbrx_132b", "xlstm_350m",
         "zamba2_2_7b", "whisper_tiny"]
assert sorted(ARCHS) == sorted(ASSIGNED)
B, S, MAX_LEN = 2, 8, 16


def rel_err(got, want) -> float:
    """max |got - want| / max |want|; either a tensor or an array."""
    got = (got.float().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float32)).astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def np_bf16(x: torch.Tensor) -> np.ndarray:
    return np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_config_fields_match_the_reference(arch):
    """Every field of every config, reduced or not, is the reference's
    (``dcnn_method`` aside: the port's engine runs ``pallas``; and the
    reference's ``dcnn_spatial_shard``, which the port does not carry,
    since nothing in it reads the field)."""
    assert ALL == JAX_ALL
    for red in (False, True):
        got, want = get_config(arch), jax_config(arch)
        if red:
            got, want = got.reduced(), want.reduced()
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert g.pop("dcnn_method") == "pallas"
        w.pop("dcnn_method")
        assert "dcnn_spatial_shard" not in g
        w.pop("dcnn_spatial_shard")
        assert g == w
        assert got.resolved_head_dim == want.resolved_head_dim


def test_aliases_and_shapes():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import _ALIASES as JALIASES
    from repro.configs import shape_applicable as jsa
    from repro_torch.configs import SHAPES, shape_applicable
    for alias, name in JALIASES.items():
        assert get_config(alias).name == jax_config(alias).name, alias
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ALL:
        for shape in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[shape])[0] == \
                jsa(jax_config(arch), JSHAPES[shape])[0]
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("gpt-5")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer_case(name, rng):
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    pos = rng.randint(0, 300, (2, 5))
    if name == "rmsnorm":
        return (L.rmsnorm(t(x), t(g), 1e-5),
                JL.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    if name == "rmsnorm_bf16":
        xb = t(x, torch.bfloat16)
        got = L.rmsnorm(xb, t(g), 1e-6)
        assert got.dtype == torch.bfloat16
        return got, JL.rmsnorm(jnp.asarray(np_bf16(xb)), jnp.asarray(g), 1e-6)
    if name == "layernorm":
        return (L.layernorm(t(x), t(g), t(bias)),
                JL.layernorm(jnp.asarray(x), jnp.asarray(g),
                             jnp.asarray(bias)))
    if name.startswith("act_"):
        act = name[4:]
        xs = 3 * x
        return L.activation(act)(t(xs)), JL.activation(act)(jnp.asarray(xs))
    if name == "rope":
        c, s = L.rope_cos_sin(t(pos), 32, 5e5)
        jc, js = JL.rope_cos_sin(jnp.asarray(pos), 32, 5e5)
        assert rel_err(c, jc) <= 1e-5 and rel_err(s, js) <= 1e-5
        return (L.apply_rope(t(x), c, s),
                JL.apply_rope(jnp.asarray(x), jc, js))
    if name == "mrope":
        p3 = rng.randint(0, 300, (3, 2, 5))
        c, s = L.mrope_cos_sin(t(p3), 32, (4, 6, 6), 1e6)
        jc, js = JL.mrope_cos_sin(jnp.asarray(p3), 32, (4, 6, 6), 1e6)
        assert rel_err(s, js) <= 1e-5
        return c, jc
    if name == "embed":
        table = rng.standard_normal((50, 16)).astype(np.float32)
        ids = rng.randint(0, 50, (3, 7))
        return (L.embed_lookup(t(table), t(ids)),
                JL.embed_lookup(jnp.asarray(table), jnp.asarray(ids)))
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "rmsnorm", "rmsnorm_bf16", "layernorm", "act_silu", "act_gelu",
    "act_relu2", "rope", "mrope", "embed"])
def test_layer_matches_jax(name):
    got, want = _layer_case(name, np.random.RandomState(1))
    tol = 1e-2 if name.endswith("bf16") else 1e-5
    assert rel_err(got, np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_bf16_activations_round_as_the_reference(name):
    """In bf16 each elementwise op of the reference's activation rounds
    to bf16 (XLA's CPU fusions convert after every op): the port's are
    bit for bit the same."""
    x = torch.from_numpy(
        3 * np.random.RandomState(7).standard_normal((64, 64))).bfloat16()
    want = jax.jit(JL.activation(name))(jnp.asarray(np_bf16(x)))
    got = L.activation(name)(x)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want, np.float32))


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    got = L.activation("gelu")(x)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True))
    assert rel_err(got, want) <= 1e-6
    assert float((got - exact).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# MLP and attention
# ---------------------------------------------------------------------------

def _draw(rng, shape, scale):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "granite_20b",
                                  "minitron_8b"])
def test_mlp_matches_jax(arch):
    """Gated silu (llama), plain tanh-gelu (granite), plain relu2
    (minitron)."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    rng = np.random.RandomState(2)
    d, f = cfg.d_model, cfg.d_ff
    w_in, w_out = _draw(rng, (d, f), d ** -0.5), _draw(rng, (f, d), f ** -0.5)
    w_gate = _draw(rng, (d, f), d ** -0.5) if cfg.gated_mlp else None
    x = _draw(rng, (2, 6, d), 1.0)
    got = M.mlp(M.MlpParams(t(w_in), None if w_gate is None else t(w_gate),
                            t(w_out)), t(x), cfg)
    want = JM.mlp(JM.MlpParams(jnp.asarray(w_in),
                               None if w_gate is None else
                               jnp.asarray(w_gate), jnp.asarray(w_out)),
                  jnp.asarray(x), jcfg)
    assert rel_err(got, want) <= 1e-5


def _attn_params(cfg, rng):
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    return [_draw(rng, (d, hq, hd), d ** -0.5),
            _draw(rng, (d, hkv, hd), d ** -0.5),
            _draw(rng, (d, hkv, hd), d ** -0.5),
            _draw(rng, (hq, hd, d), (hq * hd) ** -0.5)]


ATTN_CASES = {
    # name: (arch, sequence length, mode)
    "gqa_prefill": ("llama3_2_1b", 16, "prefill"),
    "mqa_prefill": ("granite_20b", 16, "prefill"),
    "chunked_prefill": ("llama3_2_1b", 1024, "prefill"),
    "irregular_prefill": ("llama3_2_1b", 520, "prefill"),
    "gqa_decode": ("llama3_2_1b", 1, "decode"),
    "mqa_decode": ("granite_20b", 1, "decode"),
    "cross": ("llama3_2_1b", 6, "cross"),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(case):
    arch, s, mode = ATTN_CASES[case]
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    rng = np.random.RandomState(3)
    ws = _attn_params(cfg, rng)
    p = A.AttnParams(*map(t, ws))
    jp = JA.AttnParams(*map(jnp.asarray, ws))
    x = _draw(rng, (2, s, cfg.d_model), 1.0)
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    if mode == "cross":
        kv = [_draw(rng, (2, 9, hkv, hd), 1.0) for _ in range(2)]
        got, gc = A.attention(p, t(x), cfg, xattn_kv=tuple(map(t, kv)))
        want, wc = JA.attention(jp, jnp.asarray(x), jcfg,
                                xattn_kv=tuple(map(jnp.asarray, kv)))
        assert gc is None and wc is None
        assert rel_err(got, want) <= 1e-5
        return
    pos0 = 10 if mode == "decode" else 0
    positions = np.broadcast_to(np.arange(pos0, pos0 + s), (2, s))
    cos, sin = L.rope_cos_sin(t(positions), hd, cfg.rope_theta)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(positions), hd, jcfg.rope_theta)
    if mode == "prefill":
        got, (gk, gv) = A.attention(p, t(x), cfg, cos=cos, sin=sin)
        want, (wk, wv) = JA.attention(jp, jnp.asarray(x), jcfg, cos=jcos,
                                      sin=jsin)
        assert rel_err(gk, wk) <= 1e-5 and rel_err(gv, wv) <= 1e-5
        assert rel_err(got, want) <= 1e-5
        return
    # decode: a bf16 cache of 24 positions, filled up to pos0
    cache = [torch.zeros(2, 24, hkv, hd, dtype=torch.bfloat16)
             for _ in range(2)]
    for c in cache:
        c[:, :pos0] = t(_draw(rng, (2, pos0, hkv, hd), 1.0), torch.bfloat16)
    jcache = tuple(jnp.asarray(np_bf16(c)) for c in cache)
    got, (gk, gv) = A.attention(p, t(x), cfg, cos=cos, sin=sin,
                                kv_cache=tuple(cache), cache_pos=pos0)
    want, (wk, wv) = JA.attention(jp, jnp.asarray(x), jcfg, cos=jcos,
                                  sin=jsin, kv_cache=jcache,
                                  cache_pos=jnp.asarray(pos0, jnp.int32))
    assert gk is cache[0] and gv is cache[1]        # written in place
    assert rel_err(gk, np.asarray(wk, np.float32)) <= 1e-2
    assert rel_err(got, want) <= 1e-3


def test_softmax_attend_rounds_probs_to_the_cache_dtype():
    """probs cast to v's dtype, their product summed in f32 and cast
    back: bit for bit the JAX function's on a bf16 v."""
    rng = np.random.RandomState(4)
    q = _draw(rng, (1, 1, 2, 2, 16), 1.0)
    k = _draw(rng, (1, 12, 2, 16), 1.0)
    v = torch.from_numpy(_draw(rng, (1, 12, 2, 16), 1.0)).bfloat16()
    got = A._softmax_attend(t(q), t(k), v, None)
    want = JA._softmax_attend(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(np_bf16(v)), None)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# The transformer, prefill and decode, on carried-over parameters
# ---------------------------------------------------------------------------

class _Model:
    """One arch at reduced size: the carried-over parameters in both
    packages and the JAX forward jitted once per mode and dtype."""

    def __init__(self, arch):
        self.cfg = get_config(arch).reduced()
        self.jcfg = jax_config(arch).reduced()
        tree_np = numpy_params(self.jcfg, seed=5)
        self.params = params_from_numpy(tree_np, "cpu", cfg=self.cfg)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, tree_np)
        jcfg = self.jcfg
        self.jprefill = {
            dt: exact_jit(lambda p, b, dt=dt: JT.forward(
                p, jcfg, b, mode="prefill", param_dtype=dt))
            for dt in (jnp.float32, jnp.bfloat16)}
        self.jdecode = {
            dt: exact_jit(lambda p, c, b, dt=dt: JT.forward(
                p, jcfg, b, mode="decode", cache=c, param_dtype=dt))
            for dt in (jnp.float32, jnp.bfloat16)}

    def batch(self, rng):
        cfg = self.cfg
        toks = rng.randint(0, cfg.vocab, (B, S))
        b = {"tokens": toks}
        if cfg.mrope:       # three distinct streams, and an image prefix
            ar = np.arange(S)
            b["mrope_positions"] = np.broadcast_to(
                np.stack([ar, ar // 2, ar % 3])[:, None], (3, B, S)).copy()
            b["prefix_embeds"] = _draw(rng, (B, 3, cfg.d_model), 0.02)
        if cfg.family == "encdec":      # the stub frontend's frames
            b["enc_embeds"] = _draw(rng, (B, cfg.enc_seq, cfg.d_model), 1.0)
        return b

    def decode_batch(self, tok, rng=None):
        """A decode call's batch of token ``tok`` (numpy)."""
        b = {"tokens": np.full((B, 1), tok)}
        if self.cfg.mrope:
            b["mrope_positions"] = np.zeros((3, B, 1), np.int64)
        if self.cfg.family == "encdec":   # read by the reference only
            b["enc_embeds"] = (np.zeros if rng is None else
                               lambda sh: _draw(rng, sh, 1.0))(
                (B, self.cfg.enc_seq, self.cfg.d_model)).astype(np.float32)
        return b


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Model(arch)
        return cache[arch]
    return get


def _to_torch(batch):
    return {k: t(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def _splice_jax(cache, pc, s):
    # the reference server's splice reads nothing of its server
    return jserve.Server._splice(None, cache, pc, s)


def _cache_from_jax(node):
    """A JAX decode cache (dicts, lists, tuples of arrays) as the port's:
    tensors of the same dtypes, ``pos`` an int."""
    if isinstance(node, dict):
        return {k: (int(v) if k == "pos" else _cache_from_jax(v))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_cache_from_jax(v) for v in node)
    dt = torch.bfloat16 if node.dtype == jnp.bfloat16 else None
    return t(np.asarray(node, np.float32), dt)


def _cache_leaves(cache):
    return tree.leaves({k: v for k, v in cache.items() if k != "pos"})


@pytest.mark.parametrize("mode", ["prefill", "decode", "serve_bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch, mode):
    """Prefill logits at 1e-5 of max |logit|; two decode steps against
    the spliced decode cache (bf16 kv; the recurrent states and Whisper's
    cross keys and values the f32 prefill's) at 1e-3; the bf16 serve
    steps' logits at 1e-2 and their greedy tokens those logits' argmax
    (the JAX tokens wherever its top-2 margin exceeds the tolerance).
    Every cache leaf within 1e-2 of the reference's."""
    m = models(arch)
    rng = np.random.RandomState(6)
    batch = m.batch(rng)
    bf16 = mode == "serve_bf16"
    pdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    tol = 1e-2 if bf16 else 1e-5
    logits, pc = T.forward(m.params, m.cfg, _to_torch(batch),
                           mode="prefill", param_dtype=pdt)
    jlogits, jpc = m.jprefill[jdt](m.jparams, _to_jax(batch))
    assert logits.shape == (B, 1, m.cfg.vocab) and pc["pos"] == S
    # the prefill cache: kv and cross in the activations' dtype, the
    # recurrent states f32, as the reference's
    for got, want in zip(_cache_leaves(pc), _cache_leaves(jpc)):
        assert str(got.dtype)[6:] == str(want.dtype)
    assert "kv" not in pc or pc["kv"][0].dtype == pdt
    assert rel_err(logits, jlogits) <= tol
    if mode == "prefill":
        return
    cache = splice(T.init_cache(m.params, m.cfg, B, MAX_LEN), pc, S)
    jcache = _splice_jax(JT.init_cache(m.jparams, m.jcfg, B, MAX_LEN),
                         jpc, S)
    for got, small in zip(cache.get("kv", ()), pc.get("kv", ())):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got[:, :, :S], small.to(torch.bfloat16))
        assert not got[:, :, S:].any()
    for key in ("states", "ssm", "cross"):          # handed over as they are
        if key in pc:
            assert cache[key] is pc[key]
    # one bf16 step apart where the f32 prefill values straddle a
    # rounding boundary
    for got, want in zip(_cache_leaves(cache), _cache_leaves(jcache)):
        assert rel_err(got, np.asarray(want, np.float32)) <= 1e-2
    tol = 1e-2 if bf16 else 1e-3
    for step, tok in enumerate((7, 3)):
        dbatch = m.decode_batch(tok)
        # the same inputs: the JAX cache as it stands
        cache = _cache_from_jax(jcache)
        logits, cache = T.forward(m.params, m.cfg, _to_torch(dbatch),
                                  mode="decode", cache=cache,
                                  param_dtype=pdt)
        jlogits, jcache = m.jdecode[jdt](m.jparams, jcache, _to_jax(dbatch))
        assert cache["pos"] == int(jcache["pos"]) == S + step + 1
        assert rel_err(logits, jlogits) <= tol, step
        for got, want in zip(_cache_leaves(cache), _cache_leaves(jcache)):
            assert rel_err(got, np.asarray(want, np.float32)) <= 1e-2
    if bf16:
        prefill = ST.make_serve_step(m.cfg, "prefill")
        tok, pc = prefill(m.params, _to_torch(batch))
        want, _ = T.forward(m.params, m.cfg, _to_torch(batch),
                            mode="prefill", param_dtype=torch.bfloat16)
        assert torch.equal(tok, torch.argmax(want[:, -1], dim=-1))
        jtok, _ = exact_jit(JST.make_serve_step(m.jcfg, "prefill"))(
            m.jparams, _to_jax(batch))
        jl, _ = m.jprefill[jnp.bfloat16](m.jparams, _to_jax(batch))
        jl = np.asarray(jl[:, -1], np.float32)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-2 * np.abs(jl).max()
        assert (tok.numpy()[clear] == np.asarray(jtok)[clear]).all()
        decode = ST.make_serve_step(m.cfg, "decode")
        cache = splice(T.init_cache(m.params, m.cfg, B, MAX_LEN), pc, S)
        dbatch = {k: v for k, v in _to_torch(m.decode_batch(0)).items()
                  if k != "tokens"}
        tok2, cache = decode(m.params, cache, {"tokens": tok[:, None],
                                               **dbatch})
        assert tok2.shape == (B,) and cache["pos"] == S + 1


def test_whisper_decode_ignores_enc_embeds(models):
    """The reference re-encodes ``enc_embeds`` on every decode call and
    never reads the result: its decode logits are the same for any
    frames, and the port's (which encodes at prefill only and takes no
    frames in decode) equal them."""
    m = models("whisper_tiny")
    rng = np.random.RandomState(8)
    _, jpc = m.jprefill[jnp.float32](m.jparams, _to_jax(m.batch(rng)))
    jcache = _splice_jax(JT.init_cache(m.jparams, m.jcfg, B, MAX_LEN),
                         jpc, S)
    cache = _cache_from_jax(jcache)
    outs = [np.asarray(m.jdecode[jnp.float32](
        m.jparams, jcache, _to_jax(m.decode_batch(5, r)))[0])
        for r in (None, rng)]
    assert np.array_equal(outs[0], outs[1])
    got, _ = T.forward(m.params, m.cfg, {"tokens": torch.full((B, 1), 5)},
                       mode="decode", cache=cache,
                       param_dtype=torch.float32)
    assert rel_err(got, outs[0]) <= 1e-3


def test_decode_matches_prefill_continuation(models):
    """The reference's KV-cache check on the port: decoding one token
    from a spliced cache equals a prefill over the extended sequence, at
    the reference test's tolerance (the cache is bf16)."""
    m = models("llama3_2_1b")
    toks = torch.arange(2 * 8).reshape(2, 8) % m.cfg.vocab
    ext = torch.cat([toks, torch.full((2, 1), 7)], dim=1)
    full, _ = T.forward(m.params, m.cfg, {"tokens": ext}, mode="prefill",
                        param_dtype=torch.float32)
    _, pc = T.forward(m.params, m.cfg, {"tokens": toks}, mode="prefill",
                      param_dtype=torch.float32)
    cache = splice(T.init_cache(m.params, m.cfg, 2, 16), pc, 8)
    dec, _ = T.forward(m.params, m.cfg, {"tokens": torch.full((2, 1), 7)},
                       mode="decode", cache=cache, param_dtype=torch.float32)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-2,
                               atol=5e-3)


def test_init_cache_and_write_clamp_as_the_reference():
    """``init_cache`` sets pos = max_len - 1; a write past the cache's
    end lands on its last slot, as ``dynamic_update_slice`` clamps."""
    cfg = get_config("llama3_2_1b").reduced()
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = T.init_cache(params, cfg, 1, 6)
    assert cache["pos"] == 5 and cache["kv"][0].shape == (
        cfg.n_layers, 1, 6, cfg.n_kv_heads, cfg.resolved_head_dim)
    c = torch.zeros(1, 4, 1, 2)
    A._write(c, torch.ones(1, 1, 1, 2), 9)
    assert c[0, :, 0, 0].tolist() == [0, 0, 0, 1]
    jc = jax.lax.dynamic_update_slice_in_dim(
        jnp.zeros((1, 4, 1, 2)), jnp.ones((1, 1, 1, 2)), 9, axis=1)
    assert np.array_equal(np.asarray(jc), c.numpy())


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

FULL_PARAMS = {"llama3_2_1b": 1_235_814_400, "qwen2_vl_2b": 1_543_656_960,
               "xlstm_350m": 534_587_560, "zamba2_2_7b": 2_422_110_368,
               "whisper_tiny": 37_015_680,
               "dbrx_132b": 131_596_523_520, "arctic_480b": 476_850_275_328}
# the MoE models as the card serves them, at full width and cut depth:
# (layers, parameters)
CUT_PARAMS = {"dbrx_132b": (2, 7_751_301_120),
              "arctic_480b": (1, 14_069_945_344)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_abstract_params(arch):
    """At full width on the meta device: the port's tree is the JAX
    ``abstract_params`` leaf for leaf (order, shapes, NamedTuple types
    by field names), and so its ``param_count`` and
    ``active_param_count``."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    shapes, _ = JST.abstract_params(jcfg)
    want = [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
    params = ST.real_params(cfg, None, "meta")
    assert [tuple(p.shape) for p in tree.leaves(params)] == want
    named = [type(n).__name__ for n in tree.leaves(
        params, is_leaf=lambda x: hasattr(x, "_fields"))
        if hasattr(n, "_fields")]
    jnamed = [type(n).__name__ for n in jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda x: hasattr(x, "_fields"))
        if hasattr(n, "_fields")]
    assert named == jnamed
    n = int(sum(np.prod(s) for s in want))
    assert T.param_count(params) == n == FULL_PARAMS.get(arch, n)
    active = T.active_param_count(params, cfg)
    assert active == JT.active_param_count(shapes, jcfg)
    assert (active < n) == (cfg.family == "moe")
    assert all(p.dtype == getattr(torch, cfg.master_dtype)
               for p in tree.leaves(params))
    if arch in CUT_PARAMS:
        layers, count = CUT_PARAMS[arch]
        cut = dataclasses.replace(cfg, n_layers=layers)
        assert T.param_count(ST.real_params(cut, None, "meta")) == count


def test_params_from_numpy_checks_the_lm_tree():
    cfg = get_config("granite_20b").reduced()
    tree_np = numpy_params(jax_config("granite_20b").reduced(), 0)
    params = params_from_numpy(tree_np, "cpu", cfg=cfg)
    assert params["layers"]["mlp"].w_gate is None       # plain MLP
    assert isinstance(params["layers"]["attn"], A.AttnParams)
    with pytest.raises(WeightShapeError, match="do not match"):
        params_from_numpy(tree_np, "cpu",
                          cfg=get_config("llama3_2_1b").reduced())


def test_train_mode_gives_the_loss(models):
    """Train mode gives the loss, the JAX package's on the same
    parameters and batch, and the MoE term (0 for a dense model), under
    either remat policy (``save_outs`` keeps the blocks' outputs, the
    loss the same)."""
    m = models("llama3_2_1b")
    toks = np.random.RandomState(3).randint(0, m.cfg.vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, metrics = T.forward(m.params, m.cfg, _to_torch(batch),
                              param_dtype=torch.float32)
    jloss, _ = jax.jit(lambda p, b: JT.forward(
        p, m.jcfg, b, mode="train", param_dtype=jnp.float32))(
        m.jparams, _to_jax(batch))
    assert loss.shape == () and float(metrics["aux"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    cfg = dataclasses.replace(m.cfg, remat_policy="save_outs")
    saved, _ = T.forward(m.params, cfg, _to_torch(batch),
                         param_dtype=torch.float32)
    assert float(saved) == float(loss)


def test_argmax_ties_take_the_first_index():
    x = np.array([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    assert torch.argmax(t(x), dim=-1).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)).tolist() == [1, 0]
