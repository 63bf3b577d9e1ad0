"""The port's MoE and recurrent blocks against the JAX package on the CPU.

The same numpy inputs and weights go through ``repro.models.moe`` /
``repro.models.ssm`` and their counterparts in ``repro_torch``: the
capacity dispatch (its ``keep`` and ``dest`` when tokens drop), the
expert products and the fixed-order combine at ``top_k`` 2 and 4, the
aux loss, top-k and sort ties; the chunkwise GLA engine against the
reference's and against the per-step oracle, at chunks that do and do
not divide the sequence, its state carried across calls, one step; the
causal conv as a block and in decode; the mLSTM, sLSTM and Mamba-2
blocks and decodes in f32 and bf16; and the reference's own
prefill/decode consistency cases (``tests/test_moe_ssm.py``) on the port.
Tolerances are relative to max |y|: 1e-5 in f32 (the GLA engine 1e-5
against the reference, 1e-4 against the oracle, the oracle's own), 1e-2
in bf16.  The JAX functions run jitted (bf16 without excess precision).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jax_lm_helpers import exact_jit, numpy_params  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402


def _f64(a):
    return (a.float().numpy() if torch.is_tensor(a)
            else np.asarray(a, np.float32)).astype(np.float64)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|; tensors or arrays."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def to_jax(a, dtype=None):
    """A numpy array or a tensor as a JAX array (bf16 exactly)."""
    if torch.is_tensor(a):
        dt = jnp.bfloat16 if a.dtype == torch.bfloat16 else None
        return jnp.asarray(a.float().numpy(), dt)
    return jnp.asarray(a, dtype)


def _moe_cfgs(**kw):
    """The dbrx config reduced (4 experts, top_k 2), in both packages,
    with ``kw`` replaced."""
    return (dataclasses.replace(get_config("dbrx_132b").reduced(), **kw),
            dataclasses.replace(jax_config("dbrx_132b").reduced(), **kw))


def _moe_weights(cfg, rng):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in
            (((d, e), d ** -0.5), ((e, d, f), d ** -0.5),
             ((e, d, f), d ** -0.5), ((e, f, d), f ** -0.5))]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    # name: (config changes, tokens [B, S], dtype)
    "top2": ({}, (2, 8), "float32"),
    "top4": ({"n_experts": 8, "top_k": 4}, (2, 8), "float32"),
    "top4_bf16": ({"n_experts": 8, "top_k": 4}, (2, 8), "bfloat16"),
    "drops": ({"capacity_factor": 0.25}, (4, 128), "float32"),
    "arctic_gelu_plain": ({"gated_mlp": False, "mlp_activation": "gelu"},
                          (2, 8), "float32"),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_jax(case):
    """``moe`` and its aux loss against the reference's; with
    ``capacity_factor`` 0.25 tokens drop (an expert takes 128 of ~256
    pairs), and the dispatch's ``keep`` and ``dest`` are the reference's
    (its sort and searchsorted, spelled out here)."""
    kw, (b, s), dtype = MOE_CASES[case]
    cfg, jcfg = _moe_cfgs(**kw)
    rng = np.random.RandomState(11)
    ws = _moe_weights(cfg, rng)
    if not cfg.gated_mlp:
        ws[2] = None
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = t(x, tdt)
    p = MOE.MoeParams(*(None if w is None else t(w) for w in ws))
    jp = JMOE.MoeParams(*(None if w is None else jnp.asarray(w) for w in ws))
    got, aux = MOE.moe(p, xt, cfg)
    want, jaux = exact_jit(lambda p_, x_: JMOE.moe(p_, x_, jcfg))(
        jp, to_jax(xt))
    assert got.dtype == tdt
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    assert rel_err(got, want) <= tol
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))

    # the dispatch, as the reference computes it
    t_, k, e = b * s, cfg.top_k, cfg.n_experts
    c = MOE.capacity(t_, cfg)
    assert c == JMOE.capacity(t_, jcfg)
    _, top_p, top_e = MOE.route(xt.reshape(t_, -1), p.w_router, k)
    jprobs = jax.nn.softmax(to_jax(xt).reshape(t_, -1).astype(jnp.float32)
                            @ jp.w_router, axis=-1)
    jtop_p, jtop_e = jax.lax.top_k(jprobs, k)
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e))
    flat_e = jtop_e.reshape(-1)
    sort_idx = jnp.argsort(flat_e)
    sorted_e = flat_e[sort_idx]
    rank = jnp.arange(t_ * k) - jnp.searchsorted(sorted_e,
                                                 jnp.arange(e))[sorted_e]
    jkeep = rank < c
    jdest = jnp.where(jkeep, sorted_e * c + rank, e * c)
    idx, keep, dest = MOE.dispatch(top_e, e, c)
    assert np.array_equal(idx.numpy(), np.asarray(sort_idx))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(dest.numpy(), np.asarray(jdest))
    assert bool(keep.all()) == (case != "drops")


def test_moe_combine_is_ordered_and_repeatable():
    """The combine adds each token's ``top_k`` rows in ascending expert
    id, one after another in bf16, as the reference's ``segment_sum``:
    at ``top_k`` 4 it is bit for bit the reference's sum of the same
    rows, and summing them in another order rounds elsewhere."""
    t_, k, e, d = 64, 4, 8, 32
    rng = np.random.RandomState(12)
    top_e = torch.from_numpy(np.stack([rng.permutation(e)[:k]
                                       for _ in range(t_)]))
    sort_idx, _, _ = MOE.dispatch(top_e, e, 128)
    weighted = t(rng.standard_normal((t_ * k, d)), torch.bfloat16)
    got = MOE.combine(weighted, sort_idx, k)
    want = jax.jit(jax.ops.segment_sum, static_argnums=2)(
        to_jax(weighted), jnp.asarray(sort_idx.numpy() // k), t_)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert torch.equal(got, MOE.combine(weighted, sort_idx, k))
    rows = weighted.reshape(t_, k, d)
    fwd, rev = rows[:, 0], rows[:, 3]
    for j in range(1, k):
        fwd, rev = fwd + rows[:, j], rev + rows[:, 3 - j]
    assert not torch.equal(fwd, rev)


def test_top_k_and_sort_ties_take_the_lower_index():
    """Tied router probabilities go to the lower expert index, as
    ``lax.top_k`` gives them; the pairs' sort is stable, as
    ``jnp.argsort``."""
    cfg, _ = _moe_cfgs(n_experts=6, top_k=2)
    col = np.random.RandomState(3).standard_normal((cfg.d_model, 1))
    w = np.concatenate([col * 0.5, col, col, col * 0.5, col, col * 0.2],
                       axis=1).astype(np.float32)
    xf = np.abs(np.random.RandomState(4).standard_normal((5, cfg.d_model)))
    xf = (xf * np.sign(col[:, 0])).astype(np.float32)     # x . col > 0
    probs, _, top_e = MOE.route(t(xf), t(w), 2)
    jtop = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    assert (probs[:, 1] == probs[:, 2]).all()               # tied
    assert top_e.tolist() == np.asarray(jtop).tolist() == [[1, 2]] * 5
    flat = torch.tensor([3, 1, 3, 0, 1, 3, 0, 1])
    idx, _, _ = MOE.dispatch(flat.reshape(4, 2), 4, 128)
    assert idx.tolist() == np.asarray(jnp.argsort(
        jnp.asarray(flat.numpy()))).tolist() == [3, 6, 1, 4, 7, 0, 2, 5]


def test_capacity_and_dispatch_entry_point():
    for arch in ("dbrx_132b", "arctic_480b"):
        for n in (1, 8, 16, 128, 1000, 4096):
            for red in (False, True):
                cfg, jcfg = get_config(arch), jax_config(arch)
                if red:
                    cfg, jcfg = cfg.reduced(), jcfg.reduced()
                assert MOE.capacity(n, cfg) == JMOE.capacity(n, jcfg)
    cfg, _ = _moe_cfgs()
    rng = np.random.RandomState(5)
    p = MOE.MoeParams(*map(t, _moe_weights(cfg, rng)))
    x = t(rng.standard_normal((1, 4, cfg.d_model)).astype(np.float32))
    for impl in ("dense_scatter", "shardmap"):
        got, _ = MOE.moe_dispatch(p, x, dataclasses.replace(
            cfg, moe_impl=impl))
        assert torch.equal(got, MOE.moe(p, x, cfg)[0])


def test_every_expert_runs_on_its_whole_capacity_buffer(monkeypatch):
    """Kept from the reference: the expert products run over the dense
    ``[E, C, D]`` buffer, empty rows included, whatever the routing."""
    cfg, _ = _moe_cfgs(n_experts=8, top_k=2)
    rng = np.random.RandomState(6)
    p = MOE.MoeParams(*map(t, _moe_weights(cfg, rng)))
    x = t(rng.standard_normal((1, 3, cfg.d_model)).astype(np.float32))
    shapes, real = [], torch.bmm

    def bmm(a, b):
        shapes.append(tuple(a.shape))
        return real(a, b)
    monkeypatch.setattr(torch, "bmm", bmm)
    MOE.moe(p, x, cfg)
    c = MOE.capacity(3, cfg)
    assert c == 6                    # 3 tokens x top 2: at most 6 rows
    assert shapes == [(8, c, cfg.d_model)] * 2 + [(8, c, cfg.d_ff)]


# ---------------------------------------------------------------------------
# The GLA engine and the causal conv
# ---------------------------------------------------------------------------

def _gla_inputs(rng, b=2, s=24, h=3, dk=8, dv=5):
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    ld = -np.abs(rng.rand(b, s, h)).astype(np.float32)
    return q, k, v, ld


@pytest.mark.parametrize("chunk", [4, 8, 16, 5, 7])
def test_gla_chunked_matches_jax_and_the_recurrence(chunk):
    """At chunks that divide S = 24 and that do not (16, 5, 7: the
    sequence is padded and cropped)."""
    arrs = _gla_inputs(np.random.RandomState(chunk))
    y, st = S.gla_chunked(*map(t, arrs), chunk)
    jy, jst = jax.jit(JS.gla_chunked, static_argnums=4)(
        *map(jnp.asarray, arrs), chunk)
    assert rel_err(y, jy) <= 1e-5 and rel_err(st, jst) <= 1e-5
    ry, rst = S.gla_reference(*map(t, arrs))
    assert rel_err(y, ry) <= 1e-4 and rel_err(st, rst) <= 1e-4


def test_gla_mask_keeps_the_overflow_out():
    """Decays strong enough that exp(b_l - b_m) overflows above the
    diagonal: masked with ``where``, the output stays finite and equal to
    the reference's."""
    q, k, v, ld = _gla_inputs(np.random.RandomState(9), s=16)
    ld = ld * 40.0                              # |b| up to ~600 per chunk
    y, st = S.gla_chunked(t(q), t(k), t(v), t(ld), 16)
    jy, _ = JS.gla_chunked(*map(jnp.asarray, (q, k, v, ld)), 16)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert rel_err(y, jy) <= 1e-5


def test_gla_state_carries_across_calls_and_steps():
    """A chunked prefix's state, then decode steps, equal the oracle over
    the whole sequence; and ``gla_step`` is the reference's."""
    q, k, v, ld = map(t, _gla_inputs(np.random.RandomState(2), b=1, s=12,
                                     h=2, dk=4, dv=4))
    y_ref, _ = S.gla_reference(q, k, v, ld)
    _, st = S.gla_chunked(q[:, :8], k[:, :8], v[:, :8], ld[:, :8], 3)
    outs = []
    for i in range(8, 12):
        st, y = S.gla_step(st, q[:, i], k[:, i], v[:, i], ld[:, i])
        outs.append(y)
    assert rel_err(torch.stack(outs, 1), y_ref[:, 8:]) <= 1e-5
    # the prefix's state carried into a second chunked call
    y2, _ = S.gla_chunked(q[:, 8:], k[:, 8:], v[:, 8:], ld[:, 8:], 3,
                          S.gla_chunked(q[:, :8], k[:, :8], v[:, :8],
                                        ld[:, :8], 3)[1])
    assert rel_err(y2, y_ref[:, 8:]) <= 1e-5
    st0 = t(np.random.RandomState(3).standard_normal((1, 2, 4, 4)),
            torch.float32)
    got = S.gla_step(st0, q[:, 0], k[:, 0], v[:, 0], ld[:, 0])
    want = JS.gla_step(*(to_jax(a) for a in (st0, q[:, 0], k[:, 0],
                                             v[:, 0], ld[:, 0])))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_block_and_decode_match_jax(dtype):
    rng = np.random.RandomState(4)
    x = t(rng.standard_normal((2, 10, 6)), getattr(torch, dtype))
    kern = t(rng.standard_normal((4, 6)) * 0.3, torch.float32)
    y, none = S.causal_conv1d(x, kern)
    jy, _ = JS.causal_conv1d(to_jax(x), to_jax(kern))
    assert none is None and y.dtype == x.dtype
    tol = 1e-2 if dtype == "bfloat16" else 1e-6
    assert rel_err(y, jy) <= tol
    cache = torch.zeros((2, 3, 6), dtype=torch.bfloat16)
    jcache = to_jax(cache)
    outs = []
    for i in range(10):
        yi, cache = S.causal_conv1d(x[:, i:i + 1], kern, cache)
        jyi, jcache = JS.causal_conv1d(to_jax(x[:, i:i + 1]), to_jax(kern),
                                       jcache)
        assert str(cache.dtype)[6:] == str(jcache.dtype)
        assert rel_err(yi, jyi) <= tol
        outs.append(yi)
    assert rel_err(torch.cat(outs, 1), y) <= tol


# ---------------------------------------------------------------------------
# The mLSTM, sLSTM and Mamba-2 blocks
# ---------------------------------------------------------------------------

BLOCKS = {
    # name: (arch, the reference's initialiser, port prefill, decode)
    "mlstm": ("xlstm_350m", JS.init_mlstm, "mlstm_block", "mlstm_decode"),
    "slstm": ("xlstm_350m", JS.init_slstm, "slstm_block", "slstm_decode"),
    "mamba2": ("zamba2_2_7b", JS.init_mamba2, "mamba2_block",
               "mamba2_decode"),
}


@pytest.fixture(scope="module")
def blocks():
    """Each block's weights in both packages and its JAX prefill and
    decode, jitted once per dtype."""
    out = {}
    for name, (arch, init, pre, dec) in BLOCKS.items():
        cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
        tree_np = numpy_params(jcfg, 7, init=lambda key: init(key, jcfg))
        jp = jax.tree_util.tree_map(jnp.asarray, tree_np)
        p = getattr(S, type(tree_np).__name__)(*(t(a) for a in tree_np))
        fns = {dt: (exact_jit(lambda p_, x_, f=getattr(JS, pre), c=jcfg:
                              f(p_, x_, c)),
                    exact_jit(lambda p_, x_, st, f=getattr(JS, dec), c=jcfg:
                              f(p_, x_, c, st)))
               for dt in ("float32", "bfloat16")}
        out[name] = (cfg, p, jp, getattr(S, pre), getattr(S, dec), fns)
    return out


def _state_from_jax(st):
    if isinstance(st, (list, tuple)):
        return type(st)(_state_from_jax(a) for a in st)
    dt = torch.bfloat16 if st.dtype == jnp.bfloat16 else None
    return t(np.asarray(st, np.float32), dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_and_decode_match_jax(blocks, name, dtype):
    """A prefill over 11 positions (ssm_chunk 16: padded) and two decode
    steps from the reference's state, at 1e-5 in f32 and 1e-2 in bf16;
    the states (the GLA state, the conv tail) within the same of the
    reference's, in its dtypes."""
    cfg, p, jp, pre, dec, fns = blocks[name]
    jpre, jdec = fns[dtype]
    tdt = getattr(torch, dtype)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    rng = np.random.RandomState(3)
    x = t(rng.standard_normal((2, 11, cfg.d_model)), tdt)
    y, st = pre(p, x, cfg)
    jy, jst = jpre(jp, to_jax(x))
    assert y.dtype == tdt and rel_err(y, jy) <= tol
    for g, w in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(jst)):
        assert str(g.dtype)[6:] == str(w.dtype)
        assert rel_err(g, w) <= tol
    for _ in range(2):
        xd = t(rng.standard_normal((2, 1, cfg.d_model)), tdt)
        y, st = dec(p, xd, cfg, _state_from_jax(jst))
        jy, jst = jdec(jp, to_jax(xd), jst)
        assert y.dtype == tdt and rel_err(y, jy) <= tol
        for g, w in zip(jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(jst)):
            assert rel_err(g, w) <= tol


@pytest.mark.parametrize("name", ["mlstm", "mamba2", "slstm"])
def test_prefill_decode_consistency(blocks, name):
    """``tests/test_moe_ssm.py``'s consistency cases on the port: a
    prefill over 11 positions, then one decode step, equals the prefill
    over 12 at its last position (its rtol and atol, 2e-3)."""
    cfg, p, _, pre, dec, _ = blocks[name]
    x = t(np.random.RandomState(0).randn(2, 12, cfg.d_model) * 0.1,
          torch.float32)
    y_full, _ = pre(p, x, cfg)
    _, st = pre(p, x[:, :11], cfg)
    y_dec, _ = dec(p, x[:, 11:12], cfg, st)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, 11].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_init_states_are_the_reference_s():
    for arch in ("xlstm_350m", "zamba2_2_7b"):
        for red in (False, True):
            cfg, jcfg = get_config(arch), jax_config(arch)
            if red:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            got = S.init_ssm_state(cfg, 3, "cpu")
            want = JS.init_ssm_state(jcfg, 3)
            assert [(tuple(g.shape), str(g.dtype)[6:]) for g in got] == \
                [(w.shape, str(w.dtype)) for w in want]
            assert not any(g.any() for g in got)
    cfg = get_config("xlstm_350m")
    got = S.init_slstm_state(cfg, 2, "cpu")
    want = JS.init_slstm_state(jax_config("xlstm_350m"), 2)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert S._m2_dims(get_config("zamba2_2_7b")) == JS._m2_dims(
        jax_config("zamba2_2_7b"))
