"""The port's LM training slice against the JAX package on the CPU: the
cosine schedule, ``TokenBatches``, the cross-entropies, the train mode of
``transformer.forward`` for all ten configs, the GLA gradient's repair,
remat, the ``Trainer`` with checkpoints and resume, and the launcher's
LM path (``make_train_step`` in bf16 is ``test_torch_lm_train_steps.py``).

The same numpy inputs and parameters (``jax_lm_helpers.numpy_params``,
carried to the port by ``convert.params_from_numpy``) go through both
packages at ``reduced()`` sizes.  Gradients are read per leaf, as max
|port - JAX| / max |JAX|, at 1e-5 for f32, except where a model's own
conditioning amplifies f32 rounding past it (``F32_GRAD_TOL``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import TokenBatches as JTokenBatches  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.schedule import cosine_schedule as jax_cosine  # noqa
from jax_lm_helpers import numpy_params  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import TokenBatches  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    QTensor,
    adamw_init,
    cosine_schedule,
)
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig  # noqa

B, S_ = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: at these sizes it is as fast, and the suite's
    parallel workers would otherwise oversubscribe the cores (OpenMP
    threads spinning against each other made these files ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 gradients of the whole model, port vs JAX, of each leaf's max |g|.
# Two random reduced models amplify f32 rounding past 1e-5 (measured on
# seed 5's parameters): xlstm-350m 1.6e-5 (its sLSTM recurrences)
# and zamba2-2.7b 1.2e-4 (its second shared-attention application).
# Against the port's own float64 gradients of zamba2 the JAX package's
# f32 gradients lie 3.1e-5 off and the port's 9.6e-5; over seeds 6-12
# the two lie 0.4-1.9e-5 apart and equally far from float64.
F32_GRAD_TOL = {"xlstm_350m": 1e-4, "zamba2_2_7b": 3e-4}


def rel_errs(got, want) -> list[float]:
    """Each leaf's max |got - want| / max |want| (port tree, JAX tree)."""
    out = []
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        g = g.detach().float().numpy().astype(np.float64)
        w = np.asarray(w, np.float32).astype(np.float64)
        assert g.shape == w.shape
        scale = np.abs(w).max()
        out.append(float(np.abs(g - w).max() / scale) if scale
                   else float(np.abs(g).max()))
    return out


def _lm_batch(cfg, rng, variant="text"):
    """tokens/labels [B, S] (int32) and the family's extra inputs."""
    toks = rng.randint(0, cfg.vocab, (B, S_ + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        b["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        ar = np.arange(S_, dtype=np.int32)
        pos = np.broadcast_to(ar[None, None], (3, B, S_))
        if variant == "streams":      # test_mrope_differs_from_text_rope's
            pos = pos * np.array([1, 3, 5], np.int32)[:, None, None]
        b["mrope_positions"] = np.ascontiguousarray(pos)
    return b


def _both(batch):
    return ({k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# The schedule and the data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10000, 20000])
def test_cosine_schedule_matches_jax(step):
    want = float(jax_cosine(step))
    assert float(cosine_schedule(step)) == pytest.approx(want, abs=1e-7)
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-7
    assert float(cosine_schedule(0)) == 0.0       # the first step's rate


def _jax_extra(cfg):
    """The reference launcher's extra_fn (``repro/launch/train.py``)."""
    def extra_fn(step, b, s):
        extra = {}
        if cfg.family == "encdec":
            extra["enc_embeds"] = jnp.zeros((b, cfg.enc_seq, cfg.d_model),
                                            jnp.float32)
        if cfg.mrope:
            extra["mrope_positions"] = jnp.broadcast_to(
                jnp.arange(s)[None, None], (3, b, s)).astype(jnp.int32)
        return extra
    return extra_fn


@pytest.mark.parametrize("arch", ["llama3_2_1b", "whisper_tiny",
                                  "qwen2_vl_2b"])
@pytest.mark.parametrize("seed", [0, 7])
def test_token_batches_match_jax(arch, seed):
    """Bit for bit the reference's batches, its extra inputs included,
    at several steps; the prefetching stream gives the same batches."""
    cfg = get_config(arch).reduced()
    jcfg = jax_config(arch).reduced()
    ours = TokenBatches(cfg.vocab, 4, 16, seed=seed, prefetch=False,
                        extra_fn=launch_train.lm_extra(cfg), device="cpu")
    ref = JTokenBatches(jcfg.vocab, 4, 16, seed=seed, prefetch=False,
                        extra_fn=_jax_extra(jcfg))
    for step in (0, 1, 5):
        got, want = ours.make_batch(step), ref.make_batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype, k
            assert np.array_equal(got[k].numpy(), w), (k, step)
    stream = TokenBatches(cfg.vocab, 4, 16, seed=seed, start_step=1,
                          extra_fn=launch_train.lm_extra(cfg), device="cpu")
    try:
        for step in (1, 2):
            got = stream.next()
            assert torch.equal(got["tokens"], ours.make_batch(step)["tokens"])
    finally:
        stream.close()


def test_token_batches_outside_a_world_are_one_process():
    assert TokenBatches(256, 4, 8, prefetch=False).local_batch == 4
    assert TokenBatches(256, 4, 8, prefetch=False).process_index == 0


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.RandomState(0)
    logits = (3 * rng.standard_normal((B, S_, 64))).astype(np.float32)
    labels = rng.randint(0, 64, (B, S_)).astype(np.int32)
    mask = (rng.rand(B, S_) > 0.3).astype(np.float32) if masked else None
    lt = torch.tensor(logits, requires_grad=True)
    got = T.cross_entropy(lt, torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(got, lt)
    want, jg = jax.value_and_grad(lambda x: JT.cross_entropy(
        x, jnp.asarray(labels), None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(logits))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert rel_errs([g], [jg])[0] <= 1e-5


@pytest.mark.parametrize("branch, xent_chunk", [
    ("whole", 8192),        # t <= chunk
    ("ragged", 6),          # t % chunk != 0: the whole logits too
    ("chunked", 4),         # t > chunk, t % chunk == 0: the chunk loop
])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "stablelm_1_6b"])
def test_chunked_xent_matches_jax(arch, branch, xent_chunk):
    """Value and gradients in h, the final norm and the table (the tied
    embedding, or the separate head) at 1e-5."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              xent_chunk=xent_chunk)
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               xent_chunk=xent_chunk)
    rng = np.random.RandomState(1)
    tree_np = numpy_params(jcfg, seed=2)
    keys = ["final_norm", "lm_head" if "lm_head" in tree_np else "embed"]
    p_np = {k: tree_np[k] for k in {"embed", *keys}}
    h = rng.standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    labels = rng.randint(0, cfg.vocab, (B, S_)).astype(np.int32)
    pt = {k: torch.tensor(v, requires_grad=k in keys)
          for k, v in p_np.items()}
    ht = torch.tensor(h, requires_grad=True)
    got = T.chunked_xent(pt, cfg, ht, torch.from_numpy(labels))
    grads = torch.autograd.grad(got, [ht, *(pt[k] for k in keys)])
    want, (jgh, jgp) = jax.value_and_grad(
        lambda hh, pp: JT.chunked_xent(pp, jcfg, hh, jnp.asarray(labels)),
        argnums=(0, 1))(jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray,
                                                               p_np))
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    errs = rel_errs(list(grads), [jgh, *(jgp[k] for k in keys)])
    assert max(errs) <= 1e-5, errs


# ---------------------------------------------------------------------------
# The train forward of every config, f32, with gradients
# ---------------------------------------------------------------------------

class _Model:
    def __init__(self, arch):
        self.cfg = get_config(arch).reduced()
        self.jcfg = jax_config(arch).reduced()
        tree_np = numpy_params(self.jcfg, seed=5)
        self.params = params_from_numpy(tree_np, "cpu", cfg=self.cfg)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, tree_np)
        jcfg = self.jcfg
        self.jgrad = jax.jit(jax.value_and_grad(
            lambda p, b: JT.forward(p, jcfg, b, mode="train",
                                    param_dtype=jnp.float32), has_aux=True))


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Model(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_forward_train_matches_jax(models, arch):
    """Loss and MoE term at 1e-5 of the reference's, every leaf's f32
    gradient (``launch.steps.lm_grads``) at 1e-5 of its max |g| (the
    model's floor where it amplifies rounding: ``F32_GRAD_TOL``)."""
    m = models(arch)
    tb, jb = _both(_lm_batch(m.cfg, np.random.RandomState(1)))
    loss, metrics, grads = ST.lm_grads(m.params, m.cfg, tb,
                                       param_dtype=torch.float32)
    (jloss, jmetrics), jgrads = m.jgrad(m.jparams, jb)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(metrics["aux"]) - float(jmetrics["aux"])) <= \
        1e-5 * max(abs(float(jmetrics["aux"])), 1.0)
    assert (float(metrics["aux"]) > 0) == (m.cfg.family == "moe")
    errs = rel_errs(grads, jgrads)
    assert len(errs) == len(jax.tree_util.tree_leaves(jgrads))
    assert max(errs) <= F32_GRAD_TOL.get(arch, 1e-5), errs


def test_mrope_streams_move_the_loss_as_in_the_reference(models):
    """``test_mrope_differs_from_text_rope``'s case: three distinct
    position streams give another loss than the text positions, in both
    packages alike."""
    m = models("qwen2_vl_2b")
    losses = []
    for variant in ("text", "streams"):
        tb, jb = _both(_lm_batch(m.cfg, np.random.RandomState(2), variant))
        loss, _, grads = ST.lm_grads(m.params, m.cfg, tb,
                                     param_dtype=torch.float32)
        (jloss, _), jgrads = m.jgrad(m.jparams, jb)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert max(rel_errs(grads, jgrads)) <= 1e-5
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) > 1e-6


def test_train_mode_builds_no_cache_and_takes_prefix_embeds(models):
    m = models("qwen2_vl_2b")
    rng = np.random.RandomState(3)
    batch = _lm_batch(m.cfg, rng)
    batch["prefix_embeds"] = (0.02 * rng.standard_normal(
        (B, 3, m.cfg.d_model))).astype(np.float32)
    tb, jb = _both(batch)
    loss, _ = T.forward(m.params, m.cfg, tb, param_dtype=torch.float32)
    (jloss, _), _ = m.jgrad(m.jparams, jb)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    with torch.no_grad():
        h = torch.zeros(B, S_, m.cfg.d_model)
        pos = torch.arange(S_)[None].expand(B, S_)
        _, cache, _ = T.backbone(m.params, m.cfg, h, mode="train",
                                 positions=pos)
    assert cache == {}


# ---------------------------------------------------------------------------
# Gradients where a spelled-out op sequence overflows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_is_the_references_where_exp_overflows(dtype):
    """``layers.silu`` keeps the reference's forward op sequence, bit for
    bit, and takes ``jax.grad``'s gradient through the logistic: finite
    where exp(-x) overflows (x < -88.7, as dbrx-132b's expert gates reach
    at full width), where autograd through the sequence gives NaN."""
    from repro_torch.models import layers as L
    x = np.linspace(-200, 200, 4001).astype(np.float32)
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = L.silu(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    plain = xt * (1 / (1 + torch.exp(-xt)))
    assert torch.equal(y, plain)
    (g_plain,) = torch.autograd.grad(plain.sum(), xt)
    assert not torch.isfinite(g_plain).all()            # 0 * inf
    jg = jax.jit(jax.grad(lambda a: jnp.sum(jax.nn.silu(a))))(
        jnp.asarray(x, getattr(jnp, dtype)))
    assert torch.isfinite(g).all()
    want = np.asarray(jg, np.float32)
    assert np.abs(g.float().numpy() - want).max() <= \
        (1e-6 if dtype == "float32" else 1e-2) * np.abs(want).max()


# ---------------------------------------------------------------------------
# The GLA gradient: a reference defect, repaired
# ---------------------------------------------------------------------------

def _gla_inputs():
    rng = np.random.RandomState(0)
    q, k = (rng.standard_normal((1, 32, 2, 4)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 32, 2, 5)).astype(np.float32)
    ld = (-20 * rng.rand(1, 32, 2)).astype(np.float32)
    return q, k, v, ld


def _gla_recurrence64(q, k, v, log_decay):
    """``gla_reference``'s per-step recurrence in float64: S_t = S_{t-1}
    exp(g_t) + k_t v_t^T, y_t = q_t S_t."""
    b, s, h, dk = q.shape
    state = q.new_zeros((b, h, dk, v.shape[-1]))
    ys = []
    for t in range(s):
        state = state * torch.exp(log_decay[:, t])[..., None, None] + \
            k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    return torch.stack(ys, dim=1), state


def test_gla_gradient_is_finite_where_the_reference_is_nan():
    """A chunk (16 tokens) whose log-decays sum past f32's exp limit: the
    reference masks exp(b_l - b_m) after taking it, so its forward is
    right and its gradient NaN; the port masks the exponent first, and
    its gradients match autograd through the per-step recurrence of
    ``gla_reference`` in float64 within 1e-5."""
    inputs = _gla_inputs()

    def jloss(*a):
        y, st = JS.gla_chunked(*a, 16)
        return jnp.sum(y) + jnp.sum(st)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, inputs))
    assert any(np.isnan(np.asarray(g)).any() for g in jg)   # the defect

    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    y, st = S.gla_chunked(*ts, 16)
    grads = torch.autograd.grad(y.sum() + st.sum(), ts)
    t64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in inputs]
    y64, st64 = _gla_recurrence64(*t64)
    g64 = torch.autograd.grad(y64.sum() + st64.sum(), t64)
    for g, w in zip(grads, g64):
        assert torch.isfinite(g).all()
        assert float((g.double() - w).abs().max() / w.abs().max()) <= 1e-5
    assert float((y.double() - y64).abs().max() / y64.abs().max()) <= 1e-5


def test_gla_forward_is_unchanged_by_the_repair():
    """The masked exponent leaves the forward bit for bit what masking
    after the exp gave (every serve result stands)."""
    q, k, v, ld = (torch.from_numpy(a) for a in _gla_inputs())
    y, st = S.gla_chunked(q, k, v, ld, 16)
    # the reference's order, chunk by chunk: exp, multiply, then mask
    lower = torch.tril(torch.ones(16, 16, dtype=torch.bool))
    state, ys = torch.zeros(1, 2, 4, 5), []
    for c in range(2):
        sl = slice(16 * c, 16 * c + 16)
        qi, ki, vi = q[:, sl], k[:, sl], v[:, sl]
        bi = torch.cumsum(ld[:, sl], dim=1)
        bl = bi[:, -1]
        y_inter = torch.einsum("blhk,bhkv->blhv",
                               qi * torch.exp(bi)[..., None], state)
        att = torch.einsum("blhk,bmhk->bhlm", qi, ki)
        decay = torch.exp(bi[:, :, None] - bi[:, None, :])
        att = torch.where(lower, att * decay.permute(0, 3, 1, 2), 0.0)
        ys.append(y_inter + torch.einsum("bhlm,bmhv->blhv", att, vi))
        kscale = ki * torch.exp(bl[:, None] - bi)[..., None]
        state = state * torch.exp(bl)[..., None, None] + torch.einsum(
            "bmhk,bmhv->bhkv", kscale, vi)
    assert torch.equal(y, torch.cat(ys, dim=1)) and torch.equal(st, state)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, segments", [
    ("llama3_2_1b", 0), ("dbrx_132b", 2), ("zamba2_2_7b", 0),
    ("whisper_tiny", 0), ("qwen2_vl_2b", 0)])
def test_remat_gives_the_same_gradients_bit_for_bit(monkeypatch, arch,
                                                    segments):
    """Each layer checkpointed (and, with ``remat_segments`` 2 of 4
    layers, nested in segments), the attention's query chunks and the
    cross-entropy's token chunks checkpointed: the bf16 step's loss and
    every gradient equal to those without remat."""
    monkeypatch.setattr(A, "_Q_CHUNK", 4)
    cfg = dataclasses.replace(get_config(arch).reduced(), xent_chunk=8,
                              remat_segments=segments)
    assert cfg.n_layers == 4
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tb, _ = _both(_lm_batch(cfg, np.random.RandomState(4)))
    on = ST.lm_grads(params, cfg, tb)
    off = ST.lm_grads(params, dataclasses.replace(
        cfg, remat=False, remat_segments=0), tb)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(on[2]),
                                                 tree.leaves(off[2])))


# ---------------------------------------------------------------------------
# Training: the loss goes down, the Trainer resumes, the launcher
# ---------------------------------------------------------------------------

def test_lm_training_reduces_loss():
    """The reference's ``test_lm_training_reduces_loss``: 15 steps at lr
    1e-3 on one batch (the first two at the warmup's rates 0 and 1e-5)."""
    cfg = get_config("llama3_2_1b").reduced()
    opt = AdamWConfig(lr=1e-3)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = adamw_init(params, opt)
    batch = TokenBatches(cfg.vocab, 4, 32, prefetch=False,
                         device="cpu").make_batch(0)
    step = ST.make_train_step(cfg, opt)
    first = None
    for i in range(15):
        new, state, m = step(params, state, batch)
        if i == 0:      # the cosine schedule's rate 0: nothing moves
            assert all(torch.equal(a, b) for a, b in zip(
                tree.leaves(new), tree.leaves(params)))
            first = float(m["loss"])
        params = new
    assert float(m["loss"]) < first


@pytest.mark.parametrize("state_bits", [32, 8])
def test_trainer_resumes_bit_equal(tmp_path, state_bits):
    """A ``Trainer`` run to step 8 with checkpoints every 4, and a new
    one resumed from step 4 (its batches from step 4 on): the same
    parameters and moments bit for bit; 8-bit moments come back as
    ``QTensor``s."""
    cfg = get_config("llama3_2_1b").reduced()
    opt = AdamWConfig(lr=1e-3, state_bits=state_bits)

    def trainer(start, directory):
        params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
        data = TokenBatches(cfg.vocab, 2, 16, start_step=start,
                            device="cpu")
        return Trainer(ST.make_train_step(cfg, opt), params,
                       adamw_init(params, opt), data,
                       TrainLoopConfig(total_steps=8, checkpoint_every=4,
                                       log_every=100,
                                       checkpoint_dir=str(directory)))

    ref = trainer(0, tmp_path / "a")
    ref.run()
    assert ref.ckpt.latest_valid_step() == 8
    ckpt = tmp_path / "b"
    ckpt.mkdir()
    (tmp_path / "a" / "step_00000004").rename(ckpt / "step_00000004")
    resumed = trainer(4, ckpt)
    assert resumed.maybe_resume() and resumed.step == 4
    m_embed = resumed.opt_state.m["embed"]
    assert isinstance(m_embed, QTensor) == (state_bits == 8)
    resumed.run()
    for got, want in ((resumed.params, ref.params),
                      (resumed.opt_state, ref.opt_state)):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                     tree.leaves(want)))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny",
                                  "qwen2-vl-2b", "dbrx-132b",
                                  "zamba2-2.7b", "xlstm-350m"])
def test_launcher_trains_an_lm_on_the_cpu(tmp_path, arch):
    """``launch.train.main`` on ``--device cpu``: finite losses, the
    config's moment bits, checkpoints; ``--resume`` continues from the
    newest checkpoint with that step's batch, so a run cut at step 2 and
    resumed ends where the uninterrupted run does."""
    def run(steps, directory, *extra):
        return launch_train.main(
            ["--arch", arch, "--reduced", "--device", "cpu", "--steps",
             str(steps), "--batch", "2", "--seq", "16",
             "--checkpoint-every", "2", "--checkpoint-dir", str(directory),
             *extra])

    whole = run(3, tmp_path / "a")
    assert whole.step == 3
    cfg = get_config(arch).reduced()
    m = tree.leaves(whole.opt_state.m, is_leaf=lambda x: isinstance(
        x, QTensor))[0]
    assert isinstance(m, QTensor) == (cfg.opt_state_bits == 8)
    cut = run(2, tmp_path / "b")
    assert cut.ckpt.latest_valid_step() == 2
    resumed = run(3, tmp_path / "b", "--resume")
    assert resumed.step == 3
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(resumed.params), tree.leaves(whole.params)))
