"""The port's training slice against the JAX package, on the CPU.

Same numpy inputs and parameters go through both packages (parameters
cross with ``repro_torch.convert.params_from_numpy``; they are drawn by
the port's initialiser, whose shapes ``params_from_numpy`` holds to the
model's).  The port runs its
kernels' plain versions through its autograd ``Function``s; the JAX side
runs jitted on its ``iom_phase`` engine, which ``tests/test_models.py``
holds equal to its Pallas engine — the Pallas interpret kernels would cost
minutes per train step here, and ``tests/test_torch_grad.py`` already
holds every op's backward against them.

Tolerances: forwards and losses 1e-4 relative (f32 sums in another
order); gradients 1e-4 of each leaf's magnitude; AdamW on fixed gradients
1e-6; a 3-step loss trajectory 1e-3 relative (AdamW turns gradient noise
where v is near 0 into parameter differences of order lr, so parameters
are not held at 1e-4 after a step).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import DcnnBatches as JaxDcnnBatches  # noqa: E402
from repro.data import VolumeBatches as JaxVolumeBatches  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import dcnn as JD  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamW  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    WeightShapeError,
    adamw_state_from_numpy,
    params_from_numpy,
)
from repro_torch.core.engine import UniformEngine  # noqa: E402
from repro_torch.data import DcnnBatches, VolumeBatches  # noqa: E402
from repro_torch.kernels.conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.deconv import kernel as deconv_kernel  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import dcnn as TD  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig  # noqa

ARCHS = ("dcgan", "v-net")
STEPS = 3


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _numpy_params(tcfg, seed):
    """A model's parameter tree as numpy arrays (drawn by the port's
    initialiser; ``jax.random`` compiles once per shape, seconds each)."""
    params = TS.real_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    return tree.tree_map(lambda t: t.numpy(), params)


def _jax_params(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _leaves_close(got, want, tol, what):
    got_l = [t.detach().numpy() for t in tree.leaves(got)]
    want_l = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, (what, i)
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (what, i, err, scale)


def _batches(arch, cfg, tcfg, seed=0):
    if arch == "v-net":
        sp = JD._vnet_spatial(cfg)
        return (JaxVolumeBatches(cfg.dcnn_batch, sp, seed=seed,
                                 prefetch=False),
                VolumeBatches(tcfg.dcnn_batch, sp, seed=seed, prefetch=False,
                              device="cpu"))
    last = JD._scaled_layers(cfg)[-1]
    shape = (*last.out_spatial, last.cout)
    return (JaxDcnnBatches(cfg.dcnn_batch, cfg.dcnn_z, shape, seed=seed,
                           prefetch=False),
            DcnnBatches(tcfg.dcnn_batch, tcfg.dcnn_z, shape, seed=seed,
                        prefetch=False, device="cpu"))


@contextlib.contextmanager
def _capture_grads(module):
    """Record the gradients each ``adamw_update`` call of a step module
    receives."""
    seen = []
    real = module.adamw_update

    def spy(grads, *a, **k):
        seen.append(grads)
        return real(grads, *a, **k)
    module.adamw_update = spy
    try:
        yield seen
    finally:
        module.adamw_update = real


@pytest.fixture(scope="module")
def runs():
    """STEPS train steps of each reduced model in both packages, from the
    same parameters and batches: losses per step, the first step's
    gradients, and the inputs."""
    out = {}
    teng = UniformEngine(device="cpu")
    for arch in ARCHS:
        cfg = jax_config(arch).reduced()
        tcfg = get_config(arch).reduced()
        np_params = _numpy_params(tcfg, 0)
        vals = _jax_params(np_params)
        tparams = params_from_numpy(np_params, "cpu", cfg=tcfg)
        jopt, topt = JaxAdamW(), tadamw.AdamWConfig()
        if arch == "v-net":
            jstep = JS.make_vnet_train_step(cfg, jopt, engine="iom_phase")
            tstep = TS.make_vnet_train_step(tcfg, topt, engine=teng)
            jstate = jadamw.adamw_init(vals, jopt)
        else:
            jstep = JS.make_gan_train_step(cfg, jopt, engine="iom_phase")
            tstep = TS.make_gan_train_step(tcfg, topt, engine=teng)
            jstate = (jadamw.adamw_init(vals["gen"], jopt),
                      jadamw.adamw_init(vals["disc"], jopt))
        tstate = (adamw_state_from_numpy(_np(jstate), "cpu", params=tparams)
                  if arch == "v-net" else
                  tuple(adamw_state_from_numpy(_np(s), "cpu",
                                               params=tparams[k])
                        for s, k in zip(jstate, ("gen", "disc"))))
        jdata, tdata = _batches(arch, cfg, tcfg)
        with _capture_grads(JS) as jseen:
            def run(p, s, b):
                jseen.clear()
                new = jstep(p, s, b)
                return new, list(jseen)
            jrun = jax.jit(run)
            jlosses, tlosses, grads = [], [], None
            p, s = vals, jstate
            tp, ts = tparams, tstate
            with _capture_grads(TS) as tseen:
                for step in range(STEPS):
                    (p, s, jm), jg = jrun(p, s, jdata.make_batch(step))
                    tseen.clear()
                    tp, ts, tm = tstep(tp, ts, tdata.make_batch(step))
                    if step == 0:
                        grads = (jg, list(tseen), vals, tparams)
                    jlosses.append({k: float(v) for k, v in jm.items()})
                    tlosses.append({k: float(v) for k, v in tm.items()})
        out[arch] = dict(cfg=cfg, tcfg=tcfg, jlosses=jlosses,
                         tlosses=tlosses, grads=grads, jdata=jdata,
                         tdata=tdata, teng=teng)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_jax(runs, arch):
    jg, tg, _, _ = runs[arch]["grads"]
    assert len(jg) == len(tg) == (2 if arch == "dcgan" else 1)
    for j, t in zip(jg, tg):
        _leaves_close(t, j, 1e-4, f"{arch} grads")
    first = runs[arch]["tlosses"][0]
    for k, v in runs[arch]["jlosses"][0].items():
        assert abs(first[k] - v) <= 1e-4 * abs(v), (k, first[k], v)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_step_loss_trajectory(runs, arch):
    for step, (j, t) in enumerate(zip(runs[arch]["jlosses"],
                                      runs[arch]["tlosses"])):
        assert j.keys() == t.keys()
        for k in j:
            assert np.isfinite(t[k])
            assert abs(t[k] - j[k]) <= 1e-3 * abs(j[k]), (step, k, t[k],
                                                          j[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_match_jax_pipeline(runs, arch):
    jb = runs[arch]["jdata"].make_batch(5)
    tb = runs[arch]["tdata"].make_batch(5)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_forwards_and_losses_match_jax(runs):
    teng = runs["dcgan"]["teng"]
    cfg, tcfg = runs["dcgan"]["cfg"], runs["dcgan"]["tcfg"]
    np_params = _numpy_params(tcfg, 1)
    vals = _jax_params(np_params)
    tp = params_from_numpy(np_params, "cpu", cfg=tcfg)
    batch = runs["dcgan"]["jdata"].make_batch(0)
    z, real = np.asarray(batch["z"]), np.asarray(batch["real"])

    @jax.jit
    def jfwd(vals, z, real):
        fake = JD.generator_forward(vals["gen"], cfg, z, "iom_phase")
        d_real = JD.discriminator_forward(vals["disc"], cfg, real,
                                          "iom_phase")
        g, d, _ = JD.gan_losses(vals["gen"], vals["disc"], cfg, z, real,
                                "iom_phase")
        return fake, d_real, g, d

    ref = jfwd(vals, z, real)
    tz, treal = torch.tensor(z), torch.tensor(real)
    fake = TD.generator_forward(tp["gen"], tcfg, tz, teng)
    d_real = TD.discriminator_forward(tp["disc"], tcfg, treal, teng)
    g, d, fake2 = TD.gan_losses(tp["gen"], tp["disc"], tcfg, tz, treal, teng)
    for name, got, want in (("fake", fake, ref[0]), ("d_real", d_real, ref[1]),
                            ("g_loss", g, ref[2]), ("d_loss", d, ref[3])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    assert torch.equal(fake, fake2)

    cfg, tcfg = runs["v-net"]["cfg"], runs["v-net"]["tcfg"]
    np_params = _numpy_params(tcfg, 2)
    vals = _jax_params(np_params)
    tp = params_from_numpy(np_params, "cpu", cfg=tcfg)
    batch = runs["v-net"]["jdata"].make_batch(0)
    vol, labels = np.asarray(batch["vol"]), np.asarray(batch["labels"])

    @jax.jit
    def jvnet(vals, vol, labels):
        logits = JD.vnet_forward(vals["vnet"], cfg, vol, "iom_phase")
        return logits, JD.dice_loss(logits, labels)

    logits, loss = jvnet(vals, vol, labels)
    tlogits = TD.vnet_forward(tp["vnet"], tcfg, torch.tensor(vol), teng)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(logits).max()))
    # the loss alone, on the same logits
    tloss = TD.dice_loss(torch.tensor(np.asarray(logits)),
                         torch.tensor(labels))
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_matches_jax_on_fixed_gradients(bits):
    rng = np.random.default_rng(bits)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [{"a": (rng.normal(size=(3, 4)) * 1e-3).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
             for _ in range(3)]
    jopt = JaxAdamW(lr=1e-2, state_bits=bits)
    topt = tadamw.AdamWConfig(lr=1e-2, state_bits=bits)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree.tree_map(torch.from_numpy, params)
    js, ts = jadamw.adamw_init(jp, jopt), tadamw.adamw_init(tp, topt)
    for g in grads:
        jp, js = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                     js, jp, jopt)
        tp, ts = tadamw.adamw_update(tree.tree_map(torch.from_numpy, g), ts,
                                     tp, topt)
    _leaves_close(tp, jp, 1e-6, "params")
    _leaves_close(ts.m, js.m, 1e-6, "m")
    _leaves_close(ts.v, js.v, 1e-6, "v")
    assert int(ts.step) == int(js.step) == 3
    if bits == 8:
        assert isinstance(ts.m["a"], tadamw.QTensor)
        assert ts.m["a"].q.dtype == torch.int8


def test_step_launch_counts_match_the_graphs(monkeypatch):
    """On the CPU the wrappers run their plain versions; counting their
    calls over one reduced step gives what the card launches, and that is
    what ``train_step_launches`` derives from the graphs."""
    calls = dict.fromkeys(TS.LAUNCH_COUNTERS, 0)
    for mod, name in ((deconv_kernel, "deconv_fwd"),
                      (conv_kernel, "conv_fwd"),
                      (deconv_kernel, "deconv_dw"),
                      (deconv_kernel, "deconv_dx")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    eng = UniformEngine(device="cpu")
    opt = tadamw.AdamWConfig()
    for arch in ARCHS:
        tcfg = get_config(arch).reduced()
        params = TS.real_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
        _, data = _batches(arch, jax_config(arch).reduced(), tcfg)
        if arch == "v-net":
            step = TS.make_vnet_train_step(tcfg, opt, eng)
            state = tadamw.adamw_init(params, opt)
        else:
            step = TS.make_gan_train_step(tcfg, opt, eng)
            state = (tadamw.adamw_init(params["gen"], opt),
                     tadamw.adamw_init(params["disc"], opt))
        for k in calls:
            calls[k] = 0
        step(params, state, data.make_batch(0))
        assert calls == TS.train_step_launches(tcfg), arch
    assert TS.train_step_launches(get_config("dcgan")) == {
        "deconv_fwd": 11, "conv_fwd": 12, "deconv_dw": 8, "deconv_dx": 4}
    assert TS.train_step_launches(get_config("v-net")) == {
        "deconv_fwd": 13, "conv_fwd": 14, "deconv_dw": 14, "deconv_dx": 4}


def test_trainer_checkpoints_and_resumes(tmp_path):
    tcfg = get_config("v-net").reduced()
    eng = UniformEngine(device="cpu")
    opt = tadamw.AdamWConfig(state_bits=8)

    def trainer(total, start=0):
        params = TS.real_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
        data = VolumeBatches(tcfg.dcnn_batch, TD._vnet_spatial(tcfg),
                             start_step=start, device="cpu")
        return Trainer(TS.make_vnet_train_step(tcfg, opt, eng), params,
                       tadamw.adamw_init(params, opt), data,
                       TrainLoopConfig(total_steps=total, checkpoint_every=1,
                                       log_every=1,
                                       checkpoint_dir=str(tmp_path)))

    first = trainer(2)
    first.run()
    assert first.ckpt.latest_valid_step() == 2
    ref = trainer(3)
    ref.ckpt = Checkpointer(tmp_path / "ref")
    ref.run()

    resumed = trainer(3, start=2)
    assert resumed.maybe_resume() and resumed.step == 2
    assert isinstance(resumed.opt_state.m["vnet"]["head"], tadamw.QTensor)
    _leaves_close(resumed.params, tree.tree_map(lambda t: t.numpy(),
                                                first.params), 0.0, "resume")
    resumed.run()
    assert resumed.step == 3
    assert resumed.metrics_log[-1]["loss"] == pytest.approx(
        ref.metrics_log[-1]["loss"], rel=1e-6)
    # a corrupt newest checkpoint is skipped
    bad = tmp_path / "step_00000003" / "leaf_00000.npy"
    bad.write_bytes(b"broken")
    assert resumed.ckpt.latest_valid_step() == 2


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    trainer = launch_train.main(
        ["--arch", "dcgan", "--reduced", "--steps", "10", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path)])
    assert trainer.step == 10 and len(trainer.metrics_log) == 1
    rec = trainer.metrics_log[0]
    assert np.isfinite(rec["g_loss"]) and np.isfinite(rec["d_loss"])
    assert "finished at step 10" in capsys.readouterr().out
    assert trainer.ckpt.latest_valid_step() == 10
    # an LM trains through the same launcher (ROADMAP item 15.5)
    lm = launch_train.main(
        ["--arch", "llama3.2-1b", "--reduced", "--steps", "2", "--device",
         "cpu", "--batch", "2", "--seq", "16", "--checkpoint-dir",
         str(tmp_path / "lm")])
    assert lm.step == 2 and lm.ckpt.latest_valid_step() == 2
    assert "finished at step 2" in capsys.readouterr().out


def test_params_from_numpy_refuses_a_tree_of_another_model():
    vals = _numpy_params(get_config("dcgan").reduced(), 0)
    with pytest.raises(WeightShapeError, match="do not match"):
        params_from_numpy(vals, "cpu", cfg=get_config("dcgan"))
    with pytest.raises(WeightShapeError):
        params_from_numpy({"vnet": vals["gen"]}, "cpu",
                          cfg=get_config("v-net").reduced())
