"""The port's fault layer against the JAX package's.

``FaultScript.from_seed`` draws the same events in both packages for the
same seed; ``on_call`` counts calls per channel and match key as the
reference does; ``corrupt`` poisons a clone of a tensor on its own device;
``FaultyEngine`` wraps any engine; and ``wrap_step`` drives the port's
``Trainer`` straggler watchdog and its SIGTERM checkpoint-and-exit, as
``tests/test_faults_serving.py`` drives the reference's.
"""

import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import faults as jfaults  # noqa: E402
from repro_torch.core.engine import EngineConfig, UniformEngine  # noqa
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa
from repro_torch.runtime import faults as tfaults  # noqa: E402
from repro_torch.runtime.faults import (  # noqa: E402
    KINDS,
    FaultEvent,
    FaultScript,
    FaultyEngine,
    InjectedCompileError,
    InjectedDispatchError,
    has_poison,
    poisoned_rows,
)
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig  # noqa

MIX = dict(calls=24, p_error=0.2, p_slow=0.15, p_nan=0.1,
           p_compile_error=0.1, slow_s=0.05, rows=(0, 2))


def _fields(e):
    return (e.kind, e.at_call, e.channel, e.match, e.count, e.factor,
            tuple(e.rows), e.signum)


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_from_seed_draws_the_references_events(seed):
    got = FaultScript.from_seed(seed, **MIX).events
    ref = jfaults.FaultScript.from_seed(seed, **MIX).events
    assert [_fields(e) for e in got] == [_fields(e) for e in ref]
    assert KINDS == jfaults.KINDS


def test_on_call_counts_per_channel_and_match():
    def script(mod):
        return mod.FaultScript(
            [mod.FaultEvent("error", at_call=2, match="vnet"),
             mod.FaultEvent("compile_error", at_call=1, match="pallas:"),
             mod.FaultEvent("nan", at_call=3, rows=(1,))],
            sleep=lambda s: None)

    calls = [("dispatch", "pallas:vnet:8x8x8b1"),
             ("dispatch", "pallas:dcgan_gen:4x4b1"),
             ("compile", "xla:vnet:8x8x8b1"),
             ("dispatch", "xla:vnet:8x8x8b1"),
             ("compile", "pallas:vnet:8x8x8b1"),
             ("dispatch", "pallas:vnet:8x8x8b2")]
    logs = []
    for mod in (jfaults, tfaults):
        sc, log = script(mod), []
        for channel, tag in calls:
            try:
                log.append([e.kind for e in sc.on_call(channel, tag)])
            except mod.InjectedFault as e:
                log.append(type(e).__name__)
        counts = {(c, m): sc.calls(c, m) for c in ("dispatch", "compile")
                  for m in ("", "vnet", "pallas:")}
        logs.append((log, counts, [(e.kind, k, t) for e, k, t in sc.fired]))
    assert logs[0] == logs[1]
    log, counts, _ = logs[1]
    assert log == [[], [], [], "InjectedDispatchError",
                   "InjectedCompileError", []]
    assert counts[("dispatch", "")] == 4 and counts[("dispatch", "vnet")] == 3
    assert counts[("compile", "pallas:")] == 1


def test_nan_event_fires_on_the_third_dispatch():
    sc = FaultScript([FaultEvent("nan", at_call=3, rows=(1,))])
    assert sc.on_call("dispatch") == [] and sc.on_call("dispatch") == []
    (ev,) = sc.on_call("dispatch")
    assert ev.rows == (1,) and sc.calls("dispatch") == 3


def test_corrupt_poisons_a_clone_of_a_tensor():
    ev = FaultEvent("nan", rows=(0, 2, 9))
    y = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)
    out = FaultScript.corrupt(y, [ev])
    assert torch.is_tensor(out) and out.device == y.device
    assert out.data_ptr() != y.data_ptr() and torch.isfinite(y).all()
    assert poisoned_rows(out) == [0, 2] and has_poison(out)
    torch.testing.assert_close(out[1], y[1])
    assert FaultScript.corrupt(y, []) is y
    inf = FaultScript.corrupt(y.to(torch.bfloat16),
                              [FaultEvent("nan", rows=(1,), fill=np.inf)])
    assert inf.dtype == torch.bfloat16 and poisoned_rows(inf) == [1]
    # numpy in, numpy out, as in the reference
    arr = FaultScript.corrupt(y.numpy(), [ev])
    ref = jfaults.FaultScript.corrupt(y.numpy(), [jfaults.FaultEvent(
        "nan", rows=(0, 2, 9))])
    np.testing.assert_array_equal(arr, ref)
    assert poisoned_rows(arr) == jfaults.poisoned_rows(ref) == [0, 2]
    assert not has_poison(torch.zeros(2, 3, dtype=torch.int8))


def test_faulty_engine_wraps_any_engine():
    eng = UniformEngine(EngineConfig(method="xla", device="cpu"))
    script = FaultScript([FaultEvent("error", at_call=2),
                          FaultEvent("nan", at_call=3, rows=(0,))])
    faulty = FaultyEngine(eng, script)
    assert faulty.config.method == "xla"         # passthrough
    x = torch.ones((2, 4, 4, 2))
    w = torch.ones((3, 3, 2, 3)) * 0.1
    pad = ((0, 1), (0, 1))
    y = faulty.deconv(x, w, (2, 2), pad)
    torch.testing.assert_close(y, eng.deconv(x, w, (2, 2), pad))
    with pytest.raises(InjectedDispatchError):
        faulty.deconv(x, w, (2, 2), pad)
    assert poisoned_rows(faulty.conv(x, w[..., :2, :], 1, 1)) == [0]
    assert script.calls("dispatch", "") == 3
    assert [t for _, _, t in script.fired] == ["xla:deconv", "xla:conv"]


def test_faulty_engine_runs_a_layer_without_its_scale():
    """The reference's ``FaultyEngine.__call__`` passes neither
    ``w_scale`` nor the layer's precision on; the port keeps that
    signature."""
    from repro_torch.core import networks as tnet
    (layer,) = tnet.deconv_stack("g", 2, 4, [2, 3])
    eng = UniformEngine(EngineConfig(method="xla", device="cpu"))
    faulty = FaultyEngine(eng, FaultScript())
    x = torch.randn(1, 4, 4, 2, generator=torch.Generator().manual_seed(0))
    w = torch.randn(layer.weight_shape)
    torch.testing.assert_close(faulty(layer, x, w), eng(layer, x, w))
    with pytest.raises(TypeError):
        faulty(layer, x, w, w_scale=torch.ones(3))


def test_compile_error_is_not_a_dispatch_error():
    sc = FaultScript([FaultEvent("compile_error")])
    with pytest.raises(InjectedCompileError):
        sc.on_call("compile", "pallas:vnet:8x8x8b1")
    assert not issubclass(InjectedCompileError, InjectedDispatchError)


# ---------------------------------------------------------------------------
# The train loop's fault paths, driven by the script.
# ---------------------------------------------------------------------------

def _toy_trainer(tmp_path, steps=12, ck_every=100):
    params = {"w": torch.zeros(4)}
    opt = AdamWConfig(lr=0.1, weight_decay=0.0)

    class Data:
        def next(self):
            return torch.ones(4)

        def close(self):
            pass

    def step_fn(p, s, batch):
        w = p["w"].detach().requires_grad_(True)
        loss = torch.sum((w - batch) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        p, s = adamw_update({"w": g}, s, p, opt)
        return p, s, {"loss": loss.detach()}

    return Trainer(step_fn, params, adamw_init(params, opt), Data(),
                   TrainLoopConfig(total_steps=steps,
                                   checkpoint_every=ck_every,
                                   log_every=100,
                                   checkpoint_dir=str(tmp_path)))


class _FakeClock:
    """A host clock that advances 0.5 ms per read, and by the scripted
    time when a slow event sleeps: the watchdog then sees the script's
    stragglers and nothing of the machine's load."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 5e-4
        return self.t

    def sleep(self, s):
        self.t += s


def test_straggler_watchdog_via_fault_script(tmp_path, monkeypatch):
    """Scripted slow steps trip the watchdog a deterministic number of
    times."""
    from repro_torch.runtime import train_loop

    clock = _FakeClock()
    monkeypatch.setattr(train_loop, "time", clock)
    tr = _toy_trainer(tmp_path, steps=10)
    tr.step_fn(tr.params, tr.opt_state, torch.ones(4))   # warm up
    script = FaultScript([
        FaultEvent("slow", at_call=6, channel="step", count=2, factor=0.3),
    ], sleep=clock.sleep)
    tr.step_fn = script.wrap_step(tr.step_fn)
    tr.run()
    assert tr.step == 10
    assert tr.straggler_events == 2
    assert script.calls("step") == 10
    assert len(script.fired) == 2


def test_sigterm_via_fault_script_checkpoints_and_exits(tmp_path):
    """A scripted SIGTERM on step k, delivered through an injected kill:
    the loop finishes the in-flight step, writes the final checkpoint and
    exits cleanly at step k."""
    kills = []

    def kill(pid, sig):
        kills.append((pid, sig))
        os.kill(pid, sig)

    tr = _toy_trainer(tmp_path, steps=10_000)
    script = FaultScript([FaultEvent("signal", at_call=5,
                                     signum=int(signal.SIGTERM))],
                         kill=kill)
    tr.step_fn = script.wrap_step(tr.step_fn)
    tr.run()
    assert kills == [(os.getpid(), int(signal.SIGTERM))]
    assert tr._preempted
    assert tr.step == 5
    assert tr.ckpt.latest_valid_step() == 5


def test_wrap_step_records_kills_when_injected():
    kills = []
    script = FaultScript([FaultEvent("signal", at_call=2)],
                         kill=lambda pid, sig: kills.append((pid, sig)))
    step = script.wrap_step(lambda: "ok")
    assert step() == "ok" and step() == "ok"
    assert kills == [(os.getpid(), int(signal.SIGTERM))]
