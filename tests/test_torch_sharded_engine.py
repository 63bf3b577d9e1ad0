"""The mesh-aware engine against the JAX package's sharded compile, on the
CPU.

The port's side runs in a world of 4 gloo ranks, each a subprocess with a
``file://`` rendezvous in the test's temporary directory (no TCP port to
clash between pytest workers).  Each rank takes its shard of the batch
(``shard_batch``) and writes its output shard; the shards put together
must agree with the JAX package's ``compile_network`` on a 4-device host
mesh (a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count
=4``, its engine on ``iom_phase``) and with the port's unsharded engine,
at 1e-4 of max |y| (f32 sums in another order).  Both packages read the
same numpy inputs and weights from an ``.npz`` the test writes.

Cases: a data-parallel chain (reduced DCGAN, 4 x 1 mesh), the
data-parallel V-Net graph (4 x 1), the reference test's V-Net-shaped chain
channel-sharded on a 2 x 2 mesh (its ``collective_bytes`` per layer equal
to the reference report's and to the bytes each rank handed
``dist.all_reduce`` / ``dist.all_gather``, counted by a wrapper), and the
reduced DCGAN chain with ReLU epilogues on the 2 x 2 mesh, whose psum
layers take the deferred-epilogue branch.

Every subprocess has a time limit: a rank that hangs in a rendezvous or a
collective fails its test after at most ``RANK_TIMEOUT`` s (the whole
world normally takes ~10 s here) instead of running the suite into its
own limit.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    EngineConfig,
    MeshPolicy,
    ScheduleError,
    UniformEngine,
    compile_network,
    networks,
)
from repro_torch.sharding.mesh import Mesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
# ranks and the JAX side each finish in ~10-20 s on an idle CPU; 240 s
# leaves room for a loaded machine and still fails a hang well inside the
# suite's limit
RANK_TIMEOUT = 240
TOL = 1e-4

RANK_PRELUDE = """
import sys, json
from pathlib import Path
import numpy as np
import torch
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
torch.set_num_threads(1)
from repro_torch.launch import mesh as M
M.init_world("gloo", init_method=f"file://{OUT}/rendezvous",
             world_size=WORLD, rank=RANK, timeout_s=120)
"""


def run_world(out: Path, world: int, body: str) -> None:
    """Run ``body`` on ``world`` gloo ranks (subprocesses), each seeing
    ``RANK``, ``WORLD``, ``OUT`` and ``M`` (``launch.mesh``); fails on a
    rank's error or after ``RANK_TIMEOUT`` s."""
    script = out / "rank.py"
    script.write_text(RANK_PRELUDE + textwrap.dedent(body)
                      + "\nM.leave_world()\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = _wait_all(procs)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def run_jax(out: Path, devices: int, body: str) -> subprocess.Popen:
    """Start ``body`` in a JAX subprocess with ``devices`` host devices
    (``OUT`` is ``out``); ``_wait_all`` collects it."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    script = out / "jax_side.py"
    script.write_text(f"from pathlib import Path\nOUT = Path({str(out)!r})\n"
                      + textwrap.dedent(body))
    return subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait_all(procs) -> list[str]:
    logs, deadline = [], time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs += [p.communicate()[0] for p in procs[len(logs):]]
        pytest.fail(f"a subprocess ran over {RANK_TIMEOUT} s:\n"
                    + "\n".join(logs))
    return logs


# the cases both sides build: each chain's layers from its own package
CASES_SRC = """
import dataclasses

def cases(nets):
    dcgan = nets.scale_channels(nets.dcgan(), div=32)
    relu = nets.Epilogue(activation="relu")
    dcgan_relu = [dataclasses.replace(l, epilogue=relu) for l in dcgan]
    layers = nets.conv_stack("vnet", (8, 8, 8), [(1, 4), (4, 8), (8, 16)])
    sp = layers[-1].out_spatial
    for i, (ci, co) in enumerate([(16, 8), (8, 4)]):
        layers.append(nets.UniformLayer(
            name=f"vnet.up{i + 1}", in_spatial=sp, cin=ci, cout=co,
            kernel=(3,) * 3, stride=(2,) * 3, padding=((0, 1),) * 3,
            op="deconv"))
        sp = layers[-1].out_spatial
    graph = nets.vnet_graph(in_spatial=(8, 8, 8), chans=(2, 4, 8), cin=1)
    # name -> (network, model axis size, min_channel_block)
    return {"dp_chain": (dcgan, 1, 8), "dp_graph": (graph, 1, 8),
            "mp_chain": (layers, 2, 2), "mp_relu": (dcgan_relu, 2, 2)}
"""

PORT_BODY = CASES_SRC + """
from repro_torch.core import (EngineConfig, MeshPolicy, UniformEngine,
                              compile_network, networks, shard_batch)
import torch.distributed as dist

inputs = np.load(OUT / "inputs.npz")
sent = []                      # bytes handed to each collective, in order
for name in ("all_reduce", "all_gather"):
    def counted(*a, _real=getattr(dist, name), _kind=name, **kw):
        t = a[1] if _kind == "all_gather" else a[0]
        sent.append([_kind, t.numel() * t.element_size()])
        return _real(*a, **kw)
    setattr(dist, name, counted)
meshes = {1: M.make_host_mesh(model=1), 2: M.make_host_mesh(model=2)}
result = {}
for name, (net, mp, block) in cases(networks).items():
    mesh = meshes[mp]
    eng = UniformEngine(EngineConfig(
        device="cpu", mesh=mesh, policy=MeshPolicy(
            model_axis="model" if mp > 1 else None,
            min_channel_block=block)))
    fn, report = compile_network(net, eng, batch=4)
    x = torch.from_numpy(inputs[name + "/x"])
    if isinstance(net, networks.UniformGraph):
        ws = {l.name: torch.from_numpy(inputs[f"{name}/w/{l.name}"])
              for l in net.layers}
    else:
        ws = [torch.from_numpy(inputs[f"{name}/w/{i}"])
              for i in range(len(net))]
    del sent[:]
    y = fn(ws, shard_batch(x, mesh))
    np.save(OUT / f"{name}.rank{RANK}.npy", y.numpy())
    result[name] = {
        "coords": mesh.coords, "sent": list(sent),
        "data_parallel": report.data_parallel,
        "model_parallel": report.model_parallel,
        "per_device_batch": report.per_device_batch,
        "kernel_launches": report.kernel_launches,
        "rows": [[r.name, r.local_cin, r.local_cout, r.collective,
                  r.collective_bytes] for r in report.layers]}
(OUT / f"port.rank{RANK}.json").write_text(json.dumps(result))
"""

JAX_BODY = CASES_SRC + """
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.core import (EngineConfig, MeshPolicy, UniformEngine,
                        compile_network, networks)
from repro.launch.mesh import make_host_mesh

inputs = np.load(OUT / "inputs.npz")
meshes = {1: make_host_mesh(model=1), 2: make_host_mesh(model=2)}
result = {}
for name, (net, mp, block) in cases(networks).items():
    eng = UniformEngine(EngineConfig(
        method="iom_phase", mesh=meshes[mp], policy=MeshPolicy(
            model_axis="model" if mp > 1 else None,
            min_channel_block=block)))
    fn, report = compile_network(net, eng, batch=4)
    x = jnp.asarray(inputs[name + "/x"])
    if isinstance(net, networks.UniformGraph):
        ws = {l.name: jnp.asarray(inputs[f"{name}/w/{l.name}"])
              for l in net.layers}
    else:
        ws = [jnp.asarray(inputs[f"{name}/w/{i}"]) for i in range(len(net))]
    np.save(OUT / f"{name}.jax.npy", np.asarray(jax.jit(fn)(ws, x)))
    result[name] = {
        "data_parallel": report.data_parallel,
        "model_parallel": report.model_parallel,
        "rows": [[r.name, r.local_cin, r.local_cout, r.collective,
                  r.collective_bytes] for r in report.layers]}
(OUT / "jax.json").write_text(json.dumps(result))
"""


def _cases():
    namespace = {}
    exec(CASES_SRC, namespace)
    return namespace["cases"](networks)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides run once for the module; each test reads their files."""
    out = tmp_path_factory.mktemp("sharded")
    rng = np.random.RandomState(0)
    arrays = {}
    for name, (net, _, _) in _cases().items():
        layers = (net.layers if isinstance(net, networks.UniformGraph)
                  else net)
        first = layers[0]
        arrays[name + "/x"] = (0.3 * rng.randn(
            4, *first.in_spatial, first.cin)).astype(np.float32)
        for i, l in enumerate(layers):
            key = l.name if isinstance(net, networks.UniformGraph) else i
            arrays[f"{name}/w/{key}"] = (rng.randn(*l.weight_shape) / np.sqrt(
                np.prod(l.weight_shape[:-1]))).astype(np.float32)
    np.savez(out / "inputs.npz", **arrays)
    jax_proc = run_jax(out, WORLD, JAX_BODY)
    run_world(out, WORLD, PORT_BODY)
    log, = _wait_all([jax_proc])
    assert jax_proc.returncode == 0, log
    ranks = [json.loads((out / f"port.rank{r}.json").read_text())
             for r in range(WORLD)]
    return out, arrays, ranks, json.loads((out / "jax.json").read_text())


def _assembled(out: Path, name: str, ranks) -> np.ndarray:
    """The ranks' output shards put back together: batch blocks in data
    order (model-axis replicas hold the same block)."""
    blocks = {}
    for r, res in enumerate(ranks):
        blocks.setdefault(res[name]["coords"]["data"],
                          np.load(out / f"{name}.rank{r}.npy"))
    return np.concatenate([blocks[k] for k in sorted(blocks)])


def _unsharded(name: str, arrays) -> np.ndarray:
    net = _cases()[name][0]
    fn, _ = compile_network(net, UniformEngine(device="cpu"))
    x = torch.from_numpy(arrays[name + "/x"])
    if isinstance(net, networks.UniformGraph):
        ws = {l.name: torch.from_numpy(arrays[f"{name}/w/{l.name}"])
              for l in net.layers}
    else:
        ws = [torch.from_numpy(arrays[f"{name}/w/{i}"])
              for i in range(len(net))]
    with torch.inference_mode():
        return fn(ws, x).numpy()


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("name", ["dp_chain", "dp_graph", "mp_chain",
                                  "mp_relu"])
def test_sharded_output_matches_reference_and_unsharded(runs, name):
    out, arrays, ranks, ref = runs
    got = _assembled(out, name, ranks)
    _close(got, np.load(out / f"{name}.jax.npy"), "vs the JAX package")
    _close(got, _unsharded(name, arrays), "vs the unsharded engine")
    if name.startswith("mp"):
        # the model-axis replicas of a batch block hold the same output
        for r, res in enumerate(ranks):
            if res[name]["coords"]["model"] == 1:
                np.testing.assert_array_equal(
                    np.load(out / f"{name}.rank{r}.npy"),
                    np.load(out / f"{name}.rank{r - 1}.npy"))


@pytest.mark.parametrize("name", ["dp_chain", "dp_graph", "mp_chain",
                                  "mp_relu"])
def test_report_rows_match_the_reference(runs, name):
    """Per-rank channels, collectives and their bytes, row for row, and
    the mesh extents; one kernel launch per layer node per rank."""
    _, _, ranks, ref = runs
    for res in ranks:
        assert res[name]["rows"] == ref[name]["rows"]
        assert (res[name]["data_parallel"], res[name]["model_parallel"]) \
            == (ref[name]["data_parallel"], ref[name]["model_parallel"])
        net = _cases()[name][0]
        n_layers = len(net.layers if isinstance(net, networks.UniformGraph)
                       else net)
        assert res[name]["kernel_launches"] == n_layers
        assert res[name]["per_device_batch"] == \
            4 // res[name]["data_parallel"]


@pytest.mark.parametrize("name", ["dp_chain", "dp_graph", "mp_chain",
                                  "mp_relu"])
def test_collective_bytes_are_the_bytes_moved(runs, name):
    """Each rank handed its collectives exactly the payloads its report
    lists, in layer order; data parallelism moves no activation."""
    _, _, ranks, _ = runs
    for res in ranks:
        want = [[kind, nbytes] for _, _, _, kind, nbytes in res[name]["rows"]
                if kind]
        got = [["psum" if k == "all_reduce" else k, n]
               for k, n in res[name]["sent"]]
        assert got == want
    if name.startswith("mp"):
        assert any(r[3] == "psum" for r in ranks[0][name]["rows"])
    else:
        assert ranks[0][name]["sent"] == []


# -- the reference's error cases ----------------------------------------------

def _layout(data=2, model=2):
    return Mesh((data, model), ("data", "model"))


def test_engine_config_validates_mesh_axes():
    mesh = _layout()
    with pytest.raises(ValueError, match="batch_axis"):
        EngineConfig(device="cpu", mesh=mesh,
                     policy=MeshPolicy(batch_axis="bogus"))
    with pytest.raises(ValueError, match="model_axis"):
        EngineConfig(device="cpu", mesh=mesh,
                     policy=MeshPolicy(model_axis="bogus"))
    with pytest.raises(ValueError, match="batch shards"):
        EngineConfig(device="cpu", mesh=mesh,
                     policy=MeshPolicy(model_axis="data"))
    cfg = EngineConfig(device="cpu", mesh=mesh,
                       policy=MeshPolicy(model_axis="model"))
    assert cfg.mesh is mesh


def test_compile_batch_must_divide_the_data_axis():
    layers = networks.deconv_stack("demo", 2, 4, [8, 4])
    eng = UniformEngine(EngineConfig(device="cpu", mesh=_layout(model=1)))
    _, report = compile_network(layers, eng, batch=4)
    assert report.per_device_batch == 2 and report.batch == 4
    with pytest.raises(ScheduleError, match="does not divide"):
        compile_network(layers, eng, batch=3)
    with pytest.raises(ScheduleError, match="does not divide"):
        compile_network(networks.chain_graph(layers), eng, batch=3)


def test_shard_batch_needs_a_divisible_batch():
    from repro_torch.core import shard_batch
    mesh = Mesh((2, 2), ("data", "model"), rank=3)
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(shard_batch(x, mesh), x[2:])
    assert torch.equal(shard_batch({"a": x}, mesh)["a"], x[2:])
    with pytest.raises(ScheduleError, match="does not divide"):
        shard_batch(x[:3], mesh)


def test_quantized_entries_refused_on_a_channel_sharded_chain():
    layers = networks.deconv_stack("demo", 2, 4, [16, 16, 16, 4])
    eng = UniformEngine(EngineConfig(
        device="cpu", mesh=_layout(),
        policy=MeshPolicy(model_axis="model", min_channel_block=2)))
    fn, _ = compile_network(layers, eng, batch=2)
    entry = {"w_q": torch.zeros(3, 3, 16, 16, dtype=torch.int8),
             "scale": torch.ones(16)}
    with pytest.raises(ScheduleError, match="bare weight arrays"):
        fn([entry] * 3, torch.zeros(1, 4, 4, 16))
    with pytest.raises(ScheduleError, match="expected 3 weight arrays"):
        fn([torch.zeros(3, 3, 16, 16)] * 2, torch.zeros(1, 4, 4, 16))
