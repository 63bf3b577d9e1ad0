"""The data-parallel trainer and its int8 gradient compression against the
JAX package, on the CPU.

The port's side runs in gloo worlds of 4 and 2 ranks (subprocesses, a
``file://`` rendezvous in the test's temporary directory), the JAX side in
one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(its GAN step on a 2-device sub-mesh, its engine on ``iom_phase``).  Both
read the same numpy inputs from an ``.npz`` the test writes.

  * ``psum_int8`` and ``psum_int8_tree`` on 4 ranks, from the same
    per-rank gradients and error states: the reduced tree and the new
    error states within 1e-6 (the same int8 arithmetic; f32 sums of four
    values in another order);
  * the first step of ``make_dp_gan_train_step`` (reduced DCGAN, 2 ranks,
    f32 all-reduce): losses at 1e-4 relative, and the reduced gradients
    (AdamW's first moment after one step, ``(1 - b1) * g``) at 1e-4 of
    each leaf's max;
  * int8 against f32 all-reduce after 3 steps: losses within 5e-2, the
    reference test's bound (``tests/test_sharded_engine.py``), params
    moved and equal on both ranks after every step;
  * the bytes each DP step hands ``dist.all_reduce``: the int8 path's
    int32 sum is 4 B per element, as the f32 mean's;
  * the toy regression of ``make_dp_train_step`` converging (4 ranks, 150
    steps), as ``tests/test_sharded_engine.py::
    test_dp_lm_trainer_still_converges``;
  * an elastic restore: rank 0 of 4 saves, 2 ranks restore their blocks.

Subprocess time limits: ``RANK_TIMEOUT`` (240 s) per world and for the
JAX side, which each take ~10-25 s on an idle CPU: a hung rendezvous or
collective fails its test rather than the suite's own limit.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime import dp_trainer as JDP  # noqa: E402
from repro_torch import obs, tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import dcnn as TD  # noqa: E402
from repro_torch.runtime import dp_trainer as TDP  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
RANK_TIMEOUT = 240
GAN_BATCH = 4
GAN_STEPS = 3

RANK_PRELUDE = """
import sys, json
from pathlib import Path
import numpy as np
import torch
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
torch.set_num_threads(1)
from repro_torch.launch import mesh as M
from repro_torch.sharding import mesh as SM
M.init_world("gloo", init_method=f"file://{OUT}/rendezvous{WORLD}",
             world_size=WORLD, rank=RANK, timeout_s=120)
inputs = np.load(OUT / "inputs.npz")
"""


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


def start_world(out: Path, world: int, body: str) -> list:
    """Start ``body`` on ``world`` gloo ranks (subprocesses), each seeing
    ``RANK``, ``WORLD``, ``OUT``, ``inputs``, ``M`` (``launch.mesh``) and
    ``SM`` (``sharding.mesh``)."""
    script = out / f"rank{world}.py"
    script.write_text(RANK_PRELUDE + textwrap.dedent(body)
                      + "\nM.leave_world()\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(script), str(r),
                              str(world), str(out)], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish(procs) -> None:
    logs = _wait_all(procs)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


WORLD4 = """
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.compress import psum_int8, psum_int8_tree
from repro_torch.runtime import dp_trainer as DP
from repro_torch.core import shard_batch

mesh = M.make_host_mesh()
group = mesh.group("data")

def mine(prefix):
    return {"a": torch.from_numpy(inputs[f"{prefix}/a"][RANK]),
            "b": [torch.from_numpy(inputs[f"{prefix}/b0"][RANK]),
                  torch.from_numpy(inputs[f"{prefix}/b1"][RANK])]}

red, err = psum_int8_tree(mine("g"), group, mine("e"))
one = psum_int8(torch.from_numpy(inputs["g/a"][RANK]), group)
np.savez(OUT / f"compress.rank{RANK}.npz",
         **{f"red{i}": t.numpy() for i, t in enumerate(tree.leaves(red))},
         **{f"err{i}": t.numpy() for i, t in enumerate(tree.leaves(err))},
         one=one.numpy())

# the toy regression: each rank regresses its 16 rows of A
A, y = torch.from_numpy(inputs["toy/A"]), torch.from_numpy(inputs["toy/y"])
rows = shard_batch((A, y), mesh)
losses = {}
for compress in (False, True):
    params = {"w": torch.zeros(16)}
    opt = AdamWConfig(lr=0.05, weight_decay=0.0)
    state = adamw_init(params, opt)
    err = DP.init_error_state(params, mesh.shape["data"])
    step = DP.make_dp_train_step(
        lambda p, b: torch.mean((b[0] @ p["w"] - b[1]) ** 2), opt, mesh,
        compress=compress)
    for _ in range(150):
        params, state, err, loss = step(params, state, err, rows)
    losses[str(compress)] = float(loss)

# rank 0 saves full tensors for the elastic restore
cfg = get_config("dcgan").reduced()
if RANK == 0:
    ck = Checkpointer(OUT / "ckpt", async_save=False)
    ck.save(3, {"x": torch.arange(64.0).reshape(8, 8),
                "params": ST.real_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu")})
torch.distributed.barrier()
(OUT / f"world4.rank{RANK}.json").write_text(json.dumps(
    {"losses": losses, "coords": mesh.coords}))
"""

WORLD2 = """
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import UniformEngine, shard_batch
from repro_torch.launch import steps as ST
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import dp_trainer as DP

mesh = M.make_host_mesh()
group = mesh.group("data")
cfg = get_config("dcgan").reduced()
opt = AdamWConfig(lr=2e-3, weight_decay=0.0)
batch = shard_batch({"z": torch.from_numpy(inputs["gan/z"]),
                     "real": torch.from_numpy(inputs["gan/real"])}, mesh)
engine = UniformEngine(device="cpu")

def checksum(p):
    return torch.stack([torch.stack([t.double().sum(), t.double().abs().sum()])
                        for t in tree.leaves(p)])

out = {}
for compress in (False, True):
    p0 = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = p0
    o = (adamw_init(p["gen"], opt), adamw_init(p["disc"], opt))
    err = DP.init_error_state(p, mesh.shape["data"])
    step = ST.make_dp_gan_train_step(cfg, opt, mesh, engine=engine,
                                     compress=compress)
    log, same, sent = [], [], []
    real_all_reduce = torch.distributed.all_reduce
    for i in range(GAN_STEPS):
        # the bytes of every tensor the step hands dist.all_reduce
        nbytes = []
        def counted(t, *a, **kw):
            nbytes.append(t.numel() * t.element_size())
            return real_all_reduce(t, *a, **kw)
        torch.distributed.all_reduce = counted
        try:
            p, o, err, m = step(p, o, err, batch)
        finally:
            torch.distributed.all_reduce = real_all_reduce
        sent.append(sum(nbytes))
        log.append({k: float(v) for k, v in m.items()})
        sums = checksum(p)
        same.append(bool(torch.equal(SM.all_reduce(sums, group, "max"),
                                     SM.all_reduce(sums, group, "min"))))
        if i == 0 and not compress:
            first_m = [t.numpy() for s in o for t in tree.leaves(s.m)]
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree.leaves(p0), tree.leaves(p)))
    out[str(compress)] = {"log": log, "same": same, "moved": moved,
                          "sent": sent}
np.savez(OUT / f"gan.rank{RANK}.npz",
         **{f"m{i}": a for i, a in enumerate(first_m)})

# elastic restore: the checkpoint rank 0 of 4 wrote, onto 2 ranks
ck = Checkpointer(OUT / "ckpt", async_save=False)
template = {"x": torch.zeros(8, 8),
            "params": ST.real_params(cfg, torch.Generator().manual_seed(1),
                                     "cpu")}
got = ck.restore(3, template,
                 specs={"x": ("batch", None), "params": ST.param_axes(cfg)},
                 mesh=mesh)
by_model = M.make_host_mesh(model=2)
got_mp = ck.restore(3, template,
                    specs={"x": ("data", "model"),
                           "params": ST.param_axes(cfg)}, mesh=by_model)
np.savez(OUT / f"restore.rank{RANK}.npz", x=got["x"].numpy(),
         x_mp=got_mp["x"].numpy(),
         **{f"p{i}": t.numpy() for i, t in enumerate(tree.leaves(got["params"]))},
         **{f"pm{i}": t.numpy()
            for i, t in enumerate(tree.leaves(got_mp["params"]))})
out["coords"] = mesh.coords
(OUT / f"world2.rank{RANK}.json").write_text(json.dumps(out))
""".replace("GAN_STEPS", str(GAN_STEPS))

JAX_SIDE = """
import json
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config
from repro.core import UniformEngine
from repro.launch import steps as ST
from repro.optim import AdamWConfig, adamw_init
from repro.optim.compress import psum_int8, psum_int8_tree
from repro.runtime import dp_trainer as DP
from repro.sharding.compat import shard_map_norep

OUT = Path(OUT)
inputs = np.load(OUT / "inputs.npz")
tm = jax.tree_util.tree_map

def stacked(prefix):
    return {"a": jnp.asarray(inputs[f"{prefix}/a"]),
            "b": [jnp.asarray(inputs[f"{prefix}/b0"]),
                  jnp.asarray(inputs[f"{prefix}/b1"])]}

mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))

def local(g, e):
    g, e = tm(lambda a: a[0], g), tm(lambda a: a[0], e)
    red, err = psum_int8_tree(g, "data", e)
    return red, tm(lambda a: a[None], err), psum_int8(g["a"], "data")

red, err, one = jax.jit(shard_map_norep(
    local, mesh=mesh4, in_specs=(P("data"), P("data")),
    out_specs=(P(), P("data"), P())))(stacked("g"), stacked("e"))
np.savez(OUT / "compress.jax.npz",
         **{f"red{i}": np.asarray(a)
            for i, a in enumerate(jax.tree_util.tree_leaves(red))},
         **{f"err{i}": np.asarray(a)
            for i, a in enumerate(jax.tree_util.tree_leaves(err))},
         one=np.asarray(one))

# the first dp GAN step, f32 all-reduce, on 2 devices
cfg = get_config("dcgan").reduced()
shapes, _ = ST.abstract_params(cfg)
leaves, treedef = jax.tree_util.tree_flatten(shapes)
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(inputs[f"params/{i}"]) for i in range(len(leaves))])
opt = AdamWConfig(lr=2e-3, weight_decay=0.0)
mesh2 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
step = ST.make_dp_gan_train_step(cfg, opt, mesh2,
                                 engine=UniformEngine(method="iom_phase"),
                                 compress=False)
o = (adamw_init(params["gen"], opt), adamw_init(params["disc"], opt))
p, o, err, m = step(params, o, DP.init_error_state(params, 2),
                    {"z": jnp.asarray(inputs["gan/z"]),
                     "real": jnp.asarray(inputs["gan/real"])})
np.savez(OUT / "gan.jax.npz",
         **{f"m{i}": np.asarray(a) for i, a in enumerate(
             jax.tree_util.tree_leaves([s.m for s in o]))})
(OUT / "gan.jax.json").write_text(json.dumps(
    {k: float(v) for k, v in m.items()}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b0": (7,), "b1": (2, 2, 2)}
    arrays = {}
    for k, sh in shapes.items():
        arrays[f"g/{k}"] = rng.randn(4, *sh).astype(np.float32)
        arrays[f"e/{k}"] = (0.01 * rng.randn(4, *sh)).astype(np.float32)
    A = rng.randn(64, 16).astype(np.float32)
    arrays["toy/A"] = A
    arrays["toy/y"] = A @ rng.randn(16).astype(np.float32)
    cfg = get_config("dcgan").reduced()
    last = TD._scaled_layers(cfg)[-1]
    arrays["gan/z"] = rng.randn(GAN_BATCH, cfg.dcnn_z).astype(np.float32)
    arrays["gan/real"] = (0.3 * rng.randn(
        GAN_BATCH, *last.out_spatial, last.cout)).astype(np.float32)
    params = TS.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for i, t in enumerate(tree.leaves(params)):
        arrays[f"params/{i}"] = t.numpy()
    np.savez(out / "inputs.npz", **arrays)

    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", f"OUT = {str(out)!r}\n" + JAX_SIDE], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finish(start_world(out, 4, WORLD4))
    finish(start_world(out, 2, WORLD2))
    log, = _wait_all([jax_proc])
    assert jax_proc.returncode == 0, log
    return out, arrays


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def test_psum_int8_tree_matches_the_reference(runs):
    out, _ = runs
    ref = np.load(out / "compress.jax.npz")
    for r in range(4):
        got = np.load(out / f"compress.rank{r}.npz")
        for i in range(3):
            np.testing.assert_allclose(got[f"red{i}"], ref[f"red{i}"],
                                       rtol=0, atol=1e-6)
            # the reference's error state is [n_data, ...]: this rank's row
            np.testing.assert_allclose(got[f"err{i}"], ref[f"err{i}"][r],
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["one"], ref["one"], rtol=0, atol=1e-6)


def test_error_feedback_keeps_the_residual(runs):
    """new error = (g + e) - dequantized(g + e): below half a quantum."""
    out, arrays = runs
    for r in range(4):
        got = np.load(out / f"compress.rank{r}.npz")
        g32 = arrays["g/a"][r] + arrays["e/a"][r]
        quantum = np.abs(g32).max() / 127.0
        assert np.abs(got["err0"]).max() <= 0.5 * quantum * (1 + 1e-6)
        assert np.abs(got["err0"]).max() > 0


def test_first_dp_gan_step_matches_the_reference(runs):
    out, _ = runs
    ref = json.loads((out / "gan.jax.json").read_text())
    want_m = np.load(out / "gan.jax.npz")
    for r in range(2):
        res = json.loads((out / f"world2.rank{r}.json").read_text())
        first = res["False"]["log"][0]
        for k, v in ref.items():
            assert abs(first[k] - v) <= 1e-4 * abs(v), (k, first[k], v)
        got_m = np.load(out / f"gan.rank{r}.npz")
        assert len(got_m.files) == len(want_m.files) > 0
        for i in range(len(want_m.files)):
            assert _rel(got_m[f"m{i}"], want_m[f"m{i}"]) <= 1e-4, i


def test_int8_tracks_the_f32_all_reduce(runs):
    out, _ = runs
    for r in range(2):
        res = json.loads((out / f"world2.rank{r}.json").read_text())
        for compress in ("False", "True"):
            run = res[compress]
            assert len(run["log"]) == GAN_STEPS
            assert all(np.isfinite(v) for m in run["log"] for v in m.values())
            assert run["moved"] > 0.0
            # every rank applies the same update
            assert all(run["same"]), run["same"]
        for k in ("g_loss", "d_loss"):
            assert abs(res["True"]["log"][-1][k]
                       - res["False"]["log"][-1][k]) < 5e-2, res


def test_dp_step_hands_the_all_reduce_its_payload(runs):
    """What a DP GAN step hands ``dist.all_reduce``, counted per step: the
    f32 mean's gradients at 4 B per element, the int8 path's int32 sum at
    4 B per element too plus one f32 scale per leaf, and one f32 per
    loss.  ``grad_wire_bytes`` models the reference's int8 wire (1 B per
    element), which the port does not send."""
    out, _ = runs
    params = TS.real_params(get_config("dcgan").reduced(),
                            torch.Generator().manual_seed(0), "cpu")
    n = sum(int(t.numel()) for t in tree.leaves(params))
    leaves = len(tree.leaves(params))
    losses = 2
    want = {"False": 4 * n + 4 * losses,
            "True": 4 * n + 4 * leaves + 4 * losses}
    for r in range(2):
        res = json.loads((out / f"world2.rank{r}.json").read_text())
        for compress, nbytes in want.items():
            assert res[compress]["sent"] == [nbytes] * GAN_STEPS, compress
    modelled = TDP.grad_wire_bytes(params, compress=True)
    assert modelled["collective_bytes"] == n + 4 * leaves
    assert modelled["collective_bytes"] < want["True"]


def test_toy_regression_converges(runs):
    out, _ = runs
    for r in range(4):
        losses = json.loads((out / f"world4.rank{r}.json").read_text())[
            "losses"]
        assert losses["True"] < 1e-2, losses
        assert abs(losses["True"] - losses["False"]) < 5e-2, losses


def test_elastic_restore_onto_another_world(runs):
    """Saved by rank 0 of 4; restored by 2 ranks, each its own block of
    every leaf: the batch rows on a (2, 1) mesh, the conv weights' Cout
    halves on a (1, 2) mesh, the rest whole."""
    out, _ = runs
    x = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    cfg = get_config("dcgan").reduced()
    params = TS.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    axes = tree.leaves(TS.param_axes(cfg),
                       is_leaf=lambda a: isinstance(a, tuple))
    split = 0
    for r in range(2):
        got = np.load(out / f"restore.rank{r}.npz")
        np.testing.assert_array_equal(got["x"], x[4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(got["x_mp"], x[:, 4 * r:4 * (r + 1)])
        for i, (t, ax) in enumerate(zip(tree.leaves(params), axes)):
            full = t.numpy()
            # no leaf has a batch axis: the (2, 1) mesh leaves them whole
            np.testing.assert_array_equal(got[f"p{i}"], full)
            want = full
            if "model" in ax and full.shape[ax.index("model")] % 2 == 0:
                d = ax.index("model")
                n = full.shape[d] // 2
                want = np.take(full, range(r * n, (r + 1) * n), axis=d)
                split += 1
            np.testing.assert_array_equal(got[f"pm{i}"], want)
    assert split > 0


def test_grad_wire_bytes_match_the_reference():
    cfg = get_config("dcgan").reduced()
    params = TS.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = tree.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    for compress in (True, False):
        assert TDP.grad_wire_bytes(params, compress) == \
            JDP.grad_wire_bytes(jparams, compress)
    tel = obs.Telemetry.create()
    acct = TDP.record_dp_metrics(tel, params, compress=True, n_data=2)
    assert acct["compress_ratio"] > 3.9
    snap = tel.registry.snapshot()
    assert {k: v["value"] for k, v in snap.items()
            if k.startswith("dp_")} == {
        "dp_grads_bytes": acct["grads_bytes"],
        "dp_collective_bytes": acct["collective_bytes"],
        "dp_compress_ratio": acct["compress_ratio"],
        "dp_data_parallel": 2}


def test_error_state_rows_cross_over():
    """``init_error_state`` keeps the reference's leading ``[n_data]`` axis;
    a dp step reads and writes its rank's row alone."""
    cfg = get_config("dcgan").reduced()
    params = TS.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    err = TDP.init_error_state(params, 3)
    jerr = JDP.init_error_state(
        tree.tree_map(lambda t: jnp.asarray(t.numpy()), params), 3)
    assert [tuple(e.shape) for e in tree.leaves(err)] == \
        [tuple(e.shape) for e in jax.tree_util.tree_leaves(jerr)]
    rows = tree.tree_map(torch.ones_like, TDP.unstack_error(err, 1))
    TDP.stack_error(err, rows, 1)
    for e in tree.leaves(err):
        assert float(e[1].min()) == 1.0
        assert float(e[0].abs().max()) == float(e[2].abs().max()) == 0.0


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(argv, world: int = 2) -> list[str]:
    """``python -m repro_torch.launch.train argv`` on ``world`` gloo ranks
    that find each other through torchrun's variables; their outputs."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = _wait_all(procs)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


@pytest.mark.parametrize("arch", ["llama3.2-1b", "dcgan"])
def test_launcher_trains_on_a_model_axis(arch, tmp_path):
    """``--model-parallel 2`` on a gloo world of 2 ranks.  An LM trains
    partitioned over the model axis: rank 0 writes each checkpoint whole
    (the embedding's every row), and a second run resumes from it on the
    same world.  A DCNN's ``--dp`` steps run as the reference's launcher
    runs them on that mesh: a data axis of 1, so both ranks along the
    model axis take the same step on the same batch and end with the
    same parameters."""
    ck = tmp_path / "ck"
    argv = ["--arch", arch, "--reduced", "--device", "cpu",
            "--model-parallel", "2", "--checkpoint-dir", str(ck),
            "--checkpoint-every", "2"]
    if arch == "dcgan":
        logs = _launch(argv + ["--dp", "--steps", "2"])
        assert all("finished at step 2" in log for log in logs), logs
        from repro_torch.checkpoint import Checkpointer
        ranks = [Checkpointer(tmp_path / f"ck-dp/rank{r}") for r in (0, 1)]
        assert [c.latest_valid_step() for c in ranks] == [2, 2]
        d0, d1 = (tmp_path / f"ck-dp/rank{r}/step_00000002" for r in (0, 1))
        for leaf in sorted(d0.glob("leaf_*.npy")):
            np.testing.assert_array_equal(np.load(leaf),
                                          np.load(d1 / leaf.name))
        return
    lm = ["--batch", "4", "--seq", "16"]
    logs = _launch(argv + lm + ["--steps", "2"])
    assert all("partitioned LM: rank" in log and "finished at step 2" in
               log for log in logs), logs
    cfg = get_config(arch).reduced()
    manifest = json.loads((ck / "step_00000002/manifest.json").read_text())
    shapes = [tuple(m["shape"]) for m in manifest["leaves"]]
    assert (cfg.vocab, cfg.d_model) in shapes         # the embedding, whole
    logs = _launch(argv + lm + ["--steps", "3", "--resume"])
    assert all("resume: ok, step=2" in log and "finished at step 3" in log
               for log in logs), logs


def test_round_batch_to_mesh():
    cfg = get_config("dcgan")
    assert TS.round_batch_to_mesh(cfg, 4) is cfg
    assert TS.round_batch_to_mesh(cfg, 5).dcnn_batch == 65


@pytest.mark.parametrize("entry", ["launch.train", "train_dcgan",
                                    "segment_vnet3d"])
def test_entry_points_train_data_parallel(entry, tmp_path, capsys):
    """``--dp`` on the launcher and both training examples: without
    torchrun's variables the world is this process alone (gloo on the
    CPU), the steps run through the dp trainer, and the world is left
    again."""
    import torch.distributed as dist

    from repro_torch.examples import segment_vnet3d, train_dcgan
    from repro_torch.launch import train as launch_train
    ck = str(tmp_path / "ck")
    if entry == "launch.train":
        tr = launch_train.main(["--arch", "dcgan", "--reduced", "--steps",
                                "10", "--device", "cpu", "--dp",
                                "--checkpoint-dir", ck])
        losses = [v for r in tr.metrics_log for k, v in r.items()
                  if k.endswith("loss")]
        assert tr.step == 10 and tr.ckpt.latest_valid_step() == 10
        assert tr.ckpt.dir == tmp_path / "ck-dp"
    elif entry == "train_dcgan":
        tr = train_dcgan.main(["--device", "cpu", "--steps", "2", "--method",
                               "pallas", "--dp", "--no-dp-compress",
                               "--checkpoint-dir", ck])
        losses = [v for r in tr.metrics_log for k, v in r.items()
                  if k.endswith("loss")]
        assert tr.step == 2
    else:
        losses = segment_vnet3d.main(["--device", "cpu", "--steps", "2",
                                      "--method", "pallas", "--dp"])["losses"]
    out = capsys.readouterr().out
    assert "dp trainer:" in out
    assert losses and all(np.isfinite(v) for v in losses)
    assert not dist.is_initialized()
