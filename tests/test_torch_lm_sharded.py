"""The partitioned LM train step in gloo worlds of 2 and 4 ranks against
the unpartitioned port and the JAX package's sharded run, on the CPU.

The port's side runs as subprocesses (a ``file://`` rendezvous in the
test's temporary directory), the JAX side in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``; all three start
together.  Parameters come from the port's seeded ``real_params`` (each
rank draws them whole and keeps its blocks); the JAX side reads the same
leaves from an ``.npz`` (both packages flatten the tree in one order).

World of 2:
  * each required family's loss and gradients (f32; gathered whole)
    within 1e-5 of each leaf's max |g| of the unpartitioned port's: on a
    (1 x 2) mesh llama3.2-1b, qwen2-vl-2b (M-RoPE), granite-20b (its one
    KV head replicated), whisper-tiny (cross attention), dbrx-132b under
    ``moe_impl="shardmap"`` with one group (``moe``'s semantics) and
    under ``moe``, xlstm-350m (mLSTM and sLSTM) and zamba2-2.7b (Mamba-2
    and the shared block; also under ``save_outs``), and a vocab of 255
    (the table replicated, the plain cross-entropy); on a (2 x 1) mesh
    llama, granite and dbrx-132b (under ``moe``) with FSDP, whose
    stacked layer leaves are gathered a layer at a time;
  * ``save_outs`` against ``nothing``: bit-equal gradients, and exactly
    the forward's block-out all-reduces (two per layer) fewer;
  * 8-bit moments updated on blocks equal to the whole update's;
  * a checkpoint of a partitioned tree, written whole by rank 0.
World of 4, a (2 x 2) mesh:
  * reduced llama3.2-1b, three ``make_train_step`` steps (the reference's
    ``tests/test_distributed.py`` case): the f32 losses within 1e-5 of
    the JAX package's sharded run, the bf16 ones at the LM train tests'
    1e-2; the first step moves nothing (the warmup rate is 0);
  * ``moe_shardmap`` with four groups against ``moe_shardmap_plain``
    (output, load-balance term and gradients) and the reference's
    ``moe_shardmap`` (output and term);
  * the vocab-parallel cross-entropy against the whole logits' and the
    reference's ``_xent_vocab_parallel``;
  * the 2-rank checkpoint restored as each rank's blocks (and in this
    process, whole, on one).
"""

import dataclasses
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

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.sharding import mesh as SM  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 240
LR = 0.05
TOL = 1e-5
BF16_LOSS_TOL = 1e-2       # tests/test_torch_lm_train_steps.py's LOSS_TOL

COMMON = """
import sys, json, dataclasses, time
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sharding import mesh as SM
from repro_torch.sharding import partition as P
M.init_world("gloo", init_method=f"file://{OUT}/rendezvous{WORLD}",
             world_size=WORLD, rank=RANK, timeout_s=120)
inputs = np.load(OUT / "inputs.npz")
out = {}

def whole(t, spec, mesh):
    for d, e in enumerate(spec):
        if e is not None:
            t = SM.gather(t, mesh, P.spec_axes(e), d)
    return t

def whole_tree(t, specs, mesh):
    return [whole(x, s, mesh).numpy() for x, s in zip(
        tree.leaves(t), tree.leaves(specs, is_leaf=P.is_logical_leaf))]

def batch_of(cfg, prefix):
    b = {"tokens": torch.from_numpy(inputs[prefix + "tokens"]),
         "labels": torch.from_numpy(inputs[prefix + "labels"])}
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.from_numpy(inputs[prefix + "enc"])
    if cfg.mrope:
        b["mrope_positions"] = torch.from_numpy(inputs[prefix + "mrope"])
    return b
"""

WORLD2 = """
tp, dp = M.make_host_mesh(model=2), M.make_host_mesh(model=1)
for name, arch, mesh_name, over in json.loads(inputs["cases"].item()):
    mesh = tp if mesh_name == "tp" else dp
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh)
    specs = ST.param_specs(cfg, mesh)
    batch = ST.shard_lm_batch(batch_of(cfg, "b/"), mesh)
    gathered, real_gather = [], SM.gather

    def recorded(t, *a):
        gathered.append(list(t.shape))
        return real_gather(t, *a)
    SM.gather = recorded
    loss, met, grads = ST.lm_grads(params, cfg, batch,
                                   param_dtype=torch.float32, mesh=mesh,
                                   specs=specs)
    SM.gather = real_gather
    out[f"gathers.{name}"] = gathered
    g = whole_tree(grads, specs, mesh)
    if RANK == 0:
        np.savez(OUT / f"case.{name}.npz", loss=loss.numpy(),
                 aux=met["aux"].numpy(), **{f"g{i}": a for i, a in
                                            enumerate(g)})

# save_outs against nothing: the collectives of one step, and its grads
cfg = get_config("llama3_2_1b").reduced()
params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu", tp)
specs = ST.param_specs(cfg, tp)
batch = ST.shard_lm_batch(batch_of(cfg, "b/"), tp)
counts, got = {}, {}
for policy in ("nothing", "save_outs"):
    c = dataclasses.replace(cfg, remat_policy=policy)
    p = tree.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad(), P.use_mesh(tp):
        SM.reset_collective_stats()
        loss, _ = T.forward(p, c, batch, param_dtype=torch.float32)
        fwd = SM.collective_stats()
        SM.reset_collective_stats()
        grads = torch.autograd.grad(loss, tree.leaves(p))
        bwd = SM.collective_stats()
    counts[policy] = {
        phase: {"/".join([k[0], *k[1]]): v[0] for k, v in st.items()}
        for phase, st in (("forward", fwd), ("backward", bwd))}
    got[policy] = grads
out["counts"] = counts
out["save_outs_bits"] = all(torch.equal(a, b) for a, b in zip(
    tree.leaves(got["nothing"]), tree.leaves(got["save_outs"])))

# 8-bit moments: an update of the blocks against the whole update
cfg = dataclasses.replace(get_config("dbrx_132b").reduced(),
                          opt_state_bits=8)
opt = AdamWConfig(state_bits=8)
whole_p = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
gen = torch.Generator().manual_seed(5)
whole_g = tree.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                        whole_p)
specs = ST.param_specs(cfg, tp)
state0 = adamw_init(whole_p, opt)
want_p, want_s = adamw_update(whole_g, state0, whole_p, opt)
want_p, want_s = adamw_update(whole_g, want_s, want_p, opt)
ospecs = ST.opt_specs(cfg, tp, opt)
cut = lambda t, s: tree.tree_map(torch.Tensor.clone, P.shard_tree(t, s, tp))
p, s = cut(whole_p, specs), cut(state0, ospecs)
fns = ST.absmax_fns(specs, tp)
for _ in range(2):
    p, s = adamw_update(cut(whole_g, specs), s, p, opt, absmax=fns)
got = whole_tree(s, ospecs, tp)
out["int8_equal"] = all(np.array_equal(a, b.numpy()) for a, b in zip(
    got, tree.leaves(want_s)))
out["int8_params_equal"] = all(np.array_equal(a, b.numpy()) for a, b in zip(
    whole_tree(p, specs, tp), tree.leaves(want_p)))

# a checkpoint of the partitioned llama, written whole by rank 0
cfg = get_config("llama3_2_1b").reduced()
specs = ST.param_specs(cfg, tp)
params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu", tp)
state = adamw_init(params, AdamWConfig())
ck_specs = {"params": specs, "opt": ST.opt_specs(cfg, tp, AdamWConfig())}
ck = Checkpointer(OUT / "ckpt", async_save=True, specs=ck_specs, mesh=tp)
ck.save(7, {"params": params, "opt": state})
ck.wait()
out["saved_by"] = RANK
(OUT / f"world2.rank{RANK}.json").write_text(json.dumps(out))
"""

WORLD4 = """
mesh = M.make_host_mesh(model=2)
cfg = get_config("llama3_2_1b").reduced()
specs = ST.param_specs(cfg, mesh)
for dt in ("float32", "bfloat16"):
    step = ST.make_train_step(cfg, AdamWConfig(lr=LR), mesh)
    if dt == "float32":
        orig = ST.lm_grads
        ST.lm_grads = lambda *a, **k: orig(*a, **{**k, "param_dtype":
                                                 torch.float32})
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh)
    first = [t.clone() for t in tree.leaves(params)]
    state = adamw_init(params, AdamWConfig(lr=LR))
    losses = []
    for i in range(3):
        params, state, m = step(params, state, batch_of(cfg, f"s{i}/"))
        losses.append(float(m["loss"]))
        if i == 0:
            out["step1_still"] = all(torch.equal(a, b) for a, b in zip(
                first, tree.leaves(params)))
    if dt == "float32":
        ST.lm_grads = orig
    out[f"losses_{dt}"] = losses

# moe_shardmap, four groups, on the (2 x 2) mesh
cfg = dataclasses.replace(get_config("dbrx_132b").reduced(),
                          moe_impl="shardmap", moe_groups=4)
block = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
moe_p = tree.tree_map(lambda t: t[0], block["layers"]["moe"])
espec = TM.MoeParams((), ("model",), ("model",), ("model",))
local = tree.tree_map(lambda t: t.clone().requires_grad_(),
                      P.shard_tree(moe_p, espec, mesh))
x = torch.from_numpy(inputs["moe/x"])
xl = ST.shard_lm_batch({"x": x}, mesh)["x"]
with P.use_mesh(mesh):
    y, aux = TM.moe_shardmap(local, xl, cfg)
    w = ST.shard_lm_batch({"w": torch.from_numpy(inputs["moe/w"])}, mesh)
    obj = SM.reduce_from((y * w["w"]).sum(), mesh, mesh.batch_axes) + aux
    grads = torch.autograd.grad(obj, tree.leaves(local))
out["moe_y"] = whole(y.detach(), ("data",), mesh).numpy().tolist()
out["moe_aux"] = float(aux)
out["moe_obj"] = float(obj)
gspec = [(), ("model",), ("model",), ("model",)]
grads = [SM.psum(g, mesh, ("data",)) for g in grads]
out["moe_g"] = [whole(g, s, mesh).numpy().tolist()
                for g, s in zip(grads, gspec)]

# the vocab-parallel cross-entropy, chunks of 8 tokens
hf = torch.from_numpy(inputs["xe/h"])
lf = torch.from_numpy(inputs["xe/l"])
table = torch.from_numpy(inputs["xe/table"])
hl = ST.shard_lm_batch({"h": hf}, mesh)["h"].clone().requires_grad_()
ll = ST.shard_lm_batch({"l": lf}, mesh)["l"]
tl = P.local_block(table, ("model",), mesh).clone().requires_grad_()
xe = T._xent_vocab_parallel(mesh, hl, ll, tl, 8)
gh, gt = torch.autograd.grad(xe, (hl, tl))
out["xent"] = float(xe)
out["xent_gh"] = whole(gh, ("data",), mesh).numpy().tolist()
out["xent_gt"] = whole(SM.psum(gt, mesh, ("data",)), ("model",),
                       mesh).numpy().tolist()

# the 2-rank checkpoint, restored as this rank's blocks
deadline = time.monotonic() + 200
while not (OUT / "world2.rank0.json").exists():
    assert time.monotonic() < deadline, "no checkpoint from the 2 ranks"
    time.sleep(0.5)
cfg = get_config("llama3_2_1b").reduced()
params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu", mesh)
state = adamw_init(params, AdamWConfig())
ck_specs = {"params": specs, "opt": ST.opt_specs(cfg, mesh, AdamWConfig())}
template = tree.tree_map(torch.zeros_like, {"params": params, "opt": state})
got = Checkpointer(OUT / "ckpt", specs=ck_specs, mesh=mesh).restore(
    7, template)
out["restored_equal"] = all(torch.equal(a, b) for a, b in zip(
    tree.leaves(got), tree.leaves({"params": params, "opt": state})))
(OUT / f"world4.rank{RANK}.json").write_text(json.dumps(out))
""".replace("LR", repr(LR))

JAX_SIDE = """
import sys, json, dataclasses
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as Ps
OUT = Path(sys.argv[1])
from repro.configs import get_config
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import moe as JM, transformer as JT
from repro.optim import AdamWConfig, adamw_init, adamw_update
from repro.optim import cosine_schedule
from repro.sharding.partition import param_shardings
inputs = np.load(OUT / "inputs.npz")
mesh = make_host_mesh(model=2, data=2)
out = {}
cfg = get_config("llama3_2_1b").reduced()
shapes, logical = JS.abstract_params(cfg)
leaves = [inputs[f"llama/{i}"] for i in
          range(len(jax.tree_util.tree_leaves(shapes)))]
opt = AdamWConfig(lr=LR)
for dt, pdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
    def step(params, opt_state, batch):
        def loss_fn(p):
            return JT.forward(p, cfg, batch, mode="train", param_dtype=pdt)
        (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        lr = cosine_schedule(opt_state.step)
        p2, s2 = adamw_update(g, opt_state, params, opt, lr_scale=lr)
        return p2, s2, loss
    with mesh:
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shapes),
            [jnp.asarray(a) for a in leaves])
        shard = param_shardings(mesh, params, logical, cfg.fsdp)
        params = jax.tree_util.tree_map(jax.device_put, params, shard)
        state = adamw_init(params, opt)
        fn = jax.jit(step)
        losses = []
        for i in range(3):
            batch = {k: jax.device_put(jnp.asarray(inputs[f"s{i}/{k}"]),
                                       NamedSharding(mesh, Ps("data")))
                     for k in ("tokens", "labels")}
            params, state, loss = fn(params, state, batch)
            losses.append(float(loss))
    out[f"losses_{dt}"] = losses

mcfg = dataclasses.replace(get_config("dbrx_132b").reduced(),
                           moe_impl="shardmap", moe_groups=4)
mp = JM.MoeParams(*(jnp.asarray(inputs[f"moe/p{i}"]) for i in range(4)))
with mesh:
    y, aux = jax.jit(lambda p, x: JM.moe_shardmap(p, x, mcfg))(
        mp, jnp.asarray(inputs["moe/x"]))
out["moe_y"] = np.asarray(y).tolist()
out["moe_aux"] = float(aux)
with mesh:
    xe = jax.jit(lambda h, l, t: JT._xent_vocab_parallel(
        mesh, cfg, h, l, t, 8))(*(jnp.asarray(inputs[k]) for k in
                                  ("xe/h", "xe/l", "xe/table")))
out["xent"] = float(xe)
(OUT / "jax.json").write_text(json.dumps(out))
""".replace("LR", repr(LR))

# (name, arch, mesh, config overrides) of the world-of-2 gradient cases
F32 = {"master_dtype": "float32"}
CASES = [
    ("llama", "llama3_2_1b", "tp", {}),
    ("qwen2", "qwen2_vl_2b", "tp", {}),
    ("granite", "granite_20b", "tp", {}),
    ("whisper", "whisper_tiny", "tp", {}),
    ("dbrx_shardmap", "dbrx_132b", "tp", {"moe_groups": 1}),
    ("dbrx_moe", "dbrx_132b", "tp", {"moe_impl": "dense_scatter"}),
    ("arctic", "arctic_480b", "tp", {"moe_groups": 1, **F32}),
    ("vocab255", "llama3_2_1b", "tp", {"vocab": 255}),
    ("xlstm", "xlstm_350m", "tp", {}),
    ("zamba2", "zamba2_2_7b", "tp", {}),
    ("zamba2_save_outs", "zamba2_2_7b", "tp", {"remat_policy":
                                               "save_outs"}),
    ("llama_fsdp", "llama3_2_1b", "dp", {"fsdp": True}),
    ("granite_fsdp", "granite_20b", "dp", {"fsdp": True}),
    ("dbrx_fsdp", "dbrx_132b", "dp", {"fsdp": True,
                                      "moe_impl": "dense_scatter"}),
]


# the recurrent families amplify f32 rounding: parameters moved by one
# ulp of noise move their reduced gradients by 1.0e-5 (xlstm-350m) and
# 1.8e-5 (zamba2-2.7b) of a leaf's max |g| (llama3.2-1b: 1.7e-6), so
# their partitioned sums are held at their floor's order
FLOOR_TOL = {"xlstm": 1e-4, "zamba2": 1e-4, "zamba2_save_outs": 1e-4}


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _batch(cfg, rng, b=4, s=16):
    toks = rng.randint(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["enc"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        out["mrope"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(s, dtype=np.int64)[None, None], (3, b, s)))
    return out


def _spawn(cmd, env):
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    deadline, logs = time.monotonic() + TIMEOUT, []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a subprocess ran over {TIMEOUT} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_sharded")
    rng = np.random.RandomState(0)
    inputs = {"cases": np.array(json.dumps(CASES))}
    for k, v in _batch(get_config("qwen2_vl_2b").reduced(), rng).items():
        inputs[f"b/{k}"] = v
    inputs["b/enc"] = rng.standard_normal(
        (4, 16, 128)).astype(np.float32)          # whisper: enc_seq 16
    llama = get_config("llama3_2_1b").reduced()
    for i in range(3):
        toks = rng.randint(0, llama.vocab, (8, 65)).astype(np.int32)
        inputs[f"s{i}/tokens"], inputs[f"s{i}/labels"] = toks[:, :-1], \
            toks[:, 1:]
    params = ST.real_params(llama, torch.Generator().manual_seed(0), "cpu")
    for i, t in enumerate(tree.leaves(params)):
        inputs[f"llama/{i}"] = t.numpy()
    dbrx = _cfg("dbrx_132b", {})
    block = ST.real_params(dbrx, torch.Generator().manual_seed(0), "cpu")
    for i, t in enumerate(block["layers"]["moe"]):
        inputs[f"moe/p{i}"] = t[0].numpy()
    inputs["moe/x"] = rng.standard_normal((4, 16, 128)).astype(np.float32)
    inputs["moe/w"] = rng.standard_normal((4, 16, 128)).astype(np.float32)
    inputs["xe/h"] = rng.standard_normal((32, 128)).astype(np.float32)
    inputs["xe/l"] = rng.randint(0, 256, (32,)).astype(np.int64)
    inputs["xe/table"] = (0.1 * rng.standard_normal((256, 128))).astype(
        np.float32)
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for world, body in ((2, WORLD2), (4, WORLD4)):
        script = out / f"rank{world}.py"
        script.write_text(COMMON + textwrap.dedent(body)
                          + "\nM.leave_world()\n")
        procs += [_spawn([sys.executable, str(script), str(r), str(world),
                          str(out)], env) for r in range(world)]
    jscript = out / "jax_side.py"
    jscript.write_text(JAX_SIDE)
    procs.append(_spawn([sys.executable, str(jscript), str(out)], dict(
        env, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")))
    _wait(procs)
    res = {f"world{w}.rank{r}": json.loads(
        (out / f"world{w}.rank{r}.json").read_text())
        for w in (2, 4) for r in range(w)}
    res["jax"] = json.loads((out / "jax.json").read_text())
    return out, inputs, res


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_partitioned_gradients_match_one_process(runs, case):
    out, inputs, _ = runs
    _, arch, _, over = next(c for c in CASES if c[0] == case)
    cfg = _cfg(arch, over)
    got = np.load(out / f"case.{case}.npz")
    batch = {"tokens": torch.from_numpy(inputs["b/tokens"]),
             "labels": torch.from_numpy(inputs["b/labels"])}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(inputs["b/enc"])
    if cfg.mrope:
        batch["mrope_positions"] = torch.from_numpy(inputs["b/mrope"])
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    loss, met, grads = ST.lm_grads(params, cfg, batch,
                                   param_dtype=torch.float32)
    assert abs(float(got["loss"]) - float(loss)) <= TOL * abs(float(loss))
    assert abs(float(got["aux"]) - float(met["aux"])) <= \
        TOL * max(abs(float(met["aux"])), 1e-6)
    errs = [_rel(got[f"g{i}"], g.numpy())
            for i, g in enumerate(tree.leaves(grads))]
    assert max(errs) <= FLOOR_TOL.get(case, TOL), errs


def test_fsdp_gathers_a_layer_at_a_time(runs):
    """An FSDP step gathers each stacked layer leaf a layer at a time,
    where the layer loop takes it: inside the layer's remat, so in the
    forward and again in the backward's recompute, and no more than one
    layer is whole at once; every other FSDP leaf once, before the
    forward."""
    _, _, res = runs
    cfg = _cfg("llama3_2_1b", {"fsdp": True})
    mesh = SM.Mesh((2, 1), ("data", "model"), rank=0)
    specs = ST.param_specs(cfg, mesh)
    whole = ST.real_params(cfg, None, "meta")
    want = []
    for key in whole:
        for t, sp in zip(tree.leaves(whole[key]), tree.leaves(
                specs[key], is_leaf=TP.is_logical_leaf)):
            if not any("data" in TP.spec_axes(e) for e in sp):
                continue
            block = list(t[TP.block_index(mesh, sp, t.shape)].shape)
            want += ([block[1:]] * (2 * cfg.n_layers) if key == "layers"
                     else [block])
    assert cfg.n_layers > 1 and len(want) > 2 * cfg.n_layers
    assert sorted(res["world2.rank0"]["gathers.llama_fsdp"]) == \
        sorted(want)


def test_save_outs_repeats_no_block_all_reduce(runs):
    """Two block outputs per layer (attention, MLP), each summed over the
    model axis by one all-reduce in the forward.  Under ``nothing`` the
    backward runs each layer again up to the last value it needs, the
    attention's all-reduce included; ``save_outs`` keeps the outputs and
    runs none of them again, every other collective as ``nothing``'s,
    its gradients bit for bit ``nothing``'s."""
    _, _, res = runs
    r = res["world2.rank0"]
    nothing, saved = r["counts"]["nothing"], r["counts"]["save_outs"]
    layers = get_config("llama3_2_1b").reduced().n_layers
    key = "all_reduce_sum[blk_out]/model"
    assert nothing["forward"] == saved["forward"]
    assert saved["forward"][key] == 2 * layers
    assert key not in saved["backward"]
    # the remat of a layer stops at the last saved value it needs: the
    # attention's output (the MLP's input), not the MLP's
    assert nothing["backward"][key] == layers
    rest = lambda c: {k: v for k, v in c.items() if k != key}  # noqa: E731
    assert rest(nothing["backward"]) == rest(saved["backward"])
    assert r["save_outs_bits"]


def test_save_outs_matches_the_reference():
    """``save_outs`` in one process: the gradients bit for bit
    ``nothing``'s, and within 1e-5 of the reference's ``save_outs``."""
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(),
                              remat_policy="save_outs")
    jcfg = dataclasses.replace(jax_config("llama3_2_1b").reduced(),
                               remat_policy="save_outs")
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, g = ST.lm_grads(params, cfg, tb, param_dtype=torch.float32)
    _, _, g0 = ST.lm_grads(params, dataclasses.replace(
        cfg, remat_policy="nothing"), tb, param_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g),
                                                 tree.leaves(g0)))
    from repro.launch import steps as JS
    jshapes, _ = JS.abstract_params(jcfg)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jshapes),
        [jnp.asarray(t.numpy()) for t in tree.leaves(params)])
    jg = jax.jit(jax.grad(lambda p, b: JT.forward(
        p, jcfg, b, mode="train", param_dtype=jnp.float32)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    errs = [_rel(a.numpy(), np.asarray(b)) for a, b in
            zip(tree.leaves(g), jax.tree_util.tree_leaves(jg))]
    assert max(errs) <= TOL, errs


def test_int8_moments_on_blocks_equal_the_whole(runs):
    """Two 8-bit AdamW updates of a (1 x 2) mesh's blocks of reduced
    dbrx-132b, each scale a MAX all-reduce of the blocks' maxima: the
    gathered moments and parameters equal the whole update's, bit for
    bit."""
    _, _, res = runs
    for r in (0, 1):
        assert res[f"world2.rank{r}"]["int8_equal"]
        assert res[f"world2.rank{r}"]["int8_params_equal"]


def test_three_sharded_steps_match_the_reference(runs):
    """Reduced llama3.2-1b on (2 data x 2 model), three steps: the f32
    losses within 1e-5 of the JAX package's sharded run, the bf16 ones
    within 1e-2; every rank reads the same loss; the first step leaves
    the parameters as they were."""
    _, _, res = runs
    want = res["jax"]
    for r in range(4):
        got = res[f"world4.rank{r}"]
        assert got["step1_still"]
        for dt, tol in (("float32", TOL), ("bfloat16", BF16_LOSS_TOL)):
            for a, b in zip(got[f"losses_{dt}"], want[f"losses_{dt}"]):
                assert abs(a - b) <= tol * abs(b), (dt, got, want)
    assert len({tuple(res[f"world4.rank{r}"]["losses_float32"])
                for r in range(4)}) == 1


def test_moe_shardmap_matches_plain_and_reference(runs):
    """``moe_shardmap`` with four token groups on (2 x 2): output,
    load-balance term and gradients against ``moe_shardmap_plain`` in one
    process, output and term against the reference's ``moe_shardmap``."""
    _, inputs, res = runs
    cfg = dataclasses.replace(get_config("dbrx_132b").reduced(),
                              moe_impl="shardmap", moe_groups=4)
    p = TM.MoeParams(*(torch.from_numpy(inputs[f"moe/p{i}"]).clone()
                       .requires_grad_() for i in range(4)))
    x = torch.from_numpy(inputs["moe/x"])
    y, aux = TM.moe_shardmap_plain(p, x, cfg, 2, 2)
    obj = (y * torch.from_numpy(inputs["moe/w"])).sum() + aux
    grads = torch.autograd.grad(obj, list(p))
    got = res["world4.rank0"]
    assert _rel(got["moe_y"], y.detach().numpy()) <= TOL
    aux, obj = float(aux.detach()), float(obj.detach())
    assert abs(got["moe_aux"] - aux) <= TOL * abs(aux)
    assert abs(got["moe_obj"] - obj) <= TOL * abs(obj)
    for a, b in zip(got["moe_g"], grads):
        assert _rel(a, b.numpy()) <= 1e-4
    assert _rel(got["moe_y"], res["jax"]["moe_y"]) <= TOL
    assert abs(got["moe_aux"] - res["jax"]["moe_aux"]) <= \
        TOL * abs(res["jax"]["moe_aux"])
    # one group, one data shard: moe's semantics
    one = dataclasses.replace(cfg, moe_groups=1)
    with torch.no_grad():
        ym, am = TM.moe(p, x, one)
        yp, ap = TM.moe_shardmap_plain(p, x, one, 1, 2)
    assert _rel(yp.detach().numpy(), ym.detach().numpy()) <= TOL
    assert abs(float(ap) - float(am)) <= TOL * abs(float(am))


def test_vocab_parallel_xent_matches_whole_and_reference(runs):
    """The vocab-parallel cross-entropy on (2 x 2), in chunks of 8 tokens:
    its value and gradients those of the whole logits, its value the
    reference's ``_xent_vocab_parallel`` on the same mesh."""
    _, inputs, res = runs
    h = torch.from_numpy(inputs["xe/h"]).requires_grad_()
    table = torch.from_numpy(inputs["xe/table"]).requires_grad_()
    want = T.cross_entropy(h @ table.T, torch.from_numpy(inputs["xe/l"]))
    gh, gt = torch.autograd.grad(want, (h, table))
    want = float(want.detach())
    got = res["world4.rank0"]
    assert abs(got["xent"] - want) <= TOL * want
    assert abs(got["xent"] - res["jax"]["xent"]) <= TOL * want
    assert _rel(got["xent_gh"], gh.numpy()) <= TOL
    assert _rel(got["xent_gt"], gt.numpy()) <= TOL


def test_checkpoint_of_two_ranks_restores_on_one_and_four(runs):
    out, _, res = runs
    cfg = get_config("llama3_2_1b").reduced()
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.optim import adamw_init
    state = adamw_init(params, AdamWConfig())
    tmpl = tree.tree_map(torch.zeros_like, {"params": params, "opt": state})
    got = Checkpointer(out / "ckpt").restore(7, tmpl)
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(got), tree.leaves({"params": params, "opt": state})))
    assert all(res[f"world4.rank{r}"]["restored_equal"] for r in range(4))


LAUNCHED = ["qwen2-vl-2b", "dbrx-132b", "whisper-tiny"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``launch.train`` with ``--model-parallel 2`` on a gloo world of 2
    ranks (torchrun's variables) for each family but the dense one
    (``tests/test_torch_dp_trainer.py`` runs llama3.2-1b and its
    resume), all worlds at once: each rank's output."""
    import socket
    out = tmp_path_factory.mktemp("launched")
    procs = {}
    for arch in LAUNCHED:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs[arch] = [_spawn(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--reduced", "--device", "cpu", "--model-parallel", "2",
             "--batch", "2", "--seq", "16", "--steps", "2",
             "--checkpoint-dir", str(out / arch)],
            dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in (0, 1)]
    deadline, logs = time.monotonic() + TIMEOUT, {}
    for arch, ps in procs.items():
        logs[arch] = [p.communicate(timeout=max(
            1.0, deadline - time.monotonic()))[0] for p in ps]
        assert all(p.returncode == 0 for p in ps), "\n".join(logs[arch])
    return out, logs


@pytest.mark.parametrize("arch", LAUNCHED)
def test_launcher_trains_each_family_on_a_model_axis(launched, arch):
    """The VLM, MoE and enc-dec families train partitioned through the
    launcher: both ranks on a (1 x 2) mesh finish, and rank 0 writes the
    whole tree (the embedding's every row)."""
    out, logs = launched
    for log in logs[arch]:
        assert "partitioned LM: rank" in log and "'model': 2" in log, log
        assert "finished at step 2" in log, log
    cfg = get_config(arch).reduced()
    manifest = json.loads((out / arch / "step_00000002/manifest.json")
                          .read_text())
    assert [cfg.vocab, cfg.d_model] in [m["shape"]
                                        for m in manifest["leaves"]]
