"""Partitioned prefill and decode in gloo worlds of 2 and 4 ranks against
the unpartitioned port and the JAX package's sharded serve, on the CPU.

The ranks run as subprocesses (a ``file://`` rendezvous in the test's
temporary directory), the JAX side in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``; all start
together.  Parameters come from the port's seeded ``real_params`` (each
rank draws them whole and keeps its blocks), in f32; the decode caches
are f32, so the probs' rounding to the cache's dtype is an f32 one.

Each case, in a world of 2: the prefill's logits (gathered over the
batch) within 1e-5 of the unpartitioned port's (of max |logit|), its
cache gathered equal within 1e-5; then four greedy decode steps against
a cache cut by ``launch.steps.cache_specs`` (the unpartitioned prefill's
cache spliced in): each step's logits within 1e-5, the greedy tokens
equal, the final cache gathered equal.  The cases: dense (llama3.2-1b,
head-parallel, and split-KV under ``kv_seq_shard=True``; granite-20b's
one KV head whole on every rank), VLM (qwen2-vl-2b, M-RoPE), MoE
(dbrx-132b under ``moe_impl="shardmap"`` on the model axis and under
``moe`` on the data axis), xLSTM (xlstm-350m), the Zamba2 hybrid (head-
parallel, and sequence-parallel: one sequence, its KV positions cut over
``data``) and Whisper (cross attention).

World of 4, a (2 x 2) mesh: reduced llama3.2-1b's prefill logits and one
decode step's within 1e-5 of the JAX package's ``T.forward`` jitted with
its ``build_bundle`` shardings for the same cell (the body of its
``make_serve_step``, its logits kept), on the same f32 cache; head-
parallel, and split-KV under ``kv_seq_shard=True``.
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

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.serve_loop import splice  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 240
TOL = 1e-5
B, S, MAX_LEN, STEPS = 4, 8, 16, 4

# (name, arch, (data, model), config overrides, batch rows)
CASES = [
    ("llama", "llama3_2_1b", (1, 2), {}, B),
    ("llama_split_kv", "llama3_2_1b", (1, 2), {"kv_seq_shard": True}, B),
    ("granite", "granite_20b", (1, 2), {}, B),
    ("qwen2", "qwen2_vl_2b", (1, 2), {}, B),
    ("dbrx_shardmap", "dbrx_132b", (1, 2), {"moe_groups": 1}, B),
    ("dbrx_moe_data", "dbrx_132b", (2, 1), {"moe_impl": "dense_scatter"},
     B),
    ("xlstm", "xlstm_350m", (1, 2), {}, B),
    ("zamba2", "zamba2_2_7b", (1, 2), {}, B),
    ("zamba2_seq", "zamba2_2_7b", (2, 1), {}, 1),
    ("whisper", "whisper_tiny", (1, 2), {}, B),
]

COMMON = """
import sys, json, dataclasses
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
from repro_torch import tree
from repro_torch.configs import get_config, ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.runtime.serve_loop import splice
from repro_torch.sharding import mesh as SM
from repro_torch.sharding import partition as P
M.init_world("gloo", init_method=f"file://{OUT}/rendezvous{WORLD}",
             world_size=WORLD, rank=RANK, timeout_s=120)
inputs = np.load(OUT / "inputs.npz")

def whole(t, spec, mesh):
    for d, e in enumerate(spec):
        if e is not None:
            t = SM.gather(t, mesh, P.spec_axes(e), d)
    return t

def cut(t, specs, mesh):
    '''This rank's blocks of the tensor leaves of ``t`` (copies), its
    other leaves as they are.'''
    return tree.unflatten(t, [P.local_block(x, s, mesh).clone()
                              if torch.is_tensor(x) else x for x, s in
                              zip(tree.leaves(t), P.spec_leaves(specs, t))])

def whole_tree(t, specs, mesh):
    return [whole(x, s, mesh).numpy() for x, s in zip(
        tree.leaves(t), P.spec_leaves(specs, t)) if torch.is_tensor(x)]

def f32(t):
    return tree.tree_map(lambda x: x.float() if torch.is_tensor(x)
                         and x.is_floating_point() else x, t)

def batch_of(cfg, rows, decode_token=None, pos=None):
    b = {"tokens": torch.from_numpy(inputs["tokens"][:rows])}
    if decode_token is not None:
        b["tokens"] = decode_token[:, None]
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.from_numpy(inputs["enc"][:rows])
    if cfg.mrope:
        s = b["tokens"].shape[1]
        b["mrope_positions"] = torch.arange(s)[None, None].expand(
            3, rows, s).contiguous() if pos is None else torch.full(
            (3, rows, 1), pos)
    return b

def local(cfg, batch, kind, mesh):
    rows, s = batch["tokens"].shape
    _, specs = ST.batch_specs(cfg, ShapeConfig("t", kind, s, rows), mesh)
    return P.shard_tree(batch, {k: specs[k] for k in batch}, mesh)

def serve(cfg, mesh, rows):
    '''The partitioned prefill and STEPS greedy decode steps on ``mesh``:
    (prefill logits, prefill cache, per-step logits, tokens, final
    cache), gathered whole.'''
    specs = ST.param_specs(cfg, mesh)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh)
    whole_p = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_of(cfg, rows)
    b_spec = ST.batch_specs(cfg, ShapeConfig("t", "prefill", S, rows),
                            mesh)[1]
    logits, pcache = ST.serve_forward(params, cfg, local(cfg, batch,
                                      "prefill", mesh), "prefill", None,
                                      mesh, specs, None, torch.float32)
    logits = whole(logits, b_spec["tokens"][:1], mesh)
    # the prefill cache's layout: the heads', whole along the sequence
    _, want = T.forward(whole_p, cfg, batch, mode="prefill",
                        param_dtype=torch.float32)
    pl = T.cache_logical(dataclasses.replace(cfg, kv_seq_shard=False))
    p_specs = P.param_shardings(mesh, want, pl, fsdp_enabled=False)
    got_pcache = whole_tree(pcache, p_specs, mesh)
    # decode against the unpartitioned prefill's cache, cut to blocks
    shape = ShapeConfig("d", "decode", MAX_LEN, rows)
    _, c_specs = ST.cache_specs(cfg, shape, mesh)
    cache = f32(T.init_cache(whole_p, cfg, rows, MAX_LEN))
    cache = cut(splice(cache, want, S), c_specs, mesh)
    tok = torch.argmax(logits[:, -1], dim=-1)
    d_logits, toks = [], [tok.numpy()]
    for i in range(STEPS):
        db = batch_of(cfg, rows, tok, S + i)
        lg, cache = ST.serve_forward(params, cfg, local(cfg, db, "decode",
                                     mesh), "decode", cache, mesh, specs,
                                     c_specs, torch.float32)
        lg = whole(lg, b_spec["tokens"][:1], mesh)
        d_logits.append(lg.numpy())
        tok = torch.argmax(lg[:, -1], dim=-1)
        toks.append(tok.numpy())
    return (logits.numpy(), got_pcache, d_logits, toks,
            whole_tree(cache, c_specs, mesh))
"""

WORLD2 = """
for name, arch, (d, m), over, rows in json.loads(inputs["cases"].item()):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              master_dtype="float32", **over)
    mesh = M.make_host_mesh(model=m, data=d)
    lg, pc, dl, toks, dc = serve(cfg, mesh, rows)
    if RANK == 0:
        np.savez(OUT / f"case.{name}.npz", logits=lg, tokens=np.stack(toks),
                 decode=np.stack(dl),
                 **{f"p{i}": a for i, a in enumerate(pc)},
                 **{f"c{i}": a for i, a in enumerate(dc)})
"""

WORLD4 = """
out = {}
for tag, over in (("", {}), ("split_kv_", {"kv_seq_shard": True})):
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(),
                              master_dtype="float32", **over)
    mesh = M.make_host_mesh(model=2)
    specs = ST.param_specs(cfg, mesh)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh)
    batch = batch_of(cfg, B)
    b_spec = ST.batch_specs(cfg, ShapeConfig("t", "prefill", S, B), mesh)[1]
    lg, _ = ST.serve_forward(params, cfg, local(cfg, batch, "prefill",
                             mesh), "prefill", None, mesh, specs, None,
                             torch.float32)
    shape = ShapeConfig("d", "decode", MAX_LEN, B)
    _, c_specs = ST.cache_specs(cfg, shape, mesh)
    k = torch.from_numpy(inputs["jcache_k"])
    v = torch.from_numpy(inputs["jcache_v"])
    cache = cut({"kv": (k, v), "pos": S}, c_specs, mesh)
    db = {"tokens": torch.from_numpy(inputs["jtok"])}
    dl, _ = ST.serve_forward(params, cfg, local(cfg, db, "decode", mesh),
                             "decode", cache, mesh, specs, c_specs,
                             torch.float32)
    out[tag + "prefill"] = whole(lg, b_spec["tokens"][:1],
                                 mesh).numpy().tolist()
    out[tag + "decode"] = whole(dl, b_spec["tokens"][:1],
                                mesh).numpy().tolist()
if RANK == 0:
    (OUT / "world4.json").write_text(json.dumps(out))
"""

JAX_SIDE = """
import sys, json, dataclasses
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
OUT = Path(sys.argv[1])
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
inputs = np.load(OUT / "inputs.npz")
mesh = make_host_mesh(model=2, data=2)
cfg = get_config("llama3_2_1b").reduced()
shapes, _ = JS.abstract_params(cfg)
params = jax.tree_util.tree_unflatten(
    jax.tree_util.tree_structure(shapes),
    [jnp.asarray(inputs[f"llama/{i}"]) for i in
     range(len(jax.tree_util.tree_leaves(shapes)))])
out = {}
for tag, kv_seq in (("", False), ("split_kv_", True)):
    c = dataclasses.replace(cfg, kv_seq_shard=kv_seq)
    with mesh:
        pb = JS.build_bundle(c, ShapeConfig("t", "prefill", %(S)d, %(B)d),
                             mesh)
        fn = jax.jit(lambda p, b: JT.forward(p, c, b, mode="prefill",
                                             param_dtype=jnp.float32)[0],
                     in_shardings=pb.in_shardings)
        out[tag + "prefill"] = np.asarray(fn(params, {"tokens": jnp.asarray(
            inputs["tokens"])})).tolist()
        db = JS.build_bundle(c, ShapeConfig("d", "decode", %(T)d, %(B)d),
                             mesh)
        assert db.in_shardings[1]["kv"][0].spec[2] == (
            "model" if kv_seq else None), db.in_shardings[1]
        cache = {"kv": (jnp.asarray(inputs["jcache_k"]),
                        jnp.asarray(inputs["jcache_v"])),
                 "pos": jnp.asarray(%(S)d, jnp.int32)}
        fn = jax.jit(lambda p, ca, b: JT.forward(p, c, b, mode="decode",
                                                 cache=ca,
                                                 param_dtype=jnp.float32)[0],
                     in_shardings=db.in_shardings)
        out[tag + "decode"] = np.asarray(fn(params, cache, {
            "tokens": jnp.asarray(inputs["jtok"])})).tolist()
(OUT / "jax.json").write_text(json.dumps(out))
""" % {"S": S, "B": B, "T": MAX_LEN}


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(),
                               master_dtype="float32", **over)


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


def _inputs(rng):
    cfg = get_config("llama3_2_1b").reduced()
    inputs = {"cases": np.array(json.dumps(CASES)),
              "tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int64),
              "enc": rng.standard_normal((B, 16, 128)).astype(np.float32)}
    params = ST.real_params(dataclasses.replace(cfg,
                                                master_dtype="float32"),
                            torch.Generator().manual_seed(0), "cpu")
    for i, t in enumerate(tree.leaves(params)):
        inputs[f"llama/{i}"] = t.numpy()
    # a decode cache with every position set, and one new token a row
    shape = (cfg.n_layers, B, MAX_LEN, cfg.n_kv_heads, cfg.resolved_head_dim)
    inputs["jcache_k"] = rng.standard_normal(shape).astype(np.float32)
    inputs["jcache_v"] = rng.standard_normal(shape).astype(np.float32)
    inputs["jtok"] = rng.randint(0, cfg.vocab, (B, 1)).astype(np.int32)
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_serve_sharded")
    inputs = _inputs(np.random.RandomState(0))
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for world, body in ((2, WORLD2), (4, WORLD4)):
        script = out / f"rank{world}.py"
        script.write_text(
            f"S, B, MAX_LEN, STEPS = {S}, {B}, {MAX_LEN}, {STEPS}\n"
            + COMMON + textwrap.dedent(body) + "\nM.leave_world()\n")
        procs += [_spawn([sys.executable, str(script), str(r), str(world),
                          str(out)], env) for r in range(world)]
    jscript = out / "jax_side.py"
    jscript.write_text(JAX_SIDE)
    procs.append(_spawn([sys.executable, str(jscript), str(out)], dict(
        env, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")))
    _wait(procs)
    res = {"world4": json.loads((out / "world4.json").read_text()),
           "jax": json.loads((out / "jax.json").read_text())}
    return out, inputs, res


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _unpartitioned(cfg, inputs, rows):
    """The port's prefill and STEPS greedy decode steps on one process,
    as the ranks run them: (prefill logits, prefill cache leaves, decode
    logits, tokens, final cache leaves)."""
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(inputs["tokens"][:rows])

    def batch(tokens, pos=None):
        b = {"tokens": tokens}
        if cfg.family == "encdec":
            b["enc_embeds"] = torch.from_numpy(inputs["enc"][:rows])
        if cfg.mrope:
            s = tokens.shape[1]
            b["mrope_positions"] = (
                torch.arange(s)[None, None].expand(3, rows, s).contiguous()
                if pos is None else torch.full((3, rows, 1), pos))
        return b
    logits, pcache = T.forward(params, cfg, batch(toks), mode="prefill",
                               param_dtype=torch.float32)
    cache = tree.tree_map(lambda t: t.float() if torch.is_tensor(t)
                          and t.is_floating_point() else t,
                          T.init_cache(params, cfg, rows, MAX_LEN))
    cache = splice(cache, pcache, S)
    tok = torch.argmax(logits[:, -1], dim=-1)
    dl, tks = [], [tok.numpy()]
    for i in range(STEPS):
        lg, cache = T.forward(params, cfg, batch(tok[:, None], S + i),
                              mode="decode", cache=cache,
                              param_dtype=torch.float32)
        dl.append(lg.numpy())
        tok = torch.argmax(lg[:, -1], dim=-1)
        tks.append(tok.numpy())
    return (logits.numpy(), [t.numpy() for t in tree.leaves(pcache)
                             if torch.is_tensor(t)], dl, tks,
            [t.numpy() for t in tree.leaves(cache) if torch.is_tensor(t)])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_partitioned_serve_matches_one_process(runs, case):
    out, inputs, _ = runs
    _, arch, _, over, rows = next(c for c in CASES if c[0] == case)
    cfg = _cfg(arch, over)
    got = np.load(out / f"case.{case}.npz")
    lg, pc, dl, toks, dc = _unpartitioned(cfg, inputs, rows)
    assert _rel(got["logits"], lg) <= TOL
    n_p = len([k for k in got.files if k.startswith("p")])
    assert n_p == len(pc)
    for i, want in enumerate(pc):
        assert got[f"p{i}"].shape == want.shape
        assert _rel(got[f"p{i}"], want) <= TOL, i
    for i, want in enumerate(dl):
        assert _rel(got["decode"][i], want) <= TOL, i
    assert np.array_equal(got["tokens"], np.stack(toks))
    n_c = len([k for k in got.files if k.startswith("c")])
    assert n_c == len(dc)
    for i, want in enumerate(dc):
        assert got[f"c{i}"].shape == want.shape
        assert _rel(got[f"c{i}"], want) <= TOL, i


def test_sharded_serve_matches_the_jax_package(runs):
    """Reduced llama3.2-1b on (2 x 2): the prefill's logits and one decode
    step's (every cache position set) within 1e-5 of the JAX package's
    forward jitted with its ``build_bundle`` shardings."""
    _, _, res = runs
    assert _rel(res["world4"]["prefill"], res["jax"]["prefill"]) <= TOL
    assert _rel(res["world4"]["decode"], res["jax"]["decode"]) <= TOL


def test_split_kv_serve_matches_the_jax_package(runs):
    """The same cell under ``kv_seq_shard=True``: the decode cache's
    sequence cut over ``model`` (the new token's K and V written on the
    rank that owns position S), the partial softmaxes combined over
    ``model``, against the JAX package's forward jitted with its
    ``build_bundle`` shardings, which put the cache's sequence on
    ``model`` and leave the rest to GSPMD."""
    _, _, res = runs
    for k in ("split_kv_prefill", "split_kv_decode"):
        assert _rel(res["world4"][k], res["jax"][k]) <= TOL, k
