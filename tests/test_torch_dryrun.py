"""The dry-run family (``launch.{steps,analysis,dryrun,hillclimb,
roofline}``, ``models.flags``) against the JAX package, and its abstract
step against real ones, on the CPU.

Parity, for the 14 configs (and the four ``SHAPES`` of each LM) on both
production layouts: the whole parameters' shapes and dtypes leaf for
leaf and their counts; the batch, cache and optimizer-state shapes and
dtypes; every argument's partition spec against the reference's
``build_bundle`` (built on a ``jax.sharding.AbstractMesh`` stand-in: its
``logical_to_spec`` reads the axes' names and sizes alone, so no 256- or
512-device mesh is made and nothing compiles); the decode policy; the
fused-traffic estimate, the model FLOPs, the probe plan, the roofline's
terms under the reference's constants and ``parse_value``.  The
reference's ``launch.dryrun`` sets ``XLA_FLAGS`` when imported, so it is
imported with ``os.environ`` restored around it.

The abstract step against real ones: a reduced llama3.2-1b train step's
FLOPs and argument bytes on a 1 x 1 mesh equal ``FlopCounterMode``'s
count and the bytes of the real CPU step; its ``collective_stats`` on
an abstract (2 x 2) mesh and on (2 x 1) with FSDP equal rank 0's of a
real gloo world of 4 and of 2, and so do dbrx-132b's under
``moe_impl="shardmap"``; the probes' extrapolation equals the full
trace in FLOPs and collective bytes; a reduced cell reaches ``status: "ok"`` on the abstract 2 x 16 x
16 layout; the DCNN wrappers' dry tally equals ``train_step_launches``.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import analysis as JA  # noqa: E402
from repro.launch import hillclimb as JH  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ALL, ASSIGNED, SHAPES, ShapeConfig  # noqa: E402,E501
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import analysis as AN  # noqa: E402
from repro_torch.kernels import common as KC  # noqa: E402,I100
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.launch import roofline as RF  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    PRODUCTION_SHAPES,
    abstract_mesh,
    make_production_mesh,
)
from repro_torch.models import flags  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``os.environ`` as it was
    (its import sets ``XLA_FLAGS`` for 512 host devices)."""
    saved = dict(os.environ)
    try:
        import repro.launch.dryrun as jdr
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return jdr


JDR = _reference_dryrun()
SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 240


class StandIn(AbstractMesh):
    """A production layout for the reference's bundle, with the
    ``devices.shape`` its decode policy reads."""

    @property
    def devices(self):
        return types.SimpleNamespace(shape=tuple(self.axis_sizes))


def _layouts():
    return {"single": False, "multi": True}


_JAX_ABSTRACT = JS.abstract_params


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    return _JAX_ABSTRACT(jax_config(arch))


@pytest.fixture(autouse=True)
def _cached_reference_params(monkeypatch):
    """The reference's bundles draw their abstract parameters once per
    config (each ``jax.eval_shape`` of a full-size init traces it; the
    decode policy's flags change no shape)."""
    monkeypatch.setattr(JS, "abstract_params",
                        lambda cfg: _jax_abstract(cfg.name))


def _strip(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _shape_dtypes(leaves):
    return [(tuple(v.shape), str(jnp.dtype(v.dtype))) for v in leaves]


def _torch_shape_dtypes(leaves):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in leaves if torch.is_tensor(t)]


def _jax_specs(tree_):
    return [_strip(s.spec) for s in jax.tree_util.tree_leaves(
        tree_, is_leaf=lambda x: hasattr(x, "spec"))]


def _port_specs(specs, like):
    return [_strip(s) for s in TP.spec_leaves(specs, like)]


@pytest.mark.parametrize("arch", ALL)
def test_abstract_params_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    shapes, logical = ST.abstract_params(cfg)
    jshapes, _ = _jax_abstract(arch)
    assert _torch_shape_dtypes(tree.leaves(shapes)) == \
        _shape_dtypes(jax.tree_util.tree_leaves(jshapes))
    assert len(tree.leaves(logical, is_leaf=TP.is_logical_leaf)) == \
        len(tree.leaves(shapes))
    master = ST._cast_master(cfg, shapes)
    assert {t.dtype for t in tree.leaves(master)} == {
        getattr(torch, cfg.master_dtype)}
    assert T.param_count(shapes) == sum(
        v.size for v in jax.tree_util.tree_leaves(jshapes))
    assert DR._probe_plan(cfg) == JDR._probe_plan(jcfg)


CELLS = [(a, s, m) for a in ASSIGNED for s in SHAPES
         for m in ("single", "multi")]


@pytest.mark.parametrize("arch,shape_name,layout", CELLS)
def test_bundle_specs_are_the_references(arch, shape_name, layout):
    """Params, active params, the whole arguments' shapes and dtypes, and
    every argument's spec of one cell against the reference's bundle; the
    decode policy; the fused-traffic estimate and the model FLOPs."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape, jshape = SHAPES[shape_name], JDR.SHAPES[shape_name]
    sizes, axes = PRODUCTION_SHAPES[_layouts()[layout]]
    jmesh = StandIn(sizes, axes)
    mesh = make_production_mesh(multi_pod=_layouts()[layout], world=False)
    jb = JS.build_bundle(jcfg, jshape, jmesh)
    b = ST.build_bundle(cfg, shape, mesh)
    assert b.meta["params"] == jb.meta["params"]
    assert b.meta["active_params"] == jb.meta["active_params"]
    pcfg = b.meta["cfg"]

    # parameters (the master cast, whole) and their specs
    p_whole = ST._cast_master(pcfg, ST.abstract_params(pcfg)[0])
    assert _torch_shape_dtypes(tree.leaves(p_whole)) == \
        _shape_dtypes(jax.tree_util.tree_leaves(jb.args[0]))
    assert _port_specs(b.in_shardings[0], p_whole) == \
        _jax_specs(jb.in_shardings[0])
    # the batch, whole, and its specs
    batch, _ = ST.batch_specs(pcfg, shape, mesh)
    jbatch = jb.args[-1]
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        assert _torch_shape_dtypes([batch[k]]) == _shape_dtypes([jbatch[k]])
        assert _strip(b.in_shardings[-1][k]) == _strip(
            jb.in_shardings[-1][k].spec)
    if shape.kind == "train":
        state = adamw_init(p_whole, AdamWConfig(state_bits=pcfg.opt_state_bits))
        assert _torch_shape_dtypes(tree.leaves(state)) == \
            _shape_dtypes(jax.tree_util.tree_leaves(jb.args[1]))
        assert _port_specs(b.in_shardings[1], state) == \
            _jax_specs(jb.in_shardings[1])
    if shape.kind == "decode":
        cache, c_specs = ST.cache_specs(pcfg, shape, mesh)
        jcache = jax.eval_shape(lambda: JT.init_cache(
            None, jcfg, shape.global_batch, shape.seq_len))
        jleaves = jax.tree_util.tree_leaves(jcache)
        assert _torch_shape_dtypes(tree.leaves(cache)) == \
            _shape_dtypes([v for v in jleaves if v.shape != ()])
        assert _port_specs(c_specs, cache) == \
            _jax_specs(jb.in_shardings[1])
        # the decode policy: the reference's cache keeps its KV sequence
        # dim on the model axis exactly where the port's config says so
        if "kv" in cache:
            kv = _strip(jb.in_shardings[1]["kv"][0].spec)
            on_model = len(kv) > 2 and kv[2] == "model"
            assert pcfg.kv_seq_shard == on_model
            assert ST.kv_seq_axes(c_specs) == TP.spec_axes(
                kv[2] if len(kv) > 2 else None)
    # FSDP (the decode policy's too): the reference's params partitioned
    # over the batch axes exactly where the port's config says so
    batch_axes = set(mesh.batch_axes)
    assert pcfg.fsdp == any(batch_axes & set(TP.spec_axes(e)) for s in
                            _jax_specs(jb.in_shardings[0]) for e in s)
    assert DR._analytic_bytes(cfg, shape, mesh, b) == \
        JDR._analytic_bytes(jcfg, jshape, jmesh, jb)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    assert AN.model_flops_estimate(shape.kind, b.meta["active_params"],
                                   tokens) == \
        JA.model_flops_estimate(shape.kind, jb.meta["active_params"], tokens)


@pytest.mark.parametrize("arch", ["vnet", "dcgan", "gp_gan", "gan3d"])
def test_dcnn_estimates_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = make_production_mesh(world=False)
    jmesh = StandIn((16, 16), ("data", "model"))
    b = ST.build_bundle(cfg, None, mesh)
    jb = JS.build_bundle(jcfg, None, jmesh)
    assert b.meta["params"] == jb.meta["params"]
    assert DR._analytic_bytes(cfg, None, mesh, b) == \
        JDR._analytic_bytes(jcfg, None, jmesh, jb)


def test_roofline_is_the_references_under_its_constants(monkeypatch):
    kw = dict(flops_per_device=3.1e14, bytes_per_device=7.7e11,
              collective_bytes_per_device=2.2e10, chips=256,
              model_flops=1.9e16, analytic_bytes_per_device=4.4e11)
    for name, ref in (("PEAK_FLOPS", "PEAK_FLOPS"), ("HBM_BW", "HBM_BW"),
                      ("COLL_BW", "ICI_BW")):
        monkeypatch.setattr(AN, name, getattr(JA, ref))
    assert AN.Roofline(**kw).to_dict() == JA.Roofline(**kw).to_dict()
    for kind in ("train", "prefill", "decode"):
        args = dict(n_params=1_235_814_400, param_shards=16,
                    tokens_local=65536, d_model=2048, n_layers=16,
                    vocab_local=8016, xent_chunks=128,
                    cache_bytes_local=1 << 30)
        for bits in (32, 8):
            assert AN.analytic_hbm_bytes(kind, **args, opt_bits=bits) == \
                JA.analytic_hbm_bytes(kind, **args, opt_bits=bits)
        assert AN.model_flops_estimate(kind, 10**9, 4096, 7.0) == \
            JA.model_flops_estimate(kind, 10**9, 4096, 7.0)


def test_parse_value_is_the_references():
    for v in ("3", "-2", "0.5", "1e-3", "true", "True", "false", "False",
              "save_outs", "shardmap", "", "nan", "4x"):
        got, want = HC.parse_value(v), JH.parse_value(v)
        assert type(got) is type(want)
        assert got == want or (got != got and want != want)


def test_roofline_terms():
    """The reference's ``test_roofline_terms`` at the H100's rates."""
    rl = AN.Roofline(
        flops_per_device=AN.PEAK_FLOPS, bytes_per_device=AN.HBM_BW,
        collective_bytes_per_device=AN.COLL_BW / 2, chips=256,
        model_flops=AN.PEAK_FLOPS * 256 * 0.5)
    assert abs(rl.compute_s - 1.0) < 1e-9
    assert abs(rl.memory_s_hlo_upper - 1.0) < 1e-9
    assert abs(rl.collective_s - 0.5) < 1e-9
    assert rl.dominant in ("compute", "memory")
    assert abs(rl.useful_flops_ratio - 0.5) < 1e-9
    # the hand kernels' FLOPs at the f32 rate
    k = AN.Roofline(flops_per_device=2 * AN.F32_FLOPS, bytes_per_device=0,
                    collective_bytes_per_device=0, chips=1,
                    kernel_flops_per_device=AN.F32_FLOPS)
    assert abs(k.compute_s - (AN.F32_FLOPS / AN.PEAK_FLOPS + 1.0)) < 1e-9


def test_unroll_mode_matches_scan():
    """flags.unrolled() must not change values -- only loop structure
    (the port's loops are Python loops either way)."""
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(),
                              master_dtype="float32")
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.arange(2 * 16).reshape(2, 16) % cfg.vocab,
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    l1, _ = T.forward(params, cfg, batch, mode="train",
                      param_dtype=torch.float32)
    with flags.unrolled():
        assert flags.UNROLL
        l2, _ = T.forward(params, cfg, batch, mode="train",
                          param_dtype=torch.float32)
    assert not flags.UNROLL
    assert float(l1) == float(l2)


def test_maybe_scan_equivalence():
    xs = torch.arange(12.0).reshape(4, 3)

    def body(c, x):
        return c + torch.sum(x), c

    c1, y1 = flags.maybe_scan(body, 0.0, xs)
    with flags.unrolled():
        c2, y2 = flags.maybe_scan(body, 0.0, xs)
    assert float(c1) == float(c2) == 66.0
    assert torch.equal(y1, y2)
    assert y1.tolist() == [0.0, 3.0, 15.0, 36.0]


def test_collective_bytes_are_result_shapes():
    """The reference's convention: an all-gather counts the gathered
    tensor, a reduce-scatter its shard, an all-reduce its tensor;
    ``sent_bytes`` is what the rank handed the backend."""
    mesh = abstract_mesh((2, 4))
    stats = {("all_gather", ("model",)): (2, 100),
             ("reduce_scatter", ("data",)): (1, 64),
             ("all_reduce_sum[blk_out]", ("model",)): (3, 30),
             ("all_reduce_max", ("data",)): (1, 4)}
    out = AN.collective_bytes(stats, mesh)
    assert out["all-gather"] == {"count": 2, "bytes": 400}
    assert out["reduce-scatter"] == {"count": 1, "bytes": 32}
    assert out["all-reduce"] == {"count": 4, "bytes": 34}
    assert out["total_bytes"] == 466 and out["sent_bytes"] == 198


def _llama():
    return dataclasses.replace(get_config("llama3_2_1b").reduced(),
                               master_dtype="float32")


B, S = 4, 16
TRAIN = ShapeConfig("t", "train", S, B)


def test_abstract_flops_and_bytes_are_a_real_steps():
    cfg = _llama()
    opt = AdamWConfig(state_bits=cfg.opt_state_bits)
    b = ST.build_bundle(cfg, TRAIN, abstract_mesh((1, 1)))
    _, rec = AN.analyse_step(b.fn, b.args, abstract_mesh((1, 1)), 1)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = adamw_init(params, opt)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    want_bytes = AN.tree_bytes((params, state, batch))
    with FlopCounterMode(display=False) as fc:
        ST.make_train_step(cfg, opt)(params, state, batch)
    assert fc.get_total_flops() > 0
    assert rec["roofline"]["flops_per_device"] == fc.get_total_flops()
    assert rec["memory"]["argument_bytes"] == want_bytes
    assert rec["kernel_flops"] == 0


def test_temp_bytes_count_only_what_the_step_made():
    """A step that only views its arguments, or writes into them in place
    (as ``adamw_update`` does through ``p.reshape(-1)[sl]``), makes
    nothing: ``temp_bytes`` 0.  A tensor the step makes counts."""
    mesh = abstract_mesh((1, 1))
    p = torch.empty(64, 32, device="meta")
    m = torch.empty(64, 32, device="meta")

    def views(p, m):
        flat = p.reshape(-1)
        flat[:128].mul_(2)
        m.reshape(-1)[128:].add_(flat[128:])
        return flat[:5], m.t()[1:]

    _, rec = AN.analyse_step(views, (p, m), mesh, 1)
    assert rec["memory"]["temp_bytes"] == 0
    assert rec["memory"]["argument_bytes"] == 2 * p.numel() * 4
    _, rec = AN.analyse_step(lambda p, m: (p * 2).sum(), (p, m), mesh, 1)
    assert rec["memory"]["temp_bytes"] == p.numel() * 4
    assert rec["memory"]["output_bytes"] == 4


def test_probes_extrapolate_to_the_full_trace():
    cfg = _llama()
    mesh = abstract_mesh((2, 2))
    plan = DR._probe_plan(cfg)
    assert plan == (1, 2) and cfg.n_layers == 4
    totals, info = DR._probe_metrics(cfg, TRAIN, mesh, plan)
    b = ST.build_bundle(cfg, TRAIN, mesh)
    _, c = AN.trace_step(b.fn, b.args, mesh)
    assert not info["exact"]
    assert totals["flops"] == float(c["product_flops"])
    assert totals["coll"] == float(c["collectives"]["total_bytes"])
    # the op-by-op bytes grow faster than the depth: the backward of a
    # stacked leaf's layer index makes a whole [L, ...] gradient each layer
    # (select_backward), and their sum adds L of them
    assert totals["bytes"] < float(c["accessed_bytes"])


def test_reduced_cell_on_the_two_pod_layout():
    """The port's ``test_production_mesh_cell_compiles``: a reduced cell
    (128 tokens, 64 sequences) traced as rank 0 of 2 x 16 x 16, with no
    world and no device."""
    mesh = make_production_mesh(multi_pod=True, world=False)
    assert mesh.size == 512 and mesh.rank == 0
    b = ST.build_bundle(get_config("llama3_2_1b").reduced(),
                        ShapeConfig("train_4k", "train", 128, 64), mesh)
    _, rec = AN.analyse_step(b.fn, b.args, mesh, mesh.size)
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["roofline"]["chips"] == 512
    assert rec["memory"]["argument_bytes"] > 0
    # the batch's rows over the 32 ranks of ("pod", "data")
    assert b.args[2]["tokens"].shape == (2, 128)
    assert rec["collectives"]["total_bytes"] > 0


def test_dryrun_cli_and_roofline_table(tmp_path, capsys):
    """The CLI writes one record per cell (a skip where the reference
    skips), and the table reads them."""
    rc = DR.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                  "--mesh", "both", "--out", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*"))]
    assert [r["status"] for r in recs] == ["skipped", "skipped"]
    assert "done: ok=0 skipped=2 errors=0" in capsys.readouterr().out
    assert "skipped" in RF.markdown_table(tmp_path, "single")
    assert "0 traced ok, 1 skipped" in RF.multi_pod_summary(tmp_path)


@pytest.mark.parametrize("arch", ["vnet", "dcgan", "gp_gan", "gan3d"])
def test_dcnn_tally_is_train_step_launches(arch):
    cfg = get_config(arch).reduced()
    mesh = abstract_mesh((1, 1))
    b = ST.build_bundle(cfg, None, mesh)
    _, rec = AN.analyse_step(b.fn, b.args, mesh, 1)
    want = ST.train_step_launches(cfg)
    assert {k: v["calls"] for k, v in rec["kernels"].items()} == want
    assert all(v["macs"] > 0 for k, v in rec["kernels"].items()
               if k != "deconv_dx")
    assert rec["kernel_flops"] == 2 * sum(v["macs"] for v in
                                          rec["kernels"].values())
    assert KC.dry_tally() == rec["kernels"]


def test_real_tensors_on_a_mesh_without_a_world_raise():
    from repro_torch.sharding import mesh as SM
    mesh = abstract_mesh((2, 2))
    with pytest.raises(SM.MeshError, match="meta tensors only"):
        SM.psum(torch.ones(3), mesh, ("model",))
    with pytest.raises(SM.MeshError, match="meta tensors only"):
        SM.all_reduce(torch.ones(3), mesh.group("data"))
    got = SM.gather(torch.empty(3, 4, device="meta"), mesh, ("data",), 1)
    assert got.shape == (3, 8) and got.device.type == "meta"
    SM.reset_collective_stats()
    got = SM.pmean(torch.empty(6, device="meta"), mesh.group("data"))
    assert got.shape == (6,) and got.device.type == "meta"
    assert SM.collective_stats() == {("all_reduce_sum", ("data",)): (1, 24)}


# -- the abstract step's collectives against real gloo worlds ---------------

RANKS = """
import sys, json, dataclasses
from pathlib import Path
import torch
torch.set_num_threads(1)
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import mesh as SM
M.init_world("gloo", init_method=f"file://{OUT}/rendezvous{WORLD}",
             world_size=WORLD, rank=RANK, timeout_s=120)
out = {}
for name, arch, (d, m), over in json.loads(sys.argv[4]):
    if d * m != WORLD:
        continue
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    mesh = M.make_host_mesh(model=m, data=d)
    opt = AdamWConfig(state_bits=cfg.opt_state_bits)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            mesh)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = ST.make_train_step(cfg, opt, mesh)
    SM.reset_collective_stats()
    step(params, adamw_init(params, opt), batch)
    out[name] = [[op, list(axes), c, n] for (op, axes), (c, n) in
                 sorted(SM.collective_stats().items())]
if RANK == 0:
    (OUT / f"world{WORLD}.json").write_text(json.dumps(out))
M.leave_world()
"""

# (name, arch, (data, model), config overrides)
REAL_CASES = [
    ("llama_2x2", "llama3_2_1b", (2, 2), {}),
    ("dbrx_2x2", "dbrx_132b", (2, 2), {"moe_impl": "shardmap"}),
    ("llama_fsdp", "llama3_2_1b", (2, 1), {"fsdp": True}),
    ("dbrx_fsdp", "dbrx_132b", (2, 1), {"moe_impl": "shardmap",
                                        "fsdp": True}),
]


@pytest.fixture(scope="module")
def real_stats(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_real")
    script = out / "ranks.py"
    script.write_text(f"B, S = {B}, {S}\n" + textwrap.dedent(RANKS))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(w),
                               str(out), json.dumps(REAL_CASES)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for w in (4, 2) for r in range(w)]
    deadline, logs = time.monotonic() + TIMEOUT, []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank ran over {TIMEOUT} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = {}
    for w in (4, 2):
        res.update(json.loads((out / f"world{w}.json").read_text()))
    return res


@pytest.mark.parametrize("case", [c[0] for c in REAL_CASES])
def test_abstract_collectives_are_a_real_worlds(real_stats, case):
    _, arch, (d, m), over = next(c for c in REAL_CASES if c[0] == case)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    mesh = abstract_mesh((d, m))
    b = ST.build_bundle(cfg, TRAIN, mesh)
    _, c = AN.trace_step(b.fn, b.args, mesh)
    got = [[op, list(axes), n, nb] for (op, axes), (n, nb) in
           sorted(c["collective_stats"].items())]
    assert got and got == real_stats[case]


def test_moe_load_balance_counts_are_bincounts():
    """The MoE's expert counts (a ``scatter_add_``, which has a meta
    kernel, where the term was a ``torch.bincount``, which has none):
    the load-balance term bit for bit the bincount's, on the CPU, and a
    ``meta`` trace of the block."""
    from repro_torch.models import moe as MOE
    cfg = get_config("dbrx_132b").reduced()
    p = MOE.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    xf = torch.randn(64, cfg.d_model, generator=torch.Generator()
                     .manual_seed(1))
    _, aux = MOE._group(xf, p.w_router, p.w_in, p.w_gate, p.w_out, cfg, 0,
                        torch.float32)
    probs, _, top_e = MOE.route(xf, p.w_router, cfg.top_k)
    frac = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts) \
        .float() / (xf.shape[0] * cfg.top_k)
    want = cfg.n_experts * torch.sum(frac * probs.mean(dim=0))
    assert torch.equal(aux, want)
    pm = MOE.init_moe(None, cfg, "meta")
    _, am = MOE._group(torch.empty(64, cfg.d_model, device="meta"),
                       pm.w_router, pm.w_in, pm.w_gate, pm.w_out, cfg, 0,
                       torch.float32)
    assert am.device.type == "meta" and am.shape == ()


def test_hillclimb_cli(tmp_path):
    rec = HC.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                   "--tag", "saveouts", "--set", "remat_policy=save_outs",
                   "--out", str(tmp_path)])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["probe"]["probe_layers"] == [1, 2]
    assert rec["overrides"] == {"remat_policy": "save_outs"}
    saved = json.loads((tmp_path / "saveouts.json").read_text())
    assert saved["roofline"] == rec["roofline"]
