"""The LM partition arithmetic against the JAX package's, in-process and
with no world: every assigned LM config at full size (the reference's
``abstract_params`` allocates nothing, the port's ``device="meta"`` and
``device="axes"`` trees neither).

* ``param_specs`` (the port's ``param_shardings`` of ``param_axes``) and
  the reference's ``logical_to_spec`` of each leaf, on a (4 x 2) host
  mesh and the production 16 x 16 and 2 x 16 x 16 meshes, with the
  config's ``fsdp``;
* ``cache_logical`` with and without ``kv_seq_shard`` and ``seq_shard``;
* ``opt_shardings``, 8-bit ``QTensor`` moments included (the reference's
  ``NamedSharding`` replaced by its spec: a mesh with no devices serves,
  as ``logical_to_spec`` reads only its axis names and sizes);
* ``local_block`` / ``shard_tree`` cutting the blocks the specs name;
* ``adamw_update`` in slices (its transients a slice's size) bit for bit
  the update of whole leaves, and with ``consume`` freeing the gradients.

``param_axes`` itself crosses over leaf for leaf in
``tests/test_torch_partition.py::test_param_axes_cross_over``.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.sharding import partition as JP  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.sharding import mesh as SM  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake(sizes, names):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return JS.abstract_params(jax_config(arch))


def _jleaves(t):
    return [tuple(x) for x in
            jax.tree_util.tree_leaves(t, is_leaf=JP.is_logical_leaf)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_the_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    jcfg, cfg = jax_config(arch), get_config(arch)
    shapes, logical = _abstract(arch)
    want = [tuple(JP.logical_to_spec(_fake(sizes, names), lg, s.shape,
                                     jcfg.fsdp))
            for lg, s in zip(_jleaves(logical),
                             jax.tree_util.tree_leaves(shapes))]
    got = ST.param_specs(cfg, SM.Mesh(sizes, names))
    assert tree.leaves(got, is_leaf=TP.is_logical_leaf) == want
    # and through the port's WS leaves, as the reference builds its tree
    values = ST._init_ws(cfg, None, device="meta")
    ws = tree.unflatten(values, [TP.WS(v, a) for v, a in zip(
        tree.leaves(values),
        tree.leaves(ST.param_axes(cfg), is_leaf=TP.is_logical_leaf))])
    v2, lg2 = TP.split_params(ws)
    assert [tuple(t.shape) for t in tree.leaves(v2)] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
    assert tree.leaves(TP.param_shardings(
        SM.Mesh(sizes, names), v2, lg2, cfg.fsdp),
        is_leaf=TP.is_logical_leaf) == want


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("kv_seq_shard", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_logical_matches_the_reference(arch, kv_seq_shard,
                                             seq_shard):
    jcfg = dataclasses.replace(jax_config(arch), kv_seq_shard=kv_seq_shard)
    cfg = dataclasses.replace(get_config(arch), kv_seq_shard=kv_seq_shard)
    assert T.cache_logical(cfg, seq_shard) == \
        JT.cache_logical(jcfg, seq_shard)


@pytest.mark.parametrize("mesh", ["4x2", "16x16"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_opt_shardings_match_the_reference(arch, mesh, monkeypatch):
    sizes, names = MESHES[mesh]
    jcfg, cfg = jax_config(arch), get_config(arch)
    shapes, logical = _abstract(arch)
    jstate = jax.eval_shape(lambda p: jadamw_init(
        p, JAdamWConfig(state_bits=jcfg.opt_state_bits)), shapes)
    monkeypatch.setattr(JS, "NamedSharding", lambda m, spec: tuple(spec))
    want = JS.opt_shardings(_fake(sizes, names), jstate, logical, jcfg.fsdp)
    state = adamw_init(ST._init_ws(cfg, None, device="meta"),
                       AdamWConfig(state_bits=cfg.opt_state_bits))
    got = ST.opt_shardings(SM.Mesh(sizes, names), state,
                           ST.param_axes(cfg), cfg.fsdp)
    assert tree.leaves(got, is_leaf=TP.is_logical_leaf) == _jleaves(want)
    if cfg.opt_state_bits == 8:
        assert got.m["layers"]["moe"].w_in.scale == ()


def test_blocks_tile_the_whole_tensor():
    """``shard_tree`` cuts each rank's block as the spec names it, and
    the blocks of every rank of a (2, 2) mesh tile the whole tensor
    (row-major over the dims' axes, as ``block_index`` lays them)."""
    cfg = get_config("llama3_2_1b").reduced()
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = ST.param_specs(cfg, SM.Mesh((2, 2), ("data", "model")))
    embed = params["embed"]
    assert specs["embed"] == ("model",)
    got = torch.zeros_like(embed)
    for r in range(4):
        mesh = SM.Mesh((2, 2), ("data", "model"), rank=r)
        blocks = TP.shard_tree(params, specs, mesh)
        assert blocks["embed"].shape == (cfg.vocab // 2, cfg.d_model)
        assert blocks["layers"]["attn"].wq.shape == (4, 128, 2, 32)
        sl = TP.block_index(mesh, specs["embed"], embed.shape)
        got[sl] = blocks["embed"]
        assert torch.equal(TP.local_block(embed, ("model",), mesh),
                           embed[mesh.coords["model"] * 128:][:128])
    assert torch.equal(got, embed)
    two = SM.Mesh((2, 2), ("data", "model"), rank=3)
    x = np.arange(32).reshape(4, 8)
    assert (TP.local_block(x, (("data", "model"),), two)
            == x[3:4]).all()


def test_params_from_numpy_cuts_each_rank_block():
    """``convert.params_from_numpy`` with a mesh hands each rank its
    blocks of the JAX package's tree, the ones ``shard_tree`` cuts."""
    from jax_lm_helpers import numpy_params
    from repro_torch.convert import params_from_numpy
    cfg = dataclasses.replace(get_config("granite_20b").reduced(), fsdp=True)
    tree_np = numpy_params(dataclasses.replace(
        jax_config("granite_20b").reduced(), fsdp=True), 0)
    whole = params_from_numpy(tree_np, "cpu", cfg=cfg)
    for r in range(4):
        mesh = SM.Mesh((2, 2), ("data", "model"), rank=r)
        got = params_from_numpy(tree_np, "cpu", cfg=cfg, mesh=mesh)
        want = TP.shard_tree(whole, ST.param_specs(cfg, mesh), mesh)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                     tree.leaves(want)))
        assert got["layers"]["mlp"].w_in.shape == (4, 64, 128)


def test_current_mesh_nests():
    a, b = SM.Mesh((1, 2), ("data", "model")), SM.Mesh((2, 1),
                                                      ("data", "model"))
    assert TP.current_mesh() is None
    with TP.use_mesh(a):
        with TP.use_mesh(b):
            assert TP.current_mesh() is b
        assert TP.current_mesh() is a
    assert TP.current_mesh() is None


@pytest.mark.parametrize("bits", [32, 8])
def test_update_in_slices_is_the_whole_update(bits, monkeypatch):
    from repro_torch.optim import adamw as AW
    rng = np.random.default_rng(3)
    shapes = [(3, 7), (11,), (), (2, 3, 5)]

    def draw(scale=1.0):
        return [torch.from_numpy(np.asarray(rng.standard_normal(s) * scale,
                                            dtype=np.float32))
                for s in shapes]
    opt = AdamWConfig(lr=1e-2, state_bits=bits)
    params = draw()
    state = adamw_init(params, opt)
    # moments a step has filled, the step count past the warmup
    params, state = AW.adamw_update(draw(), state, params, opt)
    state = state._replace(step=torch.tensor(40, dtype=torch.int32))
    grads = draw(1e-3)
    whole = AW.adamw_update(grads, state, params, opt, lr_scale=0.5)
    monkeypatch.setattr(AW, "_SLICE", 4)
    given = list(grads)
    sliced = AW.adamw_update(given, state, params, opt, lr_scale=0.5,
                             consume=True)
    assert given == [None] * len(grads)
    for a, b in zip(tree.leaves(whole), tree.leaves(sliced)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        AW.adamw_update(tuple(grads), state, params, opt, consume=True)
