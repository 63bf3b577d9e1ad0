"""The port's partition arithmetic against the JAX package's, in-process.

``_partition_layers`` and ``_collective_bytes`` (``core/engine.py``) and
``logical_to_spec`` / ``conv_weight_axes`` (``sharding/partition.py``) are
plain arithmetic on layers and mesh shapes: the port keeps its own copies,
which must give exactly the reference's answers.  Meshes are described by
their axis names and sizes alone (the reference functions read
``mesh.axis_names`` and ``mesh.shape``), so no device or process group is
needed.  The models' logical parameter axes cross over too, leaf for leaf.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import networks as JN  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.sharding import partition as JP  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import networks as TN  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.sharding import mesh as SM  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.sharding import partition as TP  # noqa: E402


def _vnet_chain(nets):
    """The reference test's V-Net-shaped chain
    (``tests/test_sharded_engine.py::_vnet_chain``), built from either
    package's networks module."""
    layers = nets.conv_stack("vnet", (8, 8, 8), [(1, 4), (4, 8), (8, 16)])
    sp = layers[-1].out_spatial
    for i, (ci, co) in enumerate([(16, 8), (8, 4)]):
        layers.append(nets.UniformLayer(
            name=f"vnet.up{i + 1}", in_spatial=sp, cin=ci, cout=co,
            kernel=(3,) * 3, stride=(2,) * 3, padding=((0, 1),) * 3,
            op="deconv"))
        sp = layers[-1].out_spatial
    return layers


CHAINS = {"dcgan": lambda n: n.dcgan(), "vnet_chain": _vnet_chain,
          "gan3d": lambda n: n.gan3d(),
          "dcgan_reduced": lambda n: n.scale_channels(n.dcgan(), div=32)}


@pytest.mark.parametrize("min_block", [2, 8])
@pytest.mark.parametrize("model", [1, 2, 4, 8])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_partition_layers_match_the_reference(chain, model, min_block):
    jl, tl = CHAINS[chain](JN), CHAINS[chain](TN)
    jparts = JE._partition_layers(
        jl, JE.MeshPolicy(model_axis="model", min_channel_block=min_block),
        model)
    tparts = TE._partition_layers(
        tl, TE.MeshPolicy(model_axis="model", min_channel_block=min_block),
        model)
    assert [(tuple(p.w_spec), p.local_cin, p.local_cout, p.collective)
            for p in jparts] == \
        [(p.w_spec, p.local_cin, p.local_cout, p.collective) for p in tparts]
    for l_j, l_t, p_j, p_t in zip(jl, tl, jparts, tparts):
        for per_dev, act in ((1, 4), (3, 2), (4, 4)):
            assert TE._collective_bytes(l_t, p_t, per_dev, act) == \
                JE._collective_bytes(l_j, p_j, per_dev, act)


def test_model_sharding_engages_on_the_full_dcgan():
    """The full-width DCGAN generator on a 2-way model axis shards 512 and
    128 output channels and contracts them in the next layer."""
    parts = TE._partition_layers(
        TN.dcgan(), TE.MeshPolicy(model_axis="model", min_channel_block=8),
        2)
    assert [(p.local_cin, p.local_cout, p.collective) for p in parts] == [
        (1024, 256, None), (256, 256, "psum"), (256, 64, None),
        (64, 3, "psum")]


def _mesh(sizes, names):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


MESHES = [((4, 2), ("data", "model")), ((8, 1), ("data", "model")),
          ((2, 4, 2), ("pod", "data", "model"))]
LOGICAL = [
    (("batch", None, "model"), (8, 3, 6)),
    (("batch", None, "model"), (6, 3, 5)),
    (("fsdp", "model"), (16, 4)),
    (("seq", None), (8, 2)),
    ((None, None, None, "model"), None),
    (("data", "model"), (8, 8)),
    (("bogus", "model"), (8, 8)),
    ((None, None), (3, 3)),
    (("model", "batch"), (4, 16)),
]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str,
                                                                     m[0])))
def test_logical_to_spec_matches_the_reference(mesh, fsdp):
    m = _mesh(*mesh)
    assert TP.mesh_axes(m) == {k: tuple(v)
                               for k, v in JP.mesh_axes(m).items()}
    for logical, dims in LOGICAL:
        want = tuple(JP.logical_to_spec(m, logical, dims, fsdp))
        assert TP.logical_to_spec(m, logical, dims, fsdp) == want, logical
    # a port Mesh resolves like the reference's mesh of the same shape
    port = SM.Mesh(*mesh)
    assert TP.logical_to_spec(port, ("batch", None, "model"), (8, 3, 6)) \
        == tuple(JP.logical_to_spec(m, ("batch", None, "model"), (8, 3, 6)))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_conv_weight_axes_match_the_reference(rank):
    for kw in ({}, {"cout": None}, {"cin": "model", "cout": None},
               {"cin": "fsdp"}):
        assert TP.conv_weight_axes(rank, **kw) == \
            JP.conv_weight_axes(rank, **kw)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["dcgan", "gp-gan", "3d-gan", "v-net",
                                  *ASSIGNED])
def test_param_axes_cross_over(arch, reduced):
    """Each parameter's logical axes are the reference initialisers'
    (``split_params``), leaf for leaf, and fit the parameter's rank: the
    DCNNs' and every LM's (stacked layers with their leading ``None``,
    as the port stacks them too; xLSTM's list of layers)."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    shapes, logical = JS.abstract_params(jcfg)
    want = jax.tree_util.tree_leaves(logical, is_leaf=JP.is_logical_leaf)
    got = tree.leaves(TS.param_axes(tcfg), is_leaf=TP.is_logical_leaf)
    assert got == [tuple(a) for a in want]
    dims = [s.ndim for s in jax.tree_util.tree_leaves(shapes)]
    assert [len(a) for a in got] == dims


def test_constrain_passes_through():
    x = torch.randn(2, 4, 4, 8)
    assert TP.constrain(x, "batch", "model", None, None) is x


def test_mesh_layout_is_row_major():
    m = SM.Mesh((2, 3), ("data", "model"), rank=4)
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.coords == {"data": 1, "model": 1}
    with pytest.raises(SM.MeshError, match="holds no process groups"):
        m.group("data")
    with pytest.raises(SM.MeshError, match="do not fit"):
        SM.Mesh((2,), ("data", "model"))


def test_world_of_one_process():
    """Without torchrun's variables a process is a world of one: a (1, 1)
    host mesh with gloo groups; the production meshes need 256 or 512
    ranks and refuse it."""
    assert M.backend_for("cpu") == "gloo" and M.backend_for("cuda") == "nccl"
    joined = M.init_world("gloo")
    try:
        mesh = M.make_host_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
        t = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(SM.all_reduce(t, mesh.group("data")), t)
        assert torch.equal(SM.all_gather(t, mesh.group("model"), dim=-1), t)
        assert torch.equal(SM.pmean(t, mesh.group("data")), t)
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(SM.MeshError, match=f"needs {n} ranks"):
                M.make_production_mesh(multi_pod=multi_pod)
    finally:
        if joined:
            M.leave_world()
