"""The paper's models and ``repro_torch.core``'s public names against the
JAX package, on the CPU.

Fig. 1 (``sparsity``), Table II and Fig. 6a (``tiling``'s FPGA model) and
Fig. 7's platform models (``comparison.modeled_comparison``) are the same
arithmetic in both packages, so they agree within 1e-12 relative (float
sums in the same order; the bound leaves room for none but the last bit).
The reduced GP-GAN and 3D-GAN generators run on weights drawn by the JAX
package's ``real_params`` (jitted: one compile, where the eager draw
compiles once per shape) and carried over by ``convert.params_from_numpy``;
the port's kernels' plain versions hold within 1e-4 of the reference's
``xla`` method on both and its ``pallas`` method (interpret mode) on
GP-GAN, the reference's own f32 tolerance.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import comparison as jcomp  # noqa: E402
from repro.core import networks as jnet  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import tiling as jtil  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import dcnn as JD  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Precision,
    UniformEngine,
    comparison,
    compile_network,
    networks,
    sparsity,
    tiling,
)
from repro_torch.core.engine import EngineError  # noqa: E402
from repro_torch.models import dcnn as TD  # noqa: E402
from repro_torch.quant import precision as tprecision  # noqa: E402

NETWORKS = ("dcgan", "gp_gan", "3d_gan", "v_net")
REL = 1e-12
TOL = 1e-4
REF_INIT = Path(jcore.__file__)


def _close(got, want, what):
    """Numbers, strings, lists and dicts equal, floats within REL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= REL * abs(want), (what, got, want)
    else:
        assert got == want, (what, got, want)


def _reference_names():
    """Every name ``repro.core``'s ``__init__`` imports (its public
    surface)."""
    names = []
    for node in ast.parse(REF_INIT.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


def test_public_names_are_the_references_but_mesh_policy():
    """Every public name of ``repro.core``, ``MeshPolicy`` included since
    the multi-GPU slice (the test keeps its name from the slice before)."""
    names = _reference_names()
    assert "UniformEngine" in names and "comparison" in names
    missing = [n for n in names if not hasattr(tcore, n)]
    assert missing == []
    from repro_torch.core import engine, functional
    assert tcore.MeshPolicy is engine.MeshPolicy
    for n in names:
        if n in ("networks", "sparsity", "tiling",
                 "comparison", "UniformLayer", "Precision"):
            continue
        assert getattr(tcore, n) is getattr(
            engine if hasattr(engine, n) else functional, n), n
    assert tcore.UniformLayer is networks.UniformLayer
    assert Precision is tprecision.Precision
    assert (tcore.networks, tcore.sparsity, tcore.tiling,
            tcore.comparison) == (networks, sparsity, tiling, comparison)
    assert compile_network is engine.compile_network


def test_importing_core_loads_no_kernel_library():
    # the package import is cheap: in a fresh process, importing it builds
    # and loads nothing until a launch
    code = ("import torch, repro_torch.core\n"
            "from repro_torch.kernels import build\n"
            "assert build.library.cache_info().currsize == 0\n"
            "assert not torch.cuda.is_initialized()\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, (
               str(Path(tcore.__file__).parents[2]),
               os.environ.get("PYTHONPATH"))))}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def _facts(l):
    return (l.name, l.op, l.in_spatial, l.cin, l.cout, l.kernel, l.stride,
            l.padding, l.groups, l.dilation, l.weight_shape, l.out_spatial,
            l.valid_macs, l.oom_macs, l.bytes_moved())


def test_deconv_layer_and_vnet_encoder_match_reference():
    args = ("d", (4, 6), 8, 3, (3, 2), (2, 1), ((0, 1), (1, 0)))
    assert _facts(networks.DeconvLayer(*args)) == \
        _facts(jnet.DeconvLayer(*args))
    for sp in ((128, 128, 64), (32, 32, 16)):
        enc = networks.vnet_encoder(sp)
        assert [_facts(l) for l in enc] == \
            [_facts(l) for l in jnet.vnet_encoder(sp)]
    # the encoder and the decoder chain as one schedule
    _, report = compile_network(
        networks.vnet_encoder() + networks.vnet_decoder(),
        UniformEngine(device="cpu"))
    assert len(report.layers) == 9


def test_fig1_matches_reference():
    _close(sparsity.fig1_table(), jsp.fig1_table(), "fig1")
    assert sparsity.summarize() == jsp.summarize()
    for net in NETWORKS:
        _close([sparsity.layer_sparsity(l)
                for l in networks.benchmark_layers(net)],
               [jsp.layer_sparsity(l) for l in jnet.benchmark_layers(net)],
               net)
    for stride in (2, (2, 2), (2, 2, 2), (3, 1, 2)):
        _close(sparsity.interior_sparsity(stride),
               jsp.interior_sparsity(stride), str(stride))
    # the paper's claim: 3D layers are sparser than 2D ones
    table = sparsity.fig1_table()
    assert min(s for _, s in table["3d_gan"]) > \
        max(s for _, s in table["dcgan"][1:])


def test_table2_engines_match_reference():
    for name in ("ENGINE_2D", "ENGINE_3D"):
        got, want = getattr(tiling, name), getattr(jtil, name)
        _close(dataclasses.asdict(got), dataclasses.asdict(want), name)
        for prop in ("total_pes", "peak_macs_per_s", "adder_tree_adders"):
            _close(getattr(got, prop), getattr(want, prop), prop)
    for rank in (1, 2, 3):
        assert tiling.engine_for(rank) == tiling.FpgaEngineConfig(
            **dataclasses.asdict(jtil.engine_for(rank)))


@pytest.mark.parametrize("net", NETWORKS)
def test_fig6a_model_matches_reference(net):
    _close([dataclasses.asdict(p) for p in tiling.model_network(net)],
           [dataclasses.asdict(p) for p in jtil.model_network(net)], net)
    _close(tiling.network_summary(net), jtil.network_summary(net), net)
    # each layer on the other rank's engine too
    for tl, jl in zip(networks.benchmark_layers(net),
                      jnet.benchmark_layers(net)):
        other = 2 if tl.rank == 3 else 3
        _close(dataclasses.asdict(tiling.model_layer(
                   tl, tiling.engine_for(other))),
               dataclasses.asdict(jtil.model_layer(
                   jl, jtil.engine_for(other))), tl.name)


@pytest.mark.parametrize("net", NETWORKS)
def test_fig7_model_matches_reference(net):
    _close(comparison.modeled_comparison(net),
           jcomp.modeled_comparison(net), net)
    for name in ("CPU_E5", "GTX1080", "VC709"):
        _close(dataclasses.asdict(getattr(comparison, name)),
               dataclasses.asdict(getattr(jcomp, name)), name)


def test_measured_speedup_on_the_cpu_has_the_references_keys():
    args = ("probe", (4, 4), 8, 4, (3, 3), (2, 2), ((0, 1), (0, 1)))
    got = comparison.measured_cpu_speedup(networks.DeconvLayer(*args),
                                          repeats=1, device="cpu")
    want = jcomp.measured_cpu_speedup(jnet.DeconvLayer(*args), repeats=1)
    assert got.keys() == want.keys()
    assert got["layer"] == want["layer"]
    _close(got["mac_ratio"], want["mac_ratio"], "mac_ratio")
    assert got["t_oom_s"] > 0 and got["t_iom_s"] > 0
    assert got["measured_speedup"] == got["t_oom_s"] / got["t_iom_s"]


def test_measured_speedup_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(EngineError):
        comparison.measured_cpu_speedup(networks.DeconvLayer(
            "probe", (2, 2), 2, 2, (3, 3), (2, 2), ((0, 1), (0, 1))),
            repeats=1)


def test_gpu_blocking_fits_the_budget():
    # the reference test's channels (tests/test_sharding_analysis.py):
    # a Hopper block gathers its own rows, so the plan is the channels'
    blk = tiling.gpu_blocking(512, 512)
    assert blk.block_ci >= 8 and blk.block_co >= 8
    assert blk.smem_bytes <= blk.smem_budget == tiling.SMEM_BUDGET
    plan = tiling.plan_uniform_tiles(512, 512, mode="deconv")
    assert (blk.block_ci, blk.block_co, blk.block_m, blk.smem_bytes) \
        == (plan.block_ci, plan.block_co, plan.block_m, plan.step_smem_bytes)
    # Table II's layer 2 of each network: Tm -> block_co covers the
    # per-group output channels up to the widest tile
    for net in NETWORKS:
        l = networks.benchmark_layers(net)[1]
        blk = tiling.gpu_blocking(l.cin, l.cout)
        assert blk.block_co == min(
            b for b in tiling.KERNEL_TILES if b >= min(l.cout, 128))


@pytest.fixture(scope="module")
def reference_params():
    """The JAX package's ``real_params`` of the reduced GAN configs, as
    numpy (both in one jitted call: the eager draw compiles once per leaf
    shape, and a jit per config compiles twice)."""
    cfgs = {arch: jax_config(arch).reduced() for arch in ("gp_gan", "3d_gan")}
    p = jax.jit(lambda k: {arch: JS.real_params(cfg, k)[0]
                           for arch, cfg in cfgs.items()})(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


# the reference's interpret-mode pallas at the 2D generator alone: on the
# 3D one it costs ~9 s on the CPU, and its xla method holds the 3D path
@pytest.mark.parametrize("arch,batch,methods", [
    ("gp_gan", 2, ("pallas", "xla")), ("3d_gan", 1, ("xla",))])
def test_reduced_generator_matches_reference(arch, batch, methods,
                                             reference_params):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    params = params_from_numpy(reference_params[arch], "cpu", cfg=tcfg)
    z = np.random.RandomState(1).randn(batch, tcfg.dcnn_z).astype(np.float32)
    jgen = jax.tree_util.tree_map(jnp.asarray, reference_params[arch]["gen"])
    with torch.inference_mode():
        got = TD.generator_forward(params["gen"], tcfg, torch.from_numpy(z),
                                   UniformEngine(device="cpu")).numpy()
    last = networks.benchmark_layers(arch)[-1]
    assert got.shape == (batch, *last.out_spatial, last.cout)
    for method in methods:
        want = np.asarray(JD.generator_forward(
            jgen, jcfg, jnp.asarray(z), JaxEngine(method=method)))
        assert got.shape == want.shape
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= TOL * scale, method
