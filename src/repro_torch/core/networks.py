"""The paper's benchmark DCNNs (Section V), as uniform layer lists and graphs.

A single ``UniformLayer`` describes both directions of the engine:
``op="deconv"`` (transposed convolution, ``padding`` is the Eq. (1) border
crop) and ``op="conv"`` (forward strided convolution, ``padding`` is the
input (lo, hi) pad), so ``repro_torch.core.engine.compile_network``
schedules whole networks from one description.

All deconvolution layers use uniform 3x3 / 3x3x3 filters with stride 2, as
the paper states; the ``(0, 1)`` border crop makes each deconv exactly
double the spatial size.  Pure Python: no tensor is touched here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


def _canon_pads(padding, rank: int) -> tuple[tuple[int, int], ...]:
    if isinstance(padding, int):
        return ((padding, padding),) * rank
    out = []
    for p in tuple(padding):
        try:
            pi = int(p)
            out.append((pi, pi))
        except TypeError:
            lo, hi = p
            out.append((int(lo), int(hi)))
    if len(out) != rank:
        raise ValueError(f"padding {padding} does not have {rank} entries")
    return tuple(out)


ACTIVATIONS = ("none", "relu", "leaky_relu", "tanh")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Fused layer epilogue: bias-add + activation, executed inside the
    kernel's store.  ``bias`` records whether the layer owns a bias vector —
    the weight tree then carries ``{"w", "b"}`` instead of a bare tensor."""
    bias: bool = False
    activation: str = "none"     # "none" | "relu" | "leaky_relu" | "tanh"
    alpha: float = 0.2           # leaky_relu negative slope

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}; "
                             f"expected one of {ACTIVATIONS}")

    @property
    def is_identity(self) -> bool:
        return not self.bias and self.activation == "none"

    def describe(self) -> str:
        parts = (["bias"] if self.bias else []) \
            + ([self.activation] if self.activation != "none" else [])
        return "+".join(parts) or "-"


@dataclasses.dataclass(frozen=True)
class UniformLayer:
    """One layer of the uniform engine — a conv OR a deconv.

    ``padding`` holds per-dim ``(lo, hi)`` pairs: the border CROP after the
    Eq. (1) extent for ``op="deconv"``, the input padding for
    ``op="conv"``.  ``groups`` splits the channel algebra into independent
    blocks; weights are ``[*K, cin/groups, cout]`` (``weight_shape``).
    ``dilation`` spaces the kernel taps per dim.  ``precision`` (a
    ``repro_torch.quant.Precision``, or None for the engine's) overrides
    the engine's numeric policy for this layer, e.g. a full-precision head
    on an int8 body.
    """
    name: str
    in_spatial: tuple[int, ...]      # input spatial extent (rank 1..3)
    cin: int
    cout: int
    kernel: tuple[int, ...]
    stride: tuple[int, ...]
    padding: tuple[tuple[int, int], ...] = ()
    op: str = "deconv"               # "deconv" | "conv"
    groups: int = 1
    dilation: tuple[int, ...] = ()
    epilogue: Epilogue = Epilogue()
    precision: object | None = None

    def __post_init__(self):
        if self.op not in ("deconv", "conv"):
            raise ValueError(f"unknown op {self.op!r}; expected "
                             f"'deconv' | 'conv'")
        for f in ("in_spatial", "kernel", "stride"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
        object.__setattr__(self, "padding",
                           _canon_pads(self.padding or 0, self.rank))
        dil = self.dilation or 1
        if isinstance(dil, int):
            dil = (dil,) * self.rank
        object.__setattr__(self, "dilation", tuple(int(d) for d in dil))
        if len(self.dilation) != self.rank:
            raise ValueError(f"{self.name}: dilation {self.dilation} does "
                             f"not match rank {self.rank}")
        if self.epilogue is None:
            object.__setattr__(self, "epilogue", Epilogue())
        if self.cin % self.groups or self.cout % self.groups:
            raise ValueError(
                f"{self.name}: groups={self.groups} must divide "
                f"cin={self.cin} and cout={self.cout}")
        if self.precision is not None:
            from repro_torch.quant.precision import Precision  # lazy: torch
            if not isinstance(self.precision, Precision):
                raise ValueError(
                    f"{self.name}: precision must be a "
                    f"repro_torch.quant.Precision, got {self.precision!r}")

    @property
    def rank(self) -> int:
        return len(self.in_spatial)

    @property
    def crop(self) -> tuple[tuple[int, int], ...]:
        """The deconv border-crop reading of ``padding``."""
        return self.padding

    @property
    def effective_kernel(self) -> tuple[int, ...]:
        return tuple((k - 1) * d + 1
                     for k, d in zip(self.kernel, self.dilation))

    @property
    def weight_shape(self) -> tuple[int, ...]:
        """[*K, cin/groups, cout] — the engine's weight layout."""
        return (*self.kernel, self.cin // self.groups, self.cout)

    @property
    def out_spatial(self) -> tuple[int, ...]:
        """The output extent per dim, clipped at 0: the shape the JAX
        package's ``xla`` method gives a layer whose kernel or crop leaves
        no position (its layer algebra goes negative there)."""
        z = zip(self.in_spatial, self.stride, self.effective_kernel,
                self.padding)
        if self.op == "deconv":
            out = ((i - 1) * s + k - lo - hi for i, s, k, (lo, hi) in z)
        else:
            out = ((i + lo + hi - k) // s + 1 for i, s, k, (lo, hi) in z)
        return tuple(max(o, 0) for o in out)

    @property
    def empty(self) -> bool:
        """No kernel runs for this layer: its input or its output has no
        position (the output is then empty, or the epilogue of a zero
        sum)."""
        return 0 in self.in_spatial or 0 in self.out_spatial

    @property
    def valid_macs(self) -> int:
        """MACs the engine executes — all valid under IOM: every input
        activation times the full kernel for a deconv, every output
        activation times the full kernel for a conv."""
        sp = self.in_spatial if self.op == "deconv" else self.out_spatial
        return (math.prod(sp) * math.prod(self.kernel)
                * (self.cin // self.groups) * self.cout)

    @property
    def oom_macs(self) -> int:
        """MACs a dense conv executes over the zero-inserted input."""
        if self.op == "conv":
            return self.valid_macs
        full = tuple((i - 1) * s + k
                     for i, s, k in zip(self.in_spatial, self.stride,
                                        self.effective_kernel))
        return (math.prod(full) * math.prod(self.kernel)
                * (self.cin // self.groups) * self.cout)

    @property
    def ops(self) -> int:
        """Algorithmic op count (2 ops per valid MAC)."""
        return 2 * self.valid_macs

    def bytes_moved(self, data_width_bits: int = 16) -> int:
        """Off-chip traffic: read input + weights, write output (once each)."""
        b = data_width_bits // 8
        inp = math.prod(self.in_spatial) * self.cin
        wgt = (math.prod(self.kernel) * (self.cin // self.groups) * self.cout
               + (self.cout if self.epilogue.bias else 0))
        out = math.prod(self.out_spatial) * self.cout
        return b * (inp + wgt + out)


def scale_channels(layers: Sequence[UniformLayer], div: int = 8,
                   floor: int = 4) -> list[UniformLayer]:
    """Shrink a chain's channels by ``div`` (floored, heads <= ``floor``
    kept) and re-chain so layer i's Cout still feeds layer i+1's Cin."""
    out = []
    for l in layers:
        cin = max(floor, l.cin // div)
        cout = l.cout if l.cout <= floor else max(floor, l.cout // div)
        out.append(dataclasses.replace(l, cin=cin, cout=cout))
    for i in range(1, len(out)):
        out[i] = dataclasses.replace(out[i], cin=out[i - 1].cout)
    return out


def DeconvLayer(name, in_spatial, cin, cout, kernel, stride, crop):
    """Compat constructor: the pre-uniform deconv-only layer spec."""
    return UniformLayer(name=name, in_spatial=tuple(in_spatial), cin=cin,
                        cout=cout, kernel=tuple(kernel), stride=tuple(stride),
                        padding=tuple(crop), op="deconv")


def deconv_stack(name: str, rank: int, start: int,
                 chans: Sequence[int]) -> list[UniformLayer]:
    """A sequential stack of 3^d stride-2 exact-doubling deconvs — the GAN
    generator shape."""
    layers = []
    sp = (start,) * rank
    k = (3,) * rank
    s = (2,) * rank
    crop = ((0, 1),) * rank
    for li in range(len(chans) - 1):
        layers.append(UniformLayer(
            name=f"{name}.deconv{li + 1}", in_spatial=sp, cin=chans[li],
            cout=chans[li + 1], kernel=k, stride=s, padding=crop))
        sp = tuple(2 * v for v in sp)
    return layers


def conv_stack(name: str, in_spatial, chans: Sequence[tuple[int, int]],
               first_stride: int = 1) -> list[UniformLayer]:
    """A sequential stack of 3^d stride-2 convs (stride ``first_stride`` on
    the first layer), symmetric padding 1 — the V-Net encoder shape."""
    rank = len(in_spatial)
    layers, sp = [], tuple(in_spatial)
    for i, (ci, co) in enumerate(chans):
        s = (first_stride,) * rank if i == 0 else (2,) * rank
        lay = UniformLayer(name=f"{name}.conv{i + 1}", in_spatial=sp, cin=ci,
                           cout=co, kernel=(3,) * rank, stride=s,
                           padding=((1, 1),) * rank, op="conv")
        layers.append(lay)
        sp = lay.out_spatial
    return layers


# -- the paper's four benchmarks -------------------------------------------

def dcgan() -> list[UniformLayer]:
    """DCGAN generator (Radford et al.): 4x4x1024 -> 64x64x3, 4 deconvs."""
    return deconv_stack("dcgan", 2, 4, [1024, 512, 256, 128, 3])


def gp_gan() -> list[UniformLayer]:
    """GP-GAN blending generator decoder: 4x4x512 -> 64x64x3."""
    return deconv_stack("gp_gan", 2, 4, [512, 256, 128, 64, 3])


def gan3d() -> list[UniformLayer]:
    """3D-GAN generator (Wu et al.): 4^3 x 512 -> 64^3 x 1."""
    return deconv_stack("3d_gan", 3, 4, [512, 256, 128, 64, 1])


def vnet_decoder() -> list[UniformLayer]:
    """V-Net decoder deconvs (Milletari et al.), 128x128x64 volume."""
    layers = []
    sp = (8, 8, 4)
    for li, (ci, co) in enumerate([(256, 256), (256, 128), (128, 64),
                                   (64, 32)]):
        layers.append(UniformLayer(
            name=f"vnet.deconv{li + 1}", in_spatial=sp, cin=ci, cout=co,
            kernel=(3, 3, 3), stride=(2, 2, 2), padding=((0, 1),) * 3))
        sp = tuple(2 * v for v in sp)
    return layers


def vnet_encoder(in_spatial=(128, 128, 64)) -> list[UniformLayer]:
    """V-Net encoder convs: 5 stages, stride 1 then 2x4, ending at the
    (8, 8, 4) x 256 feature map the decoder deconvs consume, so
    ``vnet_encoder() + vnet_decoder()`` chains as one uniform schedule."""
    return conv_stack("vnet", in_spatial,
                      [(1, 16), (16, 32), (32, 64), (64, 128), (128, 256)])


BENCHMARKS = {
    "dcgan": dcgan,
    "gp_gan": gp_gan,
    "3d_gan": gan3d,
    "v_net": vnet_decoder,
}


def benchmark_layers(name: str) -> list[UniformLayer]:
    return BENCHMARKS[name]()


# -- DAG networks -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MergeNode:
    """A DAG merge point: concatenate predecessor outputs along channels
    (``kind="concat"``) or add them elementwise (``kind="add"``)."""
    name: str
    kind: str = "concat"             # "concat" | "add"

    def __post_init__(self):
        if self.kind not in ("concat", "add"):
            raise ValueError(f"unknown merge kind {self.kind!r}; expected "
                             f"'concat' | 'add'")


class UniformGraph:
    """A DAG of ``UniformLayer`` and ``MergeNode`` nodes for the engine.

    ``edges`` maps each node name to its predecessor names in consumption
    order (``UniformGraph.INPUT`` is the graph input).  Layers take exactly
    one predecessor, merges two or more.  Construction topologically sorts
    the DAG and validates every edge's (spatial, channels) shape.
    """

    INPUT = "input"

    def __init__(self, nodes, edges, output: str | None = None):
        self.nodes: dict[str, UniformLayer | MergeNode] = {}
        for nd in nodes:
            if nd.name == self.INPUT or nd.name in self.nodes:
                raise ValueError(f"duplicate/reserved node name {nd.name!r}")
            self.nodes[nd.name] = nd
        self.edges: dict[str, tuple[str, ...]] = {}
        for name, preds in edges.items():
            if name not in self.nodes:
                raise ValueError(f"edge for unknown node {name!r}")
            self.edges[name] = (preds,) if isinstance(preds, str) \
                else tuple(preds)
        for name, nd in self.nodes.items():
            preds = self.edges.get(name)
            if preds is None:
                raise ValueError(f"node {name!r} has no incoming edge")
            if isinstance(nd, MergeNode) and len(preds) < 2:
                raise ValueError(f"merge {name!r} needs >= 2 inputs, "
                                 f"got {preds}")
            if isinstance(nd, UniformLayer) and len(preds) != 1:
                raise ValueError(f"layer {name!r} takes exactly one input, "
                                 f"got {preds}")
            for p in preds:
                if p != self.INPUT and p not in self.nodes:
                    raise ValueError(f"{name!r} consumes unknown node {p!r}")
        self.order = self._topo_sort()
        self.output = output if output is not None else self.order[-1]
        if self.output not in self.nodes:
            raise ValueError(f"unknown output node {self.output!r}")
        self._shapes = self._infer_shapes()

    def _topo_sort(self) -> list[str]:
        indeg = {name: sum(p != self.INPUT for p in preds)
                 for name, preds in self.edges.items()}
        succs: dict[str, list[str]] = {name: [] for name in self.nodes}
        for name, preds in self.edges.items():
            for p in preds:
                if p != self.INPUT:
                    succs[p].append(name)
        ready = [n for n, d in indeg.items() if d == 0]
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in succs[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.nodes):
            cyc = sorted(set(self.nodes) - set(order))
            raise ValueError(f"graph has a cycle through {cyc}")
        return order

    def _infer_shapes(self):
        shapes: dict[str, tuple[tuple[int, ...], int]] = {}
        # anchor the graph-input shape on the layers that consume it
        for name, nd in self.nodes.items():
            if isinstance(nd, UniformLayer) \
                    and self.INPUT in self.edges[name]:
                got = (nd.in_spatial, nd.cin)
                if shapes.setdefault(self.INPUT, got) != got:
                    raise ValueError(
                        f"graph breaks at {name!r}: input consumers "
                        f"disagree on the graph-input shape "
                        f"({shapes[self.INPUT]} vs {got})")
        for name in self.order:
            nd = self.nodes[name]
            pin = [shapes.get(p) for p in self.edges[name]]
            if isinstance(nd, UniformLayer):
                got = pin[0]
                if got is not None and got != (nd.in_spatial, nd.cin):
                    raise ValueError(
                        f"graph breaks at {name!r}: expects "
                        f"{(nd.in_spatial, nd.cin)}, predecessor "
                        f"{self.edges[name][0]!r} produces {got}")
                shapes[name] = (nd.out_spatial, nd.cout)
                continue
            if any(p is None for p in pin):
                raise ValueError(
                    f"merge {name!r} consumes the graph input but no layer "
                    f"anchors its shape")
            sps = [sp for sp, _ in pin]
            if any(sp != sps[0] for sp in sps):
                raise ValueError(f"merge {name!r} spatial mismatch: {sps}")
            chans = [c for _, c in pin]
            if nd.kind == "concat":
                shapes[name] = (sps[0], sum(chans))
            else:
                if any(c != chans[0] for c in chans):
                    raise ValueError(
                        f"add-merge {name!r} channel mismatch: {chans}")
                shapes[name] = (sps[0], chans[0])
        return shapes

    def node_shape(self, name: str) -> tuple[tuple[int, ...], int]:
        """(spatial, channels) produced by ``name`` (or the graph input)."""
        return self._shapes[name]

    @property
    def in_shape(self) -> tuple[tuple[int, ...], int]:
        return self._shapes[self.INPUT]

    @property
    def out_shape(self) -> tuple[tuple[int, ...], int]:
        return self._shapes[self.output]

    @property
    def layers(self) -> list[UniformLayer]:
        """The layer nodes in schedule (topological) order."""
        return [self.nodes[n] for n in self.order
                if isinstance(self.nodes[n], UniformLayer)]


def chain_graph(layers: Sequence[UniformLayer]) -> UniformGraph:
    """Lift a linear chain into a ``UniformGraph`` (layer i feeds i+1)."""
    edges, prev = {}, UniformGraph.INPUT
    for l in layers:
        edges[l.name] = (prev,)
        prev = l.name
    return UniformGraph(list(layers), edges)


def vnet_graph(in_spatial=(128, 128, 64), chans=(16, 32, 64, 128, 256),
               cin: int = 1, num_classes: int = 2,
               name: str = "vnet") -> UniformGraph:
    """Full V-Net (Milletari et al.) as ONE engine graph: encoder convs,
    decoder deconvs, skip concatenations (``MergeNode``) and merge convs,
    each with its relu epilogue fused, ending in the 1x1x1 head.

    Spatial extents must stay even through the encoder so the stride-2
    deconvs re-align with their skips exactly.
    """
    rank = len(in_spatial)
    relu = Epilogue(activation="relu")
    nodes: list[UniformLayer | MergeNode] = []
    edges: dict[str, tuple[str, ...]] = {}
    prev, sp, ci = UniformGraph.INPUT, tuple(in_spatial), cin
    enc_out = []                       # (name, channels, spatial) per stage
    for i, co in enumerate(chans):
        stride = (1,) * rank if i == 0 else (2,) * rank
        if i > 0 and any(v % 2 for v in sp):
            raise ValueError(f"vnet_graph needs even spatial at every "
                             f"downsample; stage {i} sees {sp}")
        lay = UniformLayer(name=f"{name}.enc{i + 1}", in_spatial=sp, cin=ci,
                           cout=co, kernel=(3,) * rank, stride=stride,
                           padding=((1, 1),) * rank, op="conv",
                           epilogue=relu)
        nodes.append(lay)
        edges[lay.name] = (prev,)
        prev, sp, ci = lay.name, lay.out_spatial, co
        enc_out.append((lay.name, co, sp))
    for i, (skip_name, skip_c, skip_sp) in enumerate(reversed(enc_out[:-1])):
        up = UniformLayer(name=f"{name}.up{i + 1}", in_spatial=sp, cin=ci,
                          cout=skip_c, kernel=(3,) * rank,
                          stride=(2,) * rank, padding=((0, 1),) * rank,
                          op="deconv", epilogue=relu)
        nodes.append(up)
        edges[up.name] = (prev,)
        cat = MergeNode(name=f"{name}.skip{i + 1}", kind="concat")
        nodes.append(cat)
        edges[cat.name] = (up.name, skip_name)
        merge = UniformLayer(name=f"{name}.merge{i + 1}", in_spatial=skip_sp,
                             cin=2 * skip_c, cout=skip_c,
                             kernel=(3,) * rank, stride=(1,) * rank,
                             padding=((1, 1),) * rank, op="conv",
                             epilogue=relu)
        nodes.append(merge)
        edges[merge.name] = (cat.name,)
        prev, sp, ci = merge.name, skip_sp, skip_c
    head = UniformLayer(name=f"{name}.head", in_spatial=sp, cin=ci,
                        cout=num_classes, kernel=(1,) * rank,
                        stride=(1,) * rank, padding=0, op="conv")
    nodes.append(head)
    edges[head.name] = (prev,)
    return UniformGraph(nodes, edges, output=head.name)
