"""Fig. 1: zero-insertion sparsity of 2D vs 3D DCNN layers.

The paper observes that after 'zero' insertion the input feature maps of 3D
deconvolution layers are sparser than those of 2D layers, which drives the
PE-workload imbalance that IOM removes.  This is the exact sparsity seen by
the OOM dense convolution (inserted zeros + full-conv border padding):
pure arithmetic over ``networks.benchmark_layers``, as in the JAX package.
"""

from __future__ import annotations

import math

from repro_torch.core import networks
from repro_torch.core.functional import insertion_sparsity


def layer_sparsity(layer: networks.UniformLayer) -> float:
    return insertion_sparsity(layer.in_spatial, layer.kernel, layer.stride)


def interior_sparsity(stride) -> float:
    """Asymptotic (border-free) sparsity: 1 - 1/prod(S)."""
    s = math.prod(stride) if not isinstance(stride, int) else stride
    return 1.0 - 1.0 / s


def fig1_table() -> dict[str, list[tuple[str, float]]]:
    """Per-layer sparsity for the 2D (DCGAN) and 3D (3D-GAN) examples."""
    out = {}
    for net in ("dcgan", "3d_gan"):
        rows = [(l.name, layer_sparsity(l))
                for l in networks.benchmark_layers(net)]
        out[net] = rows
    return out


def summarize() -> str:
    lines = ["Fig.1 — insertion sparsity (fraction of zero-valued MAC "
             "operands under OOM)"]
    table = fig1_table()
    for net, rows in table.items():
        for name, s in rows:
            lines.append(f"  {name:<18s} {100 * s:6.2f}%")
        mean = sum(s for _, s in rows) / len(rows)
        lines.append(f"  {net} mean       {100 * mean:6.2f}%")
    s2 = sum(s for _, s in table["dcgan"]) / len(table["dcgan"])
    s3 = sum(s for _, s in table["3d_gan"]) / len(table["3d_gan"])
    lines.append(f"  claim check: 3D sparsity ({100 * s3:.1f}%) > "
                 f"2D sparsity ({100 * s2:.1f}%): {s3 > s2}")
    return "\n".join(lines)
