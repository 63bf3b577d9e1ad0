"""Model configurations of the port: the paper's four DCNNs.

The LM architectures of the JAX package's registry wait for their ROADMAP
item; ``get_config`` accepts the same names and aliases for the DCNNs.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

PAPER_DCNNS = ["dcgan", "gp_gan", "gan3d", "vnet"]

_ALIASES = {
    "3d-gan": "gan3d", "3d_gan": "gan3d", "gp-gan": "gp_gan",
    "v-net": "vnet", "v_net": "vnet",
}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in PAPER_DCNNS:
        raise KeyError(f"unknown architecture {arch!r}; the port has "
                       f"{PAPER_DCNNS} (the LM configs are ROADMAP item 15)")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
