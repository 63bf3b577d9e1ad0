"""Model configurations of the port: the ten assigned LM architectures
(shapes copied from the JAX package's registry) and the paper's four
DCNNs.  ``get_config`` takes the same names and aliases as the
reference's."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
)

ASSIGNED = [
    "whisper_tiny", "stablelm_1_6b", "llama3_2_1b", "minitron_8b",
    "granite_20b", "arctic_480b", "dbrx_132b", "xlstm_350m",
    "zamba2_2_7b", "qwen2_vl_2b",
]
PAPER_DCNNS = ["dcgan", "gp_gan", "gan3d", "vnet"]
ALL = ASSIGNED + PAPER_DCNNS

_ALIASES = {
    "whisper-tiny": "whisper_tiny", "stablelm-1.6b": "stablelm_1_6b",
    "llama3.2-1b": "llama3_2_1b", "minitron-8b": "minitron_8b",
    "granite-20b": "granite_20b", "arctic-480b": "arctic_480b",
    "dbrx-132b": "dbrx_132b", "xlstm-350m": "xlstm_350m",
    "zamba2-2.7b": "zamba2_2_7b", "qwen2-vl-2b": "qwen2_vl_2b",
    "3d-gan": "gan3d", "3d_gan": "gan3d", "gp-gan": "gp_gan",
    "v-net": "vnet", "v_net": "vnet",
}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ALL:
        raise KeyError(f"unknown architecture {arch!r}; the port has {ALL}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
