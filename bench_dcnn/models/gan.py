"""A GAN's generator through the program: ``models/dcnn.py::
generator_forward`` on one ``UniformEngine`` (the hand kernels)."""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core.engine import UniformEngine
from repro_torch.models import dcnn as D


class Program:
    def __init__(self, cfg: dict, device):
        pcfg = get_config(cfg["port_config"])
        if cfg.get("port_reduced"):
            pcfg = pcfg.reduced()
        gen = D._generator_graph(pcfg.dcnn, pcfg.dcnn_reduced).layers
        found = {"z_dim": pcfg.dcnn_z,
                 "start_spatial": list(gen[0].in_spatial),
                 "channels": [l.cin for l in gen] + [gen[-1].cout]}
        wanted = {k: list(v) if isinstance(v, (list, tuple)) else v
                  for k, v in cfg.items() if k in found}
        if found != wanted:
            raise ValueError(f"the program's generator is {found}, the "
                             f"configuration {wanted}")
        self.pcfg = pcfg
        self.engine = UniformEngine(device=device)

    def forward(self, params, z):
        return D.generator_forward(params["gen"], self.pcfg, z, self.engine)
