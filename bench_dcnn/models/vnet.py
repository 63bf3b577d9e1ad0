"""V-Net through the program: ``models/dcnn.py::vnet_forward`` to serve,
``launch/steps.py::make_vnet_train_step`` to train, on one
``UniformEngine`` (the hand kernels).  The training modules are imported
by the training calls alone, so an inference cell does not load them."""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core.engine import UniformEngine
from repro_torch.models import dcnn as D


class Program:
    def __init__(self, cfg: dict, device):
        pcfg = get_config(cfg["port_config"])
        if cfg.get("port_reduced"):
            pcfg = pcfg.reduced()
        chans = [co for _, co in D._vnet_chans(pcfg)]
        if chans != list(cfg["channels"]) or cfg["in_channels"] != 1:
            raise ValueError(f"the program's V-Net has channels {chans} "
                             f"from one input channel, the configuration "
                             f"{cfg['channels']} from {cfg['in_channels']}")
        self.pcfg = pcfg
        self.engine = UniformEngine(device=device)

    def forward(self, params, vol):
        return D.vnet_forward(params["vnet"], self.pcfg, vol, self.engine)

    def train_step(self, opt: dict):
        from repro_torch.launch.steps import make_vnet_train_step
        from repro_torch.optim import AdamWConfig
        return make_vnet_train_step(self.pcfg, AdamWConfig(**opt),
                                    self.engine)

    def opt_init(self, params, opt: dict):
        from repro_torch.optim import AdamWConfig, adamw_init
        return adamw_init(params, AdamWConfig(**opt))

    def first_moments(self, state):
        return state.m

    def losses(self, metrics) -> dict:
        return {"loss": metrics["loss"]}
