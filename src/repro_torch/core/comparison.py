"""Fig. 7: CPU / GPU / FPGA relative performance and energy.

The paper reports FPGA (VC709, IOM) vs a 10-core E5 CPU and a GTX 1080 GPU:
throughput 22.7x-63.3x over CPU, energy 104.7x-291.4x over CPU and
3.3x-8.3x over GPU.  Their hosts cannot be re-measured, so (a)
``modeled_comparison`` models the platform gap from public specs (the JAX
package's platform models, verbatim: spec arithmetic, not measurements),
and (b) ``measured_cpu_speedup`` measures the OOM-vs-IOM algorithmic
speedup, the part of the gap the paper's contribution is responsible for:
on the card by default, where it also times the hand kernels, or on the
CPU when the caller asks for it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import networks
from repro_torch.core.engine import default_engine
from repro_torch.obs.report import _time_call


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    peak_tops: float        # usable peak, 16-bit ops
    watts: float
    achievable: float       # sustained fraction on deconv workloads


# Public-spec platform models (16-bit ops).
CPU_E5 = Platform("intel-e5-10c-2.8GHz", peak_tops=0.448 * 2, watts=105,
                  achievable=0.10)   # AVX2 FMA, deconv is gather-bound
GTX1080 = Platform("gtx-1080", peak_tops=8.9 * 2, watts=180, achievable=0.25)
VC709 = Platform("vc709-iom", peak_tops=2 * 2048 * 200e6 / 1e12, watts=25,
                 achievable=0.90)    # paper Fig. 6: >90% PE utilisation


def modeled_comparison(network: str = "dcgan") -> dict:
    layers = networks.benchmark_layers(network)
    valid = sum(l.valid_macs for l in layers)
    oom = sum(l.oom_macs for l in layers)
    eff = oom / valid   # zeros the FPGA (IOM) never executes

    def t(p: Platform, macs):
        return 2 * macs / (p.peak_tops * 1e12 * p.achievable)

    # CPU/GPU libraries execute the dense (zero-inserted) convolution.
    t_cpu, t_gpu = t(CPU_E5, oom), t(GTX1080, oom)
    t_fpga = t(VC709, valid)
    res = {
        "network": network,
        "oom_over_iom_macs": eff,
        "throughput_vs_cpu": t_cpu / t_fpga,
        "throughput_vs_gpu": t_gpu / t_fpga,
        "energy_vs_cpu": (t_cpu * CPU_E5.watts) / (t_fpga * VC709.watts),
        "energy_vs_gpu": (t_gpu * GTX1080.watts) / (t_fpga * VC709.watts),
        "paper_claims": {"throughput_vs_cpu": (22.7, 63.3),
                         "energy_vs_cpu": (104.7, 291.4),
                         "energy_vs_gpu": (3.3, 8.3)},
    }
    return res


def measured_cpu_speedup(layer: networks.UniformLayer | None = None,
                         batch: int = 1, repeats: int = 3, *,
                         device=None) -> dict:
    """OOM (explicit zero-insert + dense conv) against IOM-phase, measured.

    The layer defaults to DCGAN's second; its inputs are the JAX
    package's (``RandomState(0)`` draws).  On the card (``device`` None or
    CUDA) each method's time is the card's best of ``repeats`` calls after a
    warm one (``obs.report._time_call``: CUDA events behind a device-side
    sleep, so the host's time to issue the calls falls outside them); the
    hand kernels (``pallas``) are timed too, adding
    ``t_pallas_s``, ``pallas_speedup`` (``t_oom / t_pallas``) and
    ``max_rel_diff``, each method's largest difference from ``oom``'s
    output over its largest magnitude.  On the CPU the two lowerings are
    timed with the host clock and the keys are the JAX package's alone.
    """
    if layer is None:
        layer = networks.benchmark_layers("dcgan")[1]
    device = torch.device("cuda" if device is None else device)
    on_card = device.type == "cuda"
    methods = ("oom", "iom_phase") + (("pallas",) if on_card else ())
    # deconv_nd's memoized engines, made first: without a card they
    # refuse before anything moves to it
    engines = {m: default_engine(method=m, device=device) for m in methods}
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, *layer.in_spatial, layer.cin)
                         .astype(np.float32)).to(device)
    w = torch.from_numpy(rng.randn(*layer.kernel, layer.cin, layer.cout)
                         .astype(np.float32)).to(device)
    outs = {}

    def bench(method):
        def run():
            return engines[method].deconv(x, w, layer.stride, 0)
        with torch.inference_mode():
            outs[method] = run()
            if on_card:
                return _time_call(run, device, repeats)[0]
            t0 = time.perf_counter()
            for _ in range(repeats):
                run()
            return (time.perf_counter() - t0) / repeats

    t_oom = bench("oom")
    t_iom = bench("iom_phase")
    res = {"layer": layer.name, "t_oom_s": t_oom, "t_iom_s": t_iom,
           "measured_speedup": t_oom / t_iom,
           "mac_ratio": layer.oom_macs / layer.valid_macs}
    if on_card:
        t_pallas = bench("pallas")
        mag = float(outs["oom"].abs().max())
        res.update(t_pallas_s=t_pallas, pallas_speedup=t_oom / t_pallas,
                   max_rel_diff={
                       m: float((outs[m] - outs["oom"]).abs().max()) / mag
                       for m in ("iom_phase", "pallas")})
    return res
