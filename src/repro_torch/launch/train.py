"""Training launcher for the DCNNs (the DCNN path of JAX
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dcgan --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch v-net \\
        --steps 2 --reduced --device cpu

Every conv and deconv runs on the hand kernels on the CUDA device; with
``--device cpu`` the kernels' plain versions run instead (the JAX
package's ``--deconv-method`` has one ported value, ``pallas``).
Checkpoints go to ``--checkpoint-dir`` (``checkpoints/`` by default,
git-ignored); ``--resume`` continues from the newest valid one.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="dcgan | gp-gan | 3d-gan | v-net")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--telemetry", metavar="OUT_JSONL", default=None,
                    help="record step-time metrics + spans to this JSONL "
                         "event log")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.engine import UniformEngine
    from repro_torch.data import DcnnBatches, VolumeBatches
    from repro_torch.launch import steps as ST
    from repro_torch.models import dcnn as D
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

    telemetry = (obs.Telemetry.create(jsonl_path=args.telemetry)
                 if args.telemetry else None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    engine = UniformEngine(method=cfg.dcnn_method, device=args.device)
    device = engine.device
    opt = AdamWConfig(lr=args.lr)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), device)
    if cfg.dcnn == "v_net":
        data = VolumeBatches(cfg.dcnn_batch, D._vnet_spatial(cfg),
                             device=device)
        step_fn = ST.make_vnet_train_step(cfg, opt, engine)
        opt_state = adamw_init(params, opt)
    else:
        layers = D._scaled_layers(cfg)
        data = DcnnBatches(cfg.dcnn_batch, cfg.dcnn_z,
                           (*layers[-1].out_spatial, layers[-1].cout),
                           device=device)
        step_fn = ST.make_gan_train_step(cfg, opt, engine)
        opt_state = (adamw_init(params["gen"], opt),
                     adamw_init(params["disc"], opt))
    trainer = Trainer(step_fn, params, opt_state, data,
                      TrainLoopConfig(total_steps=args.steps,
                                      checkpoint_every=args.checkpoint_every,
                                      checkpoint_dir=args.checkpoint_dir),
                      telemetry=telemetry)
    if args.resume:
        resumed = trainer.maybe_resume()
        print(f"resume: {'ok, step=' + str(trainer.step) if resumed else 'no checkpoint found'}")
    trainer.run()
    print(f"finished at step {trainer.step}; "
          f"stragglers={trainer.straggler_events}")
    if telemetry is not None:
        snap = telemetry.histogram("train_step_seconds").snapshot()
        if snap["count"]:
            print(f"step time p50={snap['p50'] * 1e3:.1f}ms "
                  f"p99={snap['p99'] * 1e3:.1f}ms over "
                  f"{snap['count']} steps")
        telemetry.flush_metrics()
        telemetry.close()
        print(f"telemetry written to {args.telemetry}")
    return trainer


if __name__ == "__main__":
    main()
