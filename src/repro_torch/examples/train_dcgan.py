"""End-to-end driver: train the (reduced) DCGAN generator/discriminator for
a few hundred steps through the fault-tolerant Trainer, with checkpointing
and resume.  ``--method`` configures ONE ``UniformEngine`` that drives the
WHOLE GAN step: with ``--method pallas`` the generator's deconvolutions
AND the discriminator's strided convs run on the hand-written Hopper
kernels, forward and backward, every layer planned once by the engine's
plan cache.

    python -m repro_torch.examples.train_dcgan --steps 200 --method pallas
(``--full`` for the paper-size generator; ``--device cpu`` runs the
kernels' plain versions on the CPU, slowly at full width; ``--dp`` trains
data-parallel over the world through ``runtime.dp_trainer``, int8
gradient all-reduce with error feedback: under ``torchrun
--nproc_per_node=N`` on N ranks, else on this process alone)
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--method", default="iom_phase",
                    choices=["oom", "xla", "iom", "iom_phase", "pallas"])
    ap.add_argument("--dp", action="store_true",
                    help="explicit data-parallel trainer over the world")
    ap.add_argument("--no-dp-compress", action="store_true")
    ap.add_argument("--checkpoint-dir", default="checkpoints/dcgan")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import UniformEngine
    from repro_torch.data import DcnnBatches
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import dcnn as D
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

    cfg = get_config("dcgan")
    if not args.full:
        cfg = cfg.reduced()
    engine = UniformEngine(method=args.method, device=args.device)
    mesh, joined = None, False
    if args.dp:
        joined = M.init_world(M.backend_for(engine.device))
        mesh = M.make_host_mesh()
        cfg = ST.round_batch_to_mesh(cfg, mesh.shape["data"])
    opt = AdamWConfig(lr=2e-4, b1=0.5, weight_decay=0.0)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0),
                            engine.device)
    opt_state = (adamw_init(params["gen"], opt),
                 adamw_init(params["disc"], opt))
    layers = D._scaled_layers(cfg)
    data = DcnnBatches(cfg.dcnn_batch, cfg.dcnn_z,
                       (*layers[-1].out_spatial, layers[-1].cout),
                       device=engine.device)
    # both GAN halves run as compiled graphs on this one engine: print the
    # generator's schedule (fused bias+relu/tanh epilogues) up front
    print(D.generator_schedule(cfg, engine, batch=cfg.dcnn_batch).describe())
    if mesh is not None:
        n_data = mesh.shape["data"]
        dp_step = ST.make_dp_gan_train_step(
            cfg, opt, mesh, engine=engine,
            compress=not args.no_dp_compress)
        step, err = ST.fold_dp_step(dp_step, n_data, params, mesh)
        opt_state = (opt_state, err)
        # the dp opt state carries the error-feedback residual, each rank
        # its own: keep its checkpoints apart from non-dp runs
        args.checkpoint_dir += "-dp"
        if mesh.size > 1:
            args.checkpoint_dir += f"/rank{mesh.rank}"
        print(f"dp trainer: {n_data}-way data parallel, "
              f"{'int8' if not args.no_dp_compress else 'f32'} all-reduce, "
              f"global batch {cfg.dcnn_batch}")
    else:
        step = ST.make_gan_train_step(cfg, opt, engine=engine)
    # the losses are logged every 20 steps, and at the last of a shorter run
    tr = Trainer(step, params, opt_state, data,
                 TrainLoopConfig(total_steps=args.steps,
                                 checkpoint_every=max(args.steps // 4, 1),
                                 log_every=max(1, min(20, args.steps)),
                                 checkpoint_dir=args.checkpoint_dir))
    try:
        if tr.maybe_resume():
            print(f"resumed from step {tr.step}")
        tr.run()
    finally:
        if joined:
            M.leave_world()
    print(f"done at step {tr.step} (stragglers logged: "
          f"{tr.straggler_events})")
    return tr


if __name__ == "__main__":
    main()
