"""Training launcher (JAX ``launch/train.py``): the DCNNs and the LMs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dcgan --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch v-net \\
        --steps 2 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 100 --batch 8 --seq 128

A DCNN's convs and deconvs run on the hand kernels on the CUDA device;
with ``--device cpu`` the kernels' plain versions run instead (the JAX
package's ``--deconv-method`` has one ported value, ``pallas``).  An LM
(any of the ten configs) trains on ``TokenBatches`` of ``--batch``
sequences of ``--seq`` tokens through ``launch.steps.make_train_step``
(the bf16 forward, AdamW with the config's moment bits at the cosine
schedule's rate); its products are plain tensor code, no hand kernel.
Whisper's frames are zeros, M-RoPE's three position streams the token
positions, as in the reference.
Checkpoints go to ``--checkpoint-dir`` (``checkpoints/`` by default,
git-ignored); ``--resume`` continues from the newest valid one, its
batches from that step on.

``--dp`` trains data-parallel through ``runtime.dp_trainer``: every rank
of the world runs the step on its shard of the global batch (rounded up
to a multiple of the data axis) and the gradients are reduced as int8
values with error feedback, summed as int32 (``--no-dp-compress``: an
f32 mean).  The world is the one
``torchrun`` describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), or this
process alone when none is set; the backend is NCCL on the card and gloo
with ``--device cpu``.  ``--dp`` applies to the DCNNs only, as in the
reference.  ``--model-parallel N`` sets the mesh's model axis, as the
reference's ``make_host_mesh(model=N)``: the DCNN ``--dp`` steps reduce
over the data axis alone, so ranks along the model axis run the same
step on the same shard (the reference's ``shard_map`` leaves the axis
unmentioned).  A ``--dp`` run keeps its checkpoints apart (``<dir>-dp``,
one directory per rank: each rank's error-feedback residual is its own).

An LM under ``torchrun`` (or with ``--model-parallel`` above 1) trains
partitioned on the ``(world / N, N)`` host mesh (``launch.steps.
make_train_step(..., mesh)``): its parameters are drawn whole from the
seed and each rank keeps its block (``param_specs``: FSDP over the data
axis where the config sets ``fsdp``, heads, ff, vocab and experts over
the model axis), every rank reads the same global batches and keeps its
shard, and the checkpoint is the whole tree, written by rank 0 and
restored as each rank's blocks.

    torchrun --nproc_per_node=2 -m repro_torch.launch.train --arch dcgan \
        --reduced --dp --device cpu --steps 3
    torchrun --nproc_per_node=2 -m repro_torch.launch.train \
        --arch llama3.2-1b --reduced --model-parallel 2 --device cpu
"""

from __future__ import annotations

import argparse


def lm_extra(cfg):
    """The reference launcher's ``extra_fn`` for an LM's ``TokenBatches``:
    Whisper's stub frames, zeros ``(b, enc_seq, d_model)`` f32; M-RoPE's
    three position streams, the token positions ``(3, b, s)``."""
    import numpy as np

    def extra_fn(step, b, s):
        extra = {}
        if cfg.family == "encdec":
            extra["enc_embeds"] = np.zeros((b, cfg.enc_seq, cfg.d_model),
                                           np.float32)
        if cfg.mrope:
            extra["mrope_positions"] = np.ascontiguousarray(np.broadcast_to(
                np.arange(s, dtype=np.int32)[None, None], (3, b, s)))
        return extra
    return extra_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="dcgan | gp-gan | 3d-gan | v-net, or an LM config "
                         "(llama3.2-1b, dbrx-132b, whisper-tiny, ...)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8,
                    help="LM sequences per step")
    ap.add_argument("--seq", type=int, default=128,
                    help="LM tokens per sequence")
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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis extent of the mesh (an LM's heads, ff, "
                         "vocab and experts partition over it)")
    ap.add_argument("--dp", action="store_true",
                    help="dcnn archs: explicit data-parallel trainer over "
                         "the world (int8-compressed gradient all-reduce)")
    ap.add_argument("--no-dp-compress", action="store_true",
                    help="with --dp: plain f32 gradient all-reduce")
    args = ap.parse_args(argv)

    import os

    import torch

    from repro_torch import obs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.engine import UniformEngine
    from repro_torch.data import DcnnBatches, TokenBatches, VolumeBatches
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import dcnn as D
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.dp_trainer import record_dp_metrics
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

    telemetry = (obs.Telemetry.create(jsonl_path=args.telemetry)
                 if args.telemetry else None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    opt = AdamWConfig(lr=args.lr, state_bits=cfg.opt_state_bits)
    mesh, joined = None, False
    lm_mesh = cfg.family != "dcnn" and (
        args.model_parallel > 1 or int(os.environ.get("WORLD_SIZE", 1)) > 1)
    if lm_mesh or (args.dp and cfg.family == "dcnn"):
        joined = M.init_world(M.backend_for(device))
        try:
            mesh = M.make_host_mesh(model=args.model_parallel)
        except M.MeshError:
            if joined:
                M.leave_world()
            raise
    if mesh is not None and not lm_mesh:
        n_data = mesh.shape["data"]
        cfg = ST.round_batch_to_mesh(cfg, n_data)
        args.checkpoint_dir += "-dp"
        if mesh.size > 1:
            args.checkpoint_dir = os.path.join(args.checkpoint_dir,
                                               f"rank{mesh.rank}")
    # an LM's weights are drawn on its device (a CUDA generator draws
    # llama3.2-1b's 1.24 G in a blink, the host ~1.5e8 a second)
    gen = torch.Generator(device=device if cfg.family != "dcnn" else "cpu")
    params = ST.real_params(cfg, gen.manual_seed(0), device,
                            mesh if lm_mesh else None)
    specs = None
    compress = not args.no_dp_compress
    # a resumed run's batches continue from the checkpoint's step (the
    # reference's launcher restarts them at step 0)
    start = 0
    if args.resume:
        start = Checkpointer(args.checkpoint_dir).latest_valid_step() or 0
    if cfg.family == "dcnn":
        engine = UniformEngine(method=cfg.dcnn_method, device=device)
    if cfg.family != "dcnn":
        data = TokenBatches(cfg.vocab, args.batch, args.seq,
                            start_step=start, extra_fn=lm_extra(cfg),
                            device=device)
        step_fn = ST.make_train_step(cfg, opt, mesh)
        opt_state = adamw_init(params, opt)
        if mesh is not None:
            specs = {"params": ST.param_specs(cfg, mesh),
                     "opt": ST.opt_specs(cfg, mesh, opt)}
    elif cfg.dcnn == "v_net":
        data = VolumeBatches(cfg.dcnn_batch, D._vnet_spatial(cfg),
                             start_step=start, device=device)
        if mesh is not None:
            step_fn, err = ST.fold_dp_step(ST.make_dp_vnet_train_step(
                cfg, opt, mesh, engine, compress), n_data, params, mesh)
            opt_state = (adamw_init(params, opt), err)
        else:
            step_fn = ST.make_vnet_train_step(cfg, opt, engine)
            opt_state = adamw_init(params, opt)
    else:
        layers = D._scaled_layers(cfg)
        data = DcnnBatches(cfg.dcnn_batch, cfg.dcnn_z,
                           (*layers[-1].out_spatial, layers[-1].cout),
                           start_step=start, device=device)
        opt_state = (adamw_init(params["gen"], opt),
                     adamw_init(params["disc"], opt))
        if mesh is not None:
            step_fn, err = ST.fold_dp_step(ST.make_dp_gan_train_step(
                cfg, opt, mesh, engine, compress), n_data, params, mesh)
            opt_state = (opt_state, err)
        else:
            step_fn = ST.make_gan_train_step(cfg, opt, engine)
    if lm_mesh:
        print(f"partitioned LM: rank {mesh.rank} of {mesh.shape}, "
              f"fsdp={cfg.fsdp}, global batch {args.batch}")
    elif mesh is not None:
        print(f"dp trainer: rank {mesh.rank} of {mesh.shape}, "
              f"{'int8' if compress else 'f32'} all-reduce, global batch "
              f"{cfg.dcnn_batch}")
        if telemetry is not None:
            acct = record_dp_metrics(telemetry, params, compress=compress,
                                     n_data=n_data)
            print(f"dp wire (modelled int8): grads={acct['grads_bytes']}B "
                  f"collective={acct['collective_bytes']}B "
                  f"({acct['compress_ratio']:.2f}x compression)")
    trainer = Trainer(step_fn, params, opt_state, data,
                      TrainLoopConfig(total_steps=args.steps,
                                      checkpoint_every=args.checkpoint_every,
                                      checkpoint_dir=args.checkpoint_dir),
                      telemetry=telemetry, specs=specs, mesh=mesh)
    try:
        if args.resume:
            resumed = trainer.maybe_resume()
            print(f"resume: {'ok, step=' + str(trainer.step) if resumed else 'no checkpoint found'}")
        trainer.run()
    finally:
        if joined:
            M.leave_world()
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
