"""3D example: V-Net segmenting synthetic spheres, the paper's volumetric
benchmark.  ``--method`` configures ONE ``UniformEngine`` for the whole
model; with ``--method pallas`` the encoder convs, decoder deconvs,
skip-merge convs and the 1x1x1 head all run on the hand-written Hopper
kernels, each layer geometry planned once by the engine's cache.

    python -m repro_torch.examples.segment_vnet3d --steps 60 --method pallas
(``--device cpu`` runs the kernels' plain versions on the CPU; ``--dp``
trains data-parallel over the world through ``runtime.dp_trainer``, int8
gradient all-reduce with error feedback: under ``torchrun
--nproc_per_node=N`` on N ranks, else on this process alone)
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--method", default="iom_phase")
    ap.add_argument("--dp", action="store_true",
                    help="explicit data-parallel trainer over the world")
    ap.add_argument("--no-dp-compress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import UniformEngine
    from repro_torch.data import VolumeBatches
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import dcnn as D
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config("vnet").reduced()
    engine = UniformEngine(method=args.method, device=args.device)
    mesh, joined = None, False
    if args.dp:
        joined = M.init_world(M.backend_for(engine.device))
        mesh = M.make_host_mesh()
        cfg = ST.round_batch_to_mesh(cfg, mesh.shape["data"])
    opt = AdamWConfig(lr=1e-3, weight_decay=0.0)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0),
                            engine.device)
    opt_state = adamw_init(params, opt)
    data = VolumeBatches(cfg.dcnn_batch, D._vnet_spatial(cfg),
                         prefetch=False, device=engine.device)
    # the whole V-Net is ONE compiled graph on the engine: print its
    # schedule (encoder/decoder layers, skip-concat merge rows, fused
    # epilogues) before training starts
    print(D.vnet_schedule(cfg, engine, batch=cfg.dcnn_batch).describe())
    if mesh is not None:
        n_data = mesh.shape["data"]
        dp_step = ST.make_dp_vnet_train_step(
            cfg, opt, mesh, engine=engine, compress=not args.no_dp_compress)
        step, err = ST.fold_dp_step(dp_step, n_data, params, mesh)
        opt_state = (opt_state, err)
        print(f"dp trainer: {n_data}-way data parallel, global batch "
              f"{cfg.dcnn_batch}")
    else:
        step = ST.make_vnet_train_step(cfg, opt, engine=engine)

    losses = []
    try:
        for i in range(args.steps):
            params, opt_state, m = step(params, opt_state,
                                        data.make_batch(i))
            losses.append(float(m["loss"]))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  dice+ce loss {losses[-1]:.4f}")
    finally:
        if joined:
            M.leave_world()

    # evaluate IoU on a fresh volume
    batch = data.make_batch(10_000)
    with torch.inference_mode():
        logits = D.vnet_forward(params["vnet"], cfg, batch["vol"], engine)
    pred = logits.argmax(-1).cpu().numpy()
    lab = batch["labels"].cpu().numpy()
    inter = ((pred == 1) & (lab == 1)).sum()
    union = ((pred == 1) | (lab == 1)).sum()
    iou = inter / max(union, 1)
    print(f"IoU on held-out volumes: {iou:.3f}")
    return {"losses": losses, "iou": float(iou)}


if __name__ == "__main__":
    main()
