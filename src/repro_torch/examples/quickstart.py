"""Quickstart: the paper's uniform 2D/3D engine in five minutes: ONE
configured engine, compiled schedules, deconvolutions AND forward strided
convolutions on the hand-written Hopper kernels.

    python -m repro_torch.examples.quickstart [--device cpu]

Its mesh sections run on the world it finds: the one ``torchrun``
describes, else this process alone (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs, tune
    from repro_torch.core import (
        EngineConfig,
        MeshPolicy,
        Precision,
        UniformEngine,
        compile_network,
        deconv_macs,
        deconv_nd,
        init_network_weights,
        insertion_sparsity,
        networks,
        shard_batch,
    )
    from repro_torch.launch import mesh as M
    from repro_torch.runtime.dp_trainer import grad_wire_bytes
    from repro_torch.quant import quantize_weights
    from repro_torch.runtime.dcnn_server import (
        DcnnServer,
        ServeRequest,
        vnet_spec,
    )
    from repro_torch.tree import tree_map

    dev = torch.device(args.device)
    # the engine of the sections below, made first: without a card it
    # refuses before anything moves to one
    engine = UniformEngine(method="pallas", device=dev)
    rng = np.random.RandomState(0)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def on_dev(ws):
        return tree_map(lambda t: t.to(dev), ws)

    def max_err(a, b):
        return float((a - b).abs().max())

    print("=== 3D deconvolution, K=3, S=2 (the paper's uniform config) ===")
    x = tensor(rng.randn(1, 8, 8, 8, 16))             # [N,D,H,W,Ci]
    w = tensor(rng.randn(3, 3, 3, 16, 32))            # [K,K,K,Ci,Co]

    outs = {m: deconv_nd(x, w, 2, 1, method=m, device=dev)
            for m in ("oom", "xla", "iom", "iom_phase", "pallas")}
    base = outs["oom"]
    for m, y in outs.items():
        print(f"  {m:<10s} out={tuple(y.shape)}  "
              f"max|err vs OOM|={max_err(y, base):.2e}")

    iom = deconv_macs((8, 8, 8), (3, 3, 3), 16, 32, method="iom", stride=2)
    oom = deconv_macs((8, 8, 8), (3, 3, 3), 16, 32, method="oom", stride=2)
    print(f"\n  MACs: OOM={oom:,}  IOM={iom:,}  -> {oom / iom:.1f}x fewer "
          f"(paper: ~S^3 = 8x)")
    print(f"  insertion sparsity seen by OOM: "
          f"{100 * insertion_sparsity((8, 8, 8), (3, 3, 3), (2, 2, 2)):.1f}%")

    print("\n=== ONE configured engine: no method strings, no tuning kwargs "
          "===")
    # The engine's configuration is decided once (method, precision,
    # shared-memory budget, tile overrides, device); every call names the
    # geometry, and the geometry-keyed cache runs the tile planner once per
    # layer shape.
    x2 = tensor(rng.randn(1, 8, 8, 16))
    w2 = tensor(rng.randn(3, 3, 16, 32))
    y2 = engine.deconv(x2, w2, 2, 1)          # 2D: the same engine
    yc = engine.conv(y2, w2.transpose(-2, -1), 2, 1)   # and BACK down
    print(f"  engine.deconv out={tuple(y2.shape)}  engine.conv out="
          f"{tuple(yc.shape)}")
    ref2 = deconv_nd(x2, w2, 2, 1, method="oom", device=dev)
    print(f"  max|err vs OOM|={max_err(y2, ref2):.2e}"
          f"  cached plans={len(engine.plan_cache)}")

    print("\n=== compile_network: whole networks from per-layer schedules "
          "===")
    # The software analogue of the paper's mapping tables: compile a
    # UniformLayer chain once, get (a) a callable running every layer on
    # the engine and (b) the per-layer schedule (tile plan, shared memory,
    # CUDA blocks, insertion sparsity the engine never touches).
    layers = networks.deconv_stack("demo", 2, 4, [16, 8, 3])   # DCGAN tail
    apply, report = compile_network(layers, engine)
    ws = on_dev(init_network_weights(layers,
                                     torch.Generator().manual_seed(0)))
    z = tensor(rng.randn(2, 4, 4, 16))
    out = apply(ws, z)
    print(f"  compiled forward out={tuple(out.shape)}")
    print("  " + report.describe().replace("\n", "\n  "))

    xla_apply, _ = compile_network(layers,
                                   UniformEngine(method="xla", device=dev))
    print(f"  max|err vs XLA engine|={max_err(out, xla_apply(ws, z)):.2e}")

    print("\n=== UniformGraph: whole DAGs, V-Net with REAL skip merges ===")
    # A UniformGraph's nodes are layers or concat/add merges, scheduled
    # topologically: vnet_graph builds the full encoder/decoder with its
    # skip concatenations, each layer's relu fused into the kernel
    # epilogue.  Merge nodes get zero-cost report rows.
    vgraph = networks.vnet_graph(in_spatial=(8, 8, 8), chans=(2, 4, 8),
                                 cin=1)
    vapply, vreport = compile_network(vgraph, engine)
    vws = on_dev(init_network_weights(vgraph,
                                      torch.Generator().manual_seed(1)))
    vol = tensor(rng.randn(1, 8, 8, 8, 1) * 0.3)
    logits = vapply(vws, vol)
    print(f"  V-Net graph: {len(vgraph.layers)} layers + "
          f"{sum(1 for r in vreport.layers if r.plan is None)} skip merges, "
          f"logits={tuple(logits.shape)}")
    print("  " + vreport.describe().replace("\n", "\n  "))

    # Layers also take groups (depthwise = groups==cin), per-dim dilation
    # and a fused Epilogue(bias, activation): the same engine and kernels
    dw = networks.UniformLayer(
        name="dw", in_spatial=(16, 16), cin=8, cout=8, kernel=(3, 3),
        stride=(1, 1), padding=((2, 2),) * 2, op="conv", groups=8,
        dilation=(2, 2), epilogue=networks.Epilogue(bias=True,
                                                    activation="relu"))
    _, dreport = compile_network(networks.chain_graph([dw]), engine)
    print("  depthwise dilated row: "
          + dreport.describe().splitlines()[-1].strip())

    print("\n=== training runs fully on the uniform kernels ===")
    # The ops' autograd Functions serve both gradients from the hand
    # kernels: the deconv's dx is a conv and the conv's a deconv, and dw
    # has a kernel of its own, so a train step never leaves them; the
    # backward plans live in the same engine cache.
    wg = w2.clone().requires_grad_()
    g, = torch.autograd.grad((engine.deconv(x2, wg, 2, 1) ** 2).sum(), wg)
    gc, = torch.autograd.grad((engine.conv(x2, wg, 2, 1) ** 2).sum(), wg)
    print(f"  deconv dL/dw shape={tuple(g.shape)}  "
          f"|g|={float(g.abs().max()):.3f}")
    print(f"  conv   dL/dw shape={tuple(gc.shape)}  "
          f"|g|={float(gc.abs().max()):.3f}")
    print(f"  engine cache now holds {len(engine.plan_cache)} plans "
          f"(fwd + bwd per geometry)")

    print("\n=== scale it out: the same schedule on a device mesh ===")
    # Give the EngineConfig a mesh and compile_network partitions the
    # schedule: the batch shards over the "data" axis, channels optionally
    # Megatron-style over the "model" axis (Cout on one layer, Cin and an
    # all-reduce on the next), and the report's rows become per rank:
    # local tile plans, per-rank blocks, and the collective payloads the
    # partition costs.  Each rank's apply takes its shard of the batch.
    # One process is a (1, 1) mesh; under torchrun --nproc_per_node=N the
    # same code runs N ranks.
    joined = M.init_world(M.backend_for(dev))
    try:
        mesh = M.make_host_mesh()                  # (world size, 1)
        sharded = UniformEngine(EngineConfig(
            method="pallas", device=dev, mesh=mesh,
            policy=MeshPolicy(batch_axis="data", model_axis="model")))
        dp = mesh.shape["data"]
        apply_s, report_s = compile_network(layers, sharded, batch=2 * dp)
        zs = tensor(rng.randn(2 * dp, 4, 4, 16))
        out_s = apply_s(ws, shard_batch(zs, mesh))
        ref_s = shard_batch(apply(ws, zs), mesh)   # the unsharded engine
        print(f"  {dp}-way data parallel out={tuple(out_s.shape)} per rank"
              f"  max|err vs unsharded|={max_err(out_s, ref_s):.2e}")
        print(f"  per-rank batch={report_s.per_device_batch}  "
              f"collective payload/fwd={report_s.collective_bytes}B")
        print("  " + report_s.describe().replace("\n", "\n  "))

        print("\n=== training scales the same way: the explicit dp "
              "trainer ===")
        # repro_torch.launch.steps.make_dp_gan_train_step /
        # make_dp_vnet_train_step run the SAME engine on each rank's batch
        # shard and reduce the gradients through runtime.dp_trainer:
        # quantized to int8 with error feedback and summed as int32 (the
        # reference models an int8 wire, a quarter of the f32 bytes; the
        # int32 sum carries as many as f32), identical AdamW updates on
        # every rank.  See train_dcgan --dp and segment_vnet3d --dp.
        acct = grad_wire_bytes(ws, compress=True)
        print(f"  mesh {mesh.shape} ready; the demo chain's gradients: "
              f"{acct['grads_bytes']}B f32, {acct['collective_bytes']}B "
              f"on the modelled int8 wire ({acct['compress_ratio']:.2f}x; "
              f"the int32 sum hands the collective 4 B per element)")
    finally:
        if joined:
            M.leave_world()

    print("\n=== serve it: the fault-tolerant inference tier ===")
    # DcnnServer wraps the compiled schedules in a serving loop: a bounded
    # queue that sheds load with typed errors, per-request deadlines, a
    # shape-bucketed LRU of compiled schedules (odd geometries pad up to
    # their bucket and crop back), retry-with-backoff, and per-bucket
    # degradation from the hand kernels to the xla lowering and back.  See
    # repro_torch.examples.serve_dcnn (--inject-faults scripts a failure).
    server = DcnnServer([vnet_spec(chans=(2, 4))], max_batch=2, device=dev)
    server.submit(ServeRequest("vnet",
                               rng.randn(8, 8, 8, 1).astype(np.float32),
                               deadline_s=30.0))
    server.submit(ServeRequest("vnet",             # odd geometry: buckets
                               rng.randn(6, 7, 5, 1).astype(np.float32)))
    for r in server.drain():
        print(f"  req{r.id} -> {r.output.shape} on {r.engine} "
              f"(bucket {r.bucket}, {r.latency_s * 1e3:.1f}ms)")
    sstats = server.stats()
    print(f"  queue shed={sstats['shed']} expired={sstats['expired']} "
          f"fallbacks={sstats['fallbacks']} schedules="
          f"{sstats['schedule_cache']['size']}")

    print("\n=== observe it: ONE telemetry spine for the whole stack ===")
    # repro_torch.obs.Telemetry bundles a metrics registry with a span
    # tracer.  Hand it to EngineConfig(telemetry=...) and the engine
    # records plan-cache hits, compile times and dispatch walls; servers
    # and trainers take the same object.
    tel = obs.Telemetry.create()
    obs_engine = UniformEngine(EngineConfig(method="pallas", telemetry=tel,
                                            device=dev))
    oapply, _ = compile_network(vgraph, obs_engine)
    oapply(vws, vol)                                   # dispatch timed
    snap = tel.registry.snapshot()
    print(f"  {len(snap)} instruments after one compile+dispatch; e.g.")
    for key in list(snap)[:3]:
        print(f"    {key}: {snap[key]}")

    # measure_network closes the loop on the paper's Fig. 6: run every
    # node of the compiled graph, join its measured time against the
    # schedule's valid MACs and normalise by the roof (REPRO_PEAK_GFLOPS or
    # a calibration probe on the engine's device)
    rpt = obs.measure_network(vgraph, obs_engine, name="vnet", repeats=1)
    print("  " + rpt.describe().replace("\n", "\n  "))

    # and the exporters render the registry for scrapers:
    prom = obs.render_prometheus(tel.registry)
    print("  prometheus text, first lines:")
    for line in prom.splitlines()[:4]:
        print(f"    {line}")

    print("\n=== tune it: search the plan space once, remember forever ===")
    # plan_uniform_tiles is first-fit; repro_torch.tune searches every
    # tile of the route x both split policies per geometry under a
    # calibrated latency model, measures the model's top-k, and persists
    # the winners in a versioned TunedPlanCache.  Handed to
    # EngineConfig(tuned_plans=), it answers every engine.plan() of a
    # tuned geometry before the heuristic.  The sweep driver is
    # `python -m repro_torch.launch.tune`.
    cache, tuned = tune.tune_network(layers, trials=16, measure_topk=1,
                                     repeats=1, device=dev)
    for t in tuned:
        print(f"  {t.key}: {t.plan.describe()} [{t.entry.winner_source}]"
              f" from {t.candidates} candidates")
    with tempfile.TemporaryDirectory() as tmp:
        path = cache.save(f"{tmp}/tuned_plans.json")
        tuned_engine = UniformEngine(EngineConfig(
            method="pallas", tuned_plans=tune.TunedPlanCache.load(path),
            device=dev))
    tapply, _ = compile_network(layers, tuned_engine)
    print(f"  reloaded cache -> plan sources {tuned_engine.plan_sources} "
          f"(zero search), max|err vs heuristic engine|="
          f"{max_err(tapply(ws, z), out):.2e}")

    print("\n=== quantize it: int8 weights behind ONE Precision policy ===")
    # The engine's numeric policy is a frozen Precision on the
    # EngineConfig.  quantize_weights maps any compile_network weight tree
    # to {"w_q": int8, "scale": f32} entries, and the SAME compiled
    # schedule accepts them: int8 weights reach the kernels as 1-byte
    # operands (the TF32 tensor-core route beside f32 activations) and the
    # per-channel dequant runs in the fused epilogue (scale -> bias ->
    # activation), with the same launches and smaller shared-memory
    # stages.
    q8 = Precision(weight_quant="int8")       # per-cout scales, f32 sums
    q8_engine = UniformEngine(EngineConfig(method="pallas", precision=q8,
                                           device=dev))
    q8_apply, q8_report = compile_network(layers, q8_engine)
    wq = quantize_weights(ws, q8)             # {"w_q", "scale"} per layer
    out_q8 = q8_apply(wq, z)
    err = max_err(out_q8, out)
    scale = float(out.abs().max())
    print(f"  int8-weight forward out={tuple(out_q8.shape)}  "
          f"max|err vs f32|={err:.2e} ({100 * err / scale:.2f}% of range)")
    print(f"  launches: f32 {report.kernel_launches} vs q8 "
          f"{q8_report.kernel_launches} (equal); peak shared memory "
          f"{report.peak_smem_bytes}B -> {q8_report.peak_smem_bytes}B")
    print("  " + q8_report.describe().replace("\n", "\n  "))

    print("\nquickstart OK")


if __name__ == "__main__":
    main()
