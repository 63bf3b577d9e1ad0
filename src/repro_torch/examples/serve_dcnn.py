"""Serve DCNN inference (DCGAN generation + V-Net segmentation) through
the fault-tolerant ``DcnnServer`` on the uniform engine.

Mixed-geometry requests bucket onto shared compiled schedules, a scripted
fault (optional) demonstrates the per-bucket fallback from the hand
kernels to the ``xla`` lowering (cuDNN) and the recovery, and the run
ends with the server's health/stats surface.

    python -m repro_torch.examples.serve_dcnn
    python -m repro_torch.examples.serve_dcnn --inject-faults
(``--device cpu`` serves on the kernels' plain versions on the CPU)
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--inject-faults", action="store_true",
                    help="script a persistent kernel dispatch failure to "
                         "show the per-bucket fallback + recovery")
    ap.add_argument("--telemetry", metavar="OUT_JSONL", default=None,
                    help="write the telemetry spine's event log (spans + "
                         "final metric snapshots) to this JSONL path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch import obs
    from repro_torch.runtime.dcnn_server import (
        DcnnServer,
        ServeRequest,
        dcgan_gen_spec,
        vnet_spec,
    )
    from repro_torch.runtime.faults import FaultEvent, FaultScript
    from repro_torch.runtime.serving import ServeError

    faults = None
    if args.inject_faults:
        faults = FaultScript([
            FaultEvent("error", at_call=1, match="pallas:vnet", count=4),
        ])

    telemetry = (obs.Telemetry.create(jsonl_path=args.telemetry)
                 if args.telemetry else None)
    specs = [dcgan_gen_spec(chans=(8, 4, 3)), vnet_spec(chans=(2, 4))]
    server = DcnnServer(specs, max_batch=2, probe_every=1, faults=faults,
                        telemetry=telemetry, device=args.device)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    served = 0
    for i in range(args.requests):
        if i % 2 == 0:
            x = rng.standard_normal((4, 4, 8)).astype(np.float32)
            server.submit(ServeRequest("dcgan_gen", x, deadline_s=30.0))
        else:
            # odd volume geometries bucket up to the padding multiple
            sp = (8, 8, 8) if i % 4 == 1 else (6, 7, 5)
            x = rng.standard_normal((*sp, 1)).astype(np.float32)
            server.submit(ServeRequest("vnet", x, deadline_s=30.0))
        for r in server.drain():
            served += 1
            if r.ok:
                print(f"  req{r.id} {r.model:<10s} -> {r.output.shape} "
                      f"on {r.engine} ({r.latency_s * 1e3:.1f}ms, "
                      f"bucket {r.bucket})")
            else:
                if not isinstance(r.error, ServeError):   # typed, always
                    raise TypeError(f"untyped serve error {r.error!r}")
                print(f"  req{r.id} {r.model:<10s} -> {r.code}: {r.error}")
    dt = time.perf_counter() - t0

    stats = server.stats()
    print(f"\nserved {served} requests in {dt:.2f}s "
          f"({served / dt:.1f} req/s on {server.engine.device}, host clock)")
    cache = stats["schedule_cache"]
    print(f"schedule cache: {cache['size']} resident, "
          f"{cache['hits']} hits / {cache['misses']} compiles")
    print(f"fallbacks {stats['fallbacks']}, recoveries "
          f"{stats['recoveries']}, retries {stats['retries']}, "
          f"shed {stats['shed']}, expired {stats['expired']}")
    for key, b in stats["buckets"].items():
        print(f"  bucket {key:<22s} engine={b['engine']:<6s} "
              f"batches={b['batches']} p50={b['p50_us']}us")
    health = server.health()
    print(f"health: ok={health['ok']} "
          f"fully_primary={health['fully_primary']}")
    if telemetry is not None:
        qw = telemetry.histogram("serve_queue_wait_seconds").snapshot()
        print(f"queue wait p50="
              f"{(qw['p50'] or 0) * 1e6:.0f}us over {qw['count']} takes")
        telemetry.flush_metrics()   # final instrument values -> JSONL
        telemetry.close()
        print(f"telemetry written to {args.telemetry} "
              f"({len(telemetry.tracer.ring)} events in ring)")
    print("\nserve_dcnn OK")
    return stats


if __name__ == "__main__":
    main()
