"""Serve a small LM with batched requests (prefill + lock-step decode).

    python -m repro_torch.examples.serve_lm --arch llama3.2-1b
(``--device cpu`` serves on the CPU; ``--arch`` any of the ten LM
configs at their reduced size, e.g. dbrx-132b, xlstm-350m, zamba2-2.7b,
whisper-tiny)
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.runtime.serve_loop import Request, Server

    cfg = get_config(args.arch).reduced()
    params = ST.real_params(cfg, torch.Generator().manual_seed(0),
                            args.device)
    server = Server(params, cfg, max_batch=args.requests, max_len=128,
                    device=args.device)

    rng = np.random.RandomState(0)
    for _ in range(args.requests):
        n = int(rng.randint(3, 12))
        server.submit(Request(
            prompt=[int(t) for t in rng.randint(0, cfg.vocab, n)],
            max_new_tokens=args.new_tokens))

    t0 = time.perf_counter()
    outs = server.step()
    dt = time.perf_counter() - t0
    tok = sum(len(o) for o in outs)
    print(f"served {len(outs)} reqs / {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s on {args.device})")
    for i, o in enumerate(outs):
        print(f"  req{i}: {o}")
    return outs


if __name__ == "__main__":
    main()
