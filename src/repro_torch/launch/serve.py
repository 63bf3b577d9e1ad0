"""LM serving launcher (JAX ``launch/serve.py``): batched prefill + decode
over a request queue.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --no-reduced --requests 8 --new-tokens 16

``--arch`` takes any of the ten LM configs (``configs.ASSIGNED``, or
their hyphenated names): dense, VLM, MoE, xLSTM, the Zamba2 hybrid and
Whisper.  It runs on the CUDA device unless ``--device cpu`` is given.
The configuration is the reduced one unless ``--no-reduced`` asks for
the full width (the reference's ``--reduced`` has no way to be turned
off).
The weights are random, drawn from a seeded ``torch.Generator``, and the
prompts are drawn as the reference draws them.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.runtime.serve_loop import Request, Server

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = ST.real_params(cfg, torch.Generator().manual_seed(0),
                            args.device)
    server = Server(params, cfg, max_batch=args.requests,
                    max_len=args.max_len, device=args.device)

    rng = np.random.RandomState(0)
    for _ in range(args.requests):
        plen = int(rng.randint(4, 17))
        server.submit(Request(
            prompt=[int(t) for t in rng.randint(0, cfg.vocab, plen)],
            max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    outs = server.step()
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"served {len(outs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o[:12]}...")
    return outs


if __name__ == "__main__":
    main()
