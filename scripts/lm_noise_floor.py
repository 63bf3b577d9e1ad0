"""How far an LM's f32 logits move when only the summation order of its
products changes, at full width on the CPU: the model's own noise floor,
against which a card-vs-CPU comparison is read.

The port's seeded parameters (``real_params`` from a seeded CPU
``torch.Generator``) serve 8 prompts of 16 tokens: an f32 prefill, then
three decode calls against an f32 decode cache, once with ``--threads``
host threads and once with ``--other-threads`` (the CPU's matrix products
split their sums by thread, so the second run rounds elsewhere).  It
prints one JSON line: each call's max |diff| / max |logit| between the two
runs, the reference's KV-cache continuation (one token decoded from the
spliced f32 cache of a 2 x 8 prefill against the prefill over the 9
tokens) as max |diff| / max |logit|, and, with ``--jax``, the JAX
package's prefill logits on the same parameters (carried leaf for leaf)
against the port's.  ``--grads`` gives the train step's floor instead:
the gradients of the loss on one ``TokenBatches`` batch (``--batch`` x
``--seq``, the launcher's 8 x 128), its forward at f32 and at bf16, each
leaf's max |diff| / max |g| (the worst leaf's, per dtype) between the two
thread counts, and between the whole batch's gradient and the mean of
its two halves' (the same sum in another order: the CPU's f32 products
may not split by thread at all), and the losses' relative differences.

    PYTHONPATH=src python scripts/lm_noise_floor.py --arch xlstm-350m --jax
    PYTHONPATH=src python scripts/lm_noise_floor.py --arch zamba2-2.7b
    PYTHONPATH=src python scripts/lm_noise_floor.py --arch xlstm-350m \
        --grads

``--layers`` cuts the depth (the widths stay the config's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.runtime.serve_loop import splice


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def f32_cache(cache):
    return {k: v if k == "pos" else tree.tree_map(torch.Tensor.float, v)
            for k, v in cache.items()}


def batch(cfg, toks):
    b = {"tokens": toks}
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.zeros(toks.shape[0], cfg.enc_seq,
                                      cfg.d_model)
    return b


def serve(params, cfg, toks, calls=4):
    """The prefill's and ``calls - 1`` decode calls' last logits."""
    with torch.inference_mode():
        logits, pc = T.forward(params, cfg, batch(cfg, toks),
                               mode="prefill", param_dtype=torch.float32)
        cache = splice(f32_cache(T.init_cache(params, cfg, toks.shape[0],
                                              128)), pc, toks.shape[1])
        out = [logits[:, -1]]
        for _ in range(calls - 1):
            logits, cache = T.forward(
                params, cfg, batch(cfg, torch.full((toks.shape[0], 1), 7)),
                mode="decode", cache=cache, param_dtype=torch.float32)
            out.append(logits[:, -1])
    return out


def continuation(params, cfg) -> float:
    toks = torch.arange(16).reshape(2, 8) % cfg.vocab
    seven = torch.full((2, 1), 7)
    with torch.inference_mode():
        full, _ = T.forward(params, cfg,
                            batch(cfg, torch.cat([toks, seven], 1)),
                            mode="prefill", param_dtype=torch.float32)
        _, pc = T.forward(params, cfg, batch(cfg, toks), mode="prefill",
                          param_dtype=torch.float32)
        cache = splice(f32_cache(T.init_cache(params, cfg, 2, 16)), pc, 8)
        dec, _ = T.forward(params, cfg, {"tokens": seven}, mode="decode",
                           cache=cache, param_dtype=torch.float32)
    return rel(dec, full)


def jax_prefill(params, cfg, toks):
    """The JAX package's f32 prefill logits on the port's parameters."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro.sharding.partition import split_params

    jcfg = dataclasses.replace(jax_config(cfg.name), n_layers=cfg.n_layers)
    shapes = jax.eval_shape(
        lambda: split_params(JT.init_params(jcfg, jax.random.PRNGKey(0)))[0])
    flat, treedef = jax.tree_util.tree_flatten(shapes)
    ours = tree.leaves(params)
    assert [tuple(s.shape) for s in flat] == [tuple(v.shape) for v in ours]
    jparams = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(v.numpy()) for v in ours])
    b = {"tokens": jnp.asarray(toks.numpy(), jnp.int32)}
    if cfg.family == "encdec":
        b["enc_embeds"] = jnp.zeros((toks.shape[0], cfg.enc_seq,
                                     cfg.d_model))
    logits, _ = jax.jit(lambda p, b_: JT.forward(
        p, jcfg, b_, mode="prefill", param_dtype=jnp.float32))(jparams, b)
    return torch.from_numpy(np.asarray(logits[:, -1], np.float32))


def grads(params, cfg, batch_size: int, seq: int):
    """Per dtype: (loss, gradient tree) of one train step's forward on
    the first ``TokenBatches`` batch."""
    from repro_torch.data import TokenBatches
    from repro_torch.launch.train import lm_extra

    b = TokenBatches(cfg.vocab, batch_size, seq, prefetch=False,
                     extra_fn=lm_extra(cfg), device="cpu").make_batch(0)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        loss, _, g = ST.lm_grads(params, cfg, b, dt)
        out[str(dt).split(".")[1]] = (float(loss), g, b)
    return out


def halves(params, cfg, b, dt):
    """(loss, gradients) of ``b`` as the mean of its two halves'."""
    h = b["tokens"].shape[0] // 2
    parts = [ST.lm_grads(params, cfg, {k: (v[:, sl] if k == "mrope_positions"
                                           else v[sl]) for k, v in b.items()},
                         dt) for sl in (slice(0, h), slice(h, None))]
    return (sum(float(p[0]) for p in parts) / 2,
            tree.tree_map(lambda x, y: (x + y) / 2, parts[0][2], parts[1][2]))


def grads_floor(params, cfg, args) -> dict:
    torch.set_num_threads(args.threads)
    base = grads(params, cfg, args.batch, args.seq)
    torch.set_num_threads(args.other_threads)
    other = grads(params, cfg, args.batch, args.seq)
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "threads": [args.threads, args.other_threads],
           "batch": [args.batch, args.seq]}
    for dt, (loss, g, b) in base.items():
        loss_o, g_o, _ = other[dt]
        row[f"grads_{dt}_threads_rel_err"] = max(
            rel(a, b) for a, b in zip(tree.leaves(g_o), tree.leaves(g)))
        row[f"loss_{dt}_threads_rel_err"] = abs(loss_o - loss) / abs(loss)
        loss_h, g_h = halves(params, cfg, b, getattr(torch, dt))
        row[f"grads_{dt}_halves_rel_err"] = max(
            rel(a, b) for a, b in zip(tree.leaves(g_h), tree.leaves(g)))
        row[f"loss_{dt}_halves_rel_err"] = abs(loss_h - loss) / abs(loss)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--threads", type=int, default=torch.get_num_threads())
    ap.add_argument("--other-threads", type=int, default=3)
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--grads", action="store_true",
                    help="the train step's gradients, f32 and bf16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = ST.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if args.grads:
        # without remat: the same values and gradients, bit for bit
        row = grads_floor(params, dataclasses.replace(cfg, remat=False),
                          args)
        print(json.dumps(row))
        return row
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab, (8, 16)))
    torch.set_num_threads(args.threads)
    base = serve(params, cfg, toks)
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "threads": [args.threads, args.other_threads],
           "continuation_f32_rel_err": continuation(params, cfg)}
    if args.jax:
        row["jax_vs_port_prefill_rel_err"] = rel(
            base[0], jax_prefill(params, cfg, toks))
    torch.set_num_threads(args.other_threads)
    other = serve(params, cfg, toks)
    row["threads_rel_err"] = [rel(a, b) for a, b in zip(other, base)]
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
