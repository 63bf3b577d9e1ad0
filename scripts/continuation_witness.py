"""The reference's KV-cache continuation check in both packages, on the
same parameters, at full width on the CPU.

``tests/test_models.py::test_decode_matches_prefill_continuation`` decodes
one token from a bf16 cache spliced from an f32 prefill of 2 x 8 tokens
and holds its logits against an f32 prefill over the 9 tokens, with
``rtol=5e-2, atol=5e-3``.  This script runs that arithmetic in the JAX
package and in ``repro_torch`` on one parameter tree: drawn by the port's
``real_params`` from a seeded ``torch.Generator`` (as ``chip_smoke.py``'s
"serve (LM)" phase draws it) and carried to the JAX package leaf for leaf.
For each package it prints one JSON line: ``of_absolute_tol``, the
largest |decode - prefill| / (5e-3 + 5e-2 |prefill|) (the test fails
above 1), the same with the atol taken as 5e-3 of max |logit|
(``of_scaled_tol``), max |diff| / max |logit| and max |logit|; and how
far the two packages' decode logits lie apart.

    PYTHONPATH=src python scripts/continuation_witness.py \\
        --arch llama3.2-1b --layers 2 4

``--layers`` cuts the depth (the widths stay the config's); without it
the model runs at its full depth, which for llama3.2-1b holds the f32
weights twice in host memory (about 10 GB).  ``--reduced`` runs the
test's own ``reduced()`` size instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.sharding.partition import split_params
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T

RTOL, ATOL = 5e-2, 5e-3


def carried(params, jcfg):
    """The port's tree as the JAX package's, leaf for leaf."""
    shapes = jax.eval_shape(
        lambda: split_params(JT.init_params(jcfg, jax.random.PRNGKey(0)))[0])
    flat, treedef = jax.tree_util.tree_flatten(shapes)
    ours = tree.leaves(params)
    assert len(flat) == len(ours), (len(flat), len(ours))
    for sd, v in zip(flat, ours):
        assert tuple(sd.shape) == tuple(v.shape), (sd.shape, v.shape)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(v.numpy()) for v in ours])


def jax_continuation(params, cfg):
    """The reference test's arithmetic, line for line."""
    toks = jnp.arange(2 * 8).reshape(2, 8) % cfg.vocab
    ext = jnp.concatenate([toks, jnp.full((2, 1), 7, jnp.int32)], axis=1)
    full, _ = JT.forward(params, cfg, {"tokens": ext}, mode="prefill",
                         param_dtype=jnp.float32)
    _, pc = JT.forward(params, cfg, {"tokens": toks}, mode="prefill",
                       param_dtype=jnp.float32)
    cache = JT.init_cache(params, cfg, 2, 16)
    kv = tuple(
        jax.lax.dynamic_update_slice_in_dim(big, small.astype(big.dtype), 0,
                                            axis=2)
        for big, small in zip(cache["kv"], pc["kv"]))
    cache = {"kv": kv, "pos": jnp.asarray(8, jnp.int32)}
    dec, _ = JT.forward(params, cfg, {"tokens": jnp.full((2, 1), 7,
                                                         jnp.int32)},
                        mode="decode", cache=cache, param_dtype=jnp.float32)
    return np.asarray(dec), np.asarray(full)


def port_continuation(params, cfg):
    """The same arithmetic through ``repro_torch`` on the CPU."""
    with torch.inference_mode():
        toks = torch.arange(2 * 8).reshape(2, 8) % cfg.vocab
        ext = torch.cat([toks, torch.full((2, 1), 7)], dim=1)
        full, _ = T.forward(params, cfg, {"tokens": ext}, mode="prefill",
                            param_dtype=torch.float32)
        _, pc = T.forward(params, cfg, {"tokens": toks}, mode="prefill",
                          param_dtype=torch.float32)
        cache = T.init_cache(params, cfg, 2, 16)
        for big, small in zip(cache["kv"], pc["kv"]):
            big[:, :, :8] = small.to(big.dtype)
        dec, _ = T.forward(params, cfg, {"tokens": torch.full((2, 1), 7)},
                           mode="decode", cache={**cache, "pos": 8},
                           param_dtype=torch.float32)
    return dec.numpy(), full.numpy()


def measures(dec, full) -> dict:
    diff = np.abs(dec.astype(np.float64) - full)
    scale = float(np.abs(full).max())
    rtol_part = RTOL * np.abs(full.astype(np.float64))
    return {"of_absolute_tol": float((diff / (ATOL + rtol_part)).max()),
            "of_scaled_tol": float((diff / (ATOL * scale
                                            + rtol_part)).max()),
            "rel_err": float(diff.max()) / scale, "max_logit": scale}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--layers", type=int, nargs="*", default=[0],
                    help="depths to run (0: the config's own)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(torch.get_num_threads(), 8)))
    for layers in args.layers:
        cfg, jcfg = get_config(args.arch), jax_config(args.arch)
        if args.reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
            jcfg = dataclasses.replace(jcfg, n_layers=layers)
        params = ST.real_params(cfg, torch.Generator().manual_seed(
            args.seed), "cpu")
        jparams = carried(params, jcfg)
        jdec, jfull = jax_continuation(jparams, jcfg)
        del jparams
        dec, full = port_continuation(params, cfg)
        del params
        row = {"arch": args.arch, "reduced": args.reduced,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "vocab": cfg.vocab, "seed": args.seed,
               "jax": measures(jdec, jfull), "port": measures(dec, full),
               "decode_port_vs_jax": float(np.abs(dec - jdec).max()
                                           / np.abs(jdec).max()),
               "prefill_port_vs_jax": float(np.abs(full - jfull).max()
                                            / np.abs(jfull).max())}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
