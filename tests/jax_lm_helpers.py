"""The JAX side of the LM tests that hold the port against the reference
(``tests/test_torch_lm.py``, ``test_torch_moe_ssm.py``,
``test_torch_serve_lm.py``): seeded numpy parameters of the reference's
trees, and its functions compiled with every bf16 rounding kept.

A tree is ``jax.eval_shape(init)``'s, its leaves drawn with numpy (no
``jax.random``: each shape would compile for seconds).  Norm
gains are 1 + 0.1 N(0, 1); the embedding, head and Whisper's positional
table 0.02 N(0, 1); vectors (gate biases, Mamba-2's ``a_log``,
``dt_bias``, ``d_skip``) 0.1 N(0, 1); every matrix N(0, 1/fan_in), its
fan-in the input extent of the product it enters.
"""

import numpy as np

import jax

from repro.models import transformer as JT
from repro.sharding.partition import split_params

KEY = jax.random.PRNGKey(0)


def _fan_in(name: str, shape, stacked: bool) -> int:
    """The input extent of a weight of ``shape`` (a leading layer axis
    when ``stacked``)."""
    if name.endswith("wo"):                 # [.., H, hd, D]
        return shape[-3] * shape[-2]
    if "['moe']" in name and not name.endswith("w_router"):
        return shape[-2]                    # [.., E, D, F] / [.., E, F, D]
    if name.endswith("w_r"):                # sLSTM [H, dh, 4 dh]
        return shape[-2]
    return shape[1] if stacked else shape[0]


def numpy_params(jcfg, seed: int, init=None):
    """An LM parameter tree of the JAX package's structure (its
    NamedTuples, ``None`` gates, xLSTM's layer list) with numpy leaves;
    ``init(key)`` (a block's initialiser) in place of the whole model's."""
    init = init or (lambda key: JT.init_params(jcfg, key))
    shapes = jax.eval_shape(lambda: split_params(init(KEY))[0])
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return (1 + 0.1 * rng.standard_normal(sd.shape)).astype(
                np.float32)
        # stacked [L, ...] layers, except xLSTM's list of layers
        stacked = (name.startswith(("['layers']", "['encoder_layers']"))
                   and not isinstance(path[1], jax.tree_util.SequenceKey))
        if any(k in name for k in ("embed", "lm_head", "enc_pos")):
            scale = 0.02
        elif len(sd.shape) - stacked == 1:
            scale = 0.1
        else:
            scale = _fan_in(name, sd.shape, stacked) ** -0.5
        return (scale * rng.standard_normal(sd.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def exact_jit(fn):
    """``jax.jit(fn)``, compiled at its first call with every bf16
    rounding of the program kept (no excess precision)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](*args)
    return call
