"""Shared set-up of the ``test_torch_*`` tests: one tiny GPT-2-class
configuration for both packages, and seeded dense parameters built once in
numpy and handed to both.

At d_model 256, d_ff 1024 and vocab 500 every projection has ≥ 2^16
elements, so the JAX package's ``quantize_params_int8`` turns each into an
int8 pack and the int8 decode path is what the tests compare.
"""

import jax.numpy as jnp
import numpy as np
import torch

from rten_tpu.models import decoder as jdec
from rten_tpu_torch.models import decoder as tdec

SLICE_CFG = dict(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024, max_seq=256)


def configs():
    """(JAX config, port config) of the slice tests, in f32."""
    return (
        jdec.DecoderConfig(**SLICE_CFG, dtype=jnp.float32),
        tdec.DecoderConfig(**SLICE_CFG, dtype=torch.float32),
    )


def dense_tree(seed: int = 0) -> dict:
    """Dense params as numpy arrays in the JAX package's tree layout, with
    random biases and norm parameters (the packages' own inits make them
    zeros and ones, which would leave those paths untested) and weights
    large enough that greedy decoding has clear winners."""
    rng = np.random.default_rng(seed)
    c = SLICE_CFG
    d, ff, v = c["d_model"], c["d_ff"], c["vocab_size"]

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm():
        return {"scale": rng.uniform(0.8, 1.2, d).astype(np.float32), "bias": w(d, scale=0.05)}

    tree = {
        "tok_emb": w(v, d, scale=0.5),
        "pos_emb": w(c["max_seq"], d, scale=0.2),
        "final_norm": norm(),
        "layers": [],
    }
    for _ in range(c["n_layers"]):
        tree["layers"].append(
            {
                "ln1": norm(), "ln2": norm(),
                "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
                "bq": w(d, scale=0.05), "bk": w(d, scale=0.05), "bv": w(d, scale=0.05),
                "bo": w(d, scale=0.05),
                "w_up": w(d, ff), "b_up": w(ff, scale=0.05),
                "w_down": w(ff, d, scale=0.04), "b_down": w(d, scale=0.05),
            }
        )
    return tree


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def unfold(leaf, head_dim: int) -> np.ndarray:
    """A JAX cache leaf (folded [B, Hk, S·D/128, 128] or not) as [B, Hk, S, D]."""
    leaf = np.asarray(leaf)
    b, hk = leaf.shape[:2]
    return leaf.reshape(b, hk, -1, head_dim)
