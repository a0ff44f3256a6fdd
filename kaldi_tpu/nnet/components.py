"""Neural-net building blocks, functional style.

(ref: nnet2/nnet-component.h:157-1718 — the pieces of the production DNN:
 AffineComponent, PnormComponent :514, NormalizeComponent :555,
 SpliceComponent :1092, plus the simple nonlinearities; and their nnet3
 equivalents nnet3/nnet-simple-component.h:42-842.)

Each component is (init(key, ...) -> params, apply(params, x) -> y); models
compose them. Splicing over time offsets is a clamped gather along T — the
Tensor expression of SpliceComponent / nnet3 Append(Offset(...)).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def splice(x: jnp.ndarray, context: tuple[int, ...]) -> jnp.ndarray:
    """x [..., T, D] -> [..., T, D*len(context)], clamped at edges.

    (ref: nnet2/nnet-component.h:1092 SpliceComponent; the clamping matches
    frame-level eg extraction where edge frames replicate.)
    """
    T = x.shape[-2]
    outs = []
    for off in context:
        idx = jnp.clip(jnp.arange(T) + off, 0, T - 1)
        outs.append(jnp.take(x, idx, axis=-2))
    return jnp.concatenate(outs, axis=-1)


def splice_valid(x: jnp.ndarray, context: tuple[int, ...]) -> jnp.ndarray:
    """Valid-only splice: output T' = T - (max(ctx) - min(ctx)).

    Matches nnet3's exact-index computation (no padding invented).
    """
    lo, hi = min(context), max(context)
    T = x.shape[-2]
    Tout = T - (hi - lo)
    outs = [jax.lax.slice_in_dim(x, off - lo, off - lo + Tout, axis=-2)
            for off in context]
    return jnp.concatenate(outs, axis=-1)


def affine_init(key, in_dim: int, out_dim: int,
                param_stddev: float | None = None, bias_stddev: float = 1.0):
    """(ref: nnet2 AffineComponent init: stddev 1/sqrt(in_dim))"""
    if param_stddev is None:
        param_stddev = 1.0 / math.sqrt(in_dim)
    kw, kb = jax.random.split(key)
    return {
        "w": param_stddev * jax.random.normal(kw, (in_dim, out_dim), jnp.float32),
        "b": bias_stddev * jax.random.normal(kb, (out_dim,), jnp.float32),
    }


def affine_apply(params, x):
    return jnp.matmul(x, params["w"]) + params["b"]


def pnorm(x: jnp.ndarray, output_dim: int, p: float = 2.0) -> jnp.ndarray:
    """Group p-norm: [..., D] -> [..., output_dim], D % output_dim == 0.

    (ref: nnet2/nnet-component.h:514 PnormComponent)
    """
    D = x.shape[-1]
    assert D % output_dim == 0, (D, output_dim)
    g = D // output_dim
    xg = x.reshape(x.shape[:-1] + (output_dim, g))
    if p == 2.0:
        return jnp.sqrt(jnp.sum(xg * xg, axis=-1) + 1e-20)
    return jnp.power(jnp.sum(jnp.power(jnp.abs(xg), p), axis=-1) + 1e-20,
                     1.0 / p)


def normalize(x: jnp.ndarray, target_rms: float = 1.0) -> jnp.ndarray:
    """Renormalize rows to unit RMS (ref: nnet2 NormalizeComponent :555)."""
    d = x.shape[-1]
    scale = target_rms * jax.lax.rsqrt(
        jnp.mean(jnp.square(x), axis=-1, keepdims=True) + 1e-20)
    return x * scale


def maxout(x: jnp.ndarray, output_dim: int) -> jnp.ndarray:
    """(ref: nnet2 MaxoutComponent)"""
    D = x.shape[-1]
    g = D // output_dim
    return jnp.max(x.reshape(x.shape[:-1] + (output_dim, g)), axis=-1)


def dropout(key, x: jnp.ndarray, proportion: float) -> jnp.ndarray:
    """(ref: nnet2 DropoutComponent — scale-preserving)"""
    keep = 1.0 - proportion
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


ACTIVATIONS = {
    "relu": jax.nn.relu,                 # RectifiedLinearComponent
    "sigmoid": jax.nn.sigmoid,           # SigmoidComponent
    "tanh": jnp.tanh,                    # TanhComponent
    "softsign": lambda x: x / (1 + jnp.abs(x)),
}


def fixed_affine(x, mat, bias=None):
    """(ref: nnet2 FixedAffineComponent — e.g. LDA-like input transform)"""
    y = jnp.matmul(x, mat)
    return y + bias if bias is not None else y
