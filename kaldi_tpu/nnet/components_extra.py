"""Remaining nnet2 component zoo members: DCT, block-affine, additive
noise.

(ref: nnet2/nnet-component.h — DctComponent (applies a DCT over
 contiguous sub-blocks of the feature dim, optionally reordered),
 BlockAffineComponent :870 (block-diagonal affine: num_blocks
 independent affines over equal slices), AdditiveNoiseComponent
 (train-time Gaussian noise injection).)

All are pure functions on arrays; the DCT is a matmul,
the block affine is one batched matmul over the block dim.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n, n] (ref: matrix/matrix-functions.h:92
    ComputeDctMatrix)."""
    m = np.zeros((n, n))
    for k in range(n):
        for j in range(n):
            m[k, j] = math.cos(math.pi / n * (j + 0.5) * k)
    m[0] *= math.sqrt(1.0 / n)
    m[1:] *= math.sqrt(2.0 / n)
    return m


def dct_component(x: jnp.ndarray, dct_dim: int, dct_keep_dim: int = 0,
                  reorder: bool = False) -> jnp.ndarray:
    """Apply a DCT to each contiguous dct_dim block of the feature axis,
    keeping the first dct_keep_dim coefficients (0 = all)
    (ref: nnet2 DctComponent — dim % dct_dim == 0; reorder=True means the
    input is laid out [coeff-major] instead of [block-major])."""
    D = x.shape[-1]
    assert D % dct_dim == 0, (D, dct_dim)
    nb = D // dct_dim
    keep = dct_keep_dim or dct_dim
    M = jnp.asarray(dct_matrix(dct_dim)[:keep].T, x.dtype)  # [dct, keep]
    if reorder:
        xb = x.reshape(*x.shape[:-1], dct_dim, nb)
        xb = jnp.swapaxes(xb, -1, -2)                       # [..., nb, dct]
    else:
        xb = x.reshape(*x.shape[:-1], nb, dct_dim)
    y = jnp.matmul(xb, M)                                   # [..., nb, keep]
    if reorder:
        y = jnp.swapaxes(y, -1, -2)
    return y.reshape(*x.shape[:-1], nb * keep)


def block_affine_init(key, input_dim: int, output_dim: int,
                      num_blocks: int, param_stddev: float | None = None):
    """(ref: nnet2 BlockAffineComponent — num_blocks independent affines
    over equal input/output slices)."""
    assert input_dim % num_blocks == 0 and output_dim % num_blocks == 0
    bi, bo = input_dim // num_blocks, output_dim // num_blocks
    if param_stddev is None:
        param_stddev = 1.0 / math.sqrt(bi)
    kw, kb = jax.random.split(key)
    return {
        "w": param_stddev * jax.random.normal(kw, (num_blocks, bi, bo),
                                              jnp.float32),
        "b": jnp.zeros((num_blocks * bo,), jnp.float32),
    }


def block_affine_apply(params, x: jnp.ndarray) -> jnp.ndarray:
    """[..., num_blocks*bi] -> [..., num_blocks*bo]: one batched matmul
    over the block dim (no python loop)."""
    nb, bi, bo = params["w"].shape
    xb = x.reshape(*x.shape[:-1], nb, bi)
    y = jnp.einsum("...ni,nio->...no", xb, params["w"])
    return y.reshape(*x.shape[:-1], nb * bo) + params["b"]


def additive_noise(key, x: jnp.ndarray, stddev: float) -> jnp.ndarray:
    """Train-time Gaussian noise (ref: nnet2 AdditiveNoiseComponent)."""
    return x + stddev * jax.random.normal(key, x.shape, x.dtype)
