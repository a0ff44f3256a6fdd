"""1-D convolution along the feature (frequency) axis + max pooling.

(ref: nnet/nnet-convolutional-component.h Convolutional1dComponent —
 patches of `patch_dim` filterbank bins with `patch_step` stride convolved
 by `num_filters` filters; nnet/nnet-max-pooling-component.h
 MaxPoolingComponent. Realized as XLA conv_general_dilated — directly
 tensor-core-shaped, unlike the reference's im2col GEMM.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass
class Conv1dConfig:
    input_dim: int
    patch_dim: int
    patch_step: int
    num_filters: int

    @property
    def num_patches(self) -> int:
        return 1 + (self.input_dim - self.patch_dim) // self.patch_step

    @property
    def output_dim(self) -> int:
        return self.num_patches * self.num_filters


def conv1d_init(key, cfg: Conv1dConfig):
    s = 1.0 / np.sqrt(cfg.patch_dim)
    return {
        "filters": s * jax.random.normal(
            key, (cfg.num_filters, cfg.patch_dim), jnp.float32),
        "bias": jnp.zeros((cfg.num_filters,), jnp.float32),
    }


def conv1d_apply(params, x: jnp.ndarray, cfg: Conv1dConfig) -> jnp.ndarray:
    """x [..., input_dim] -> [..., num_patches * num_filters], filter-major
    per patch (matches the reference's patch-stacked layout)."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, cfg.input_dim)     # [N, C=1, W]
    out = jax.lax.conv_general_dilated(
        flat, params["filters"][:, None, :],   # [O, I=1, K]
        window_strides=(cfg.patch_step,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"))
    out = out + params["bias"][None, :, None]
    # [N, F, P] -> [N, P*F] with patch-major ordering
    out = jnp.swapaxes(out, 1, 2).reshape(*lead, -1)
    return out


def max_pooling_apply(x: jnp.ndarray, pool_size: int, pool_step: int,
                      pool_stride: int) -> jnp.ndarray:
    """(ref: MaxPoolingComponent — input viewed as [pool_stride-column
    groups]; pools of `pool_size` groups with step `pool_step` max-reduced.)
    x [..., num_groups * pool_stride] -> [..., num_pools * pool_stride]."""
    lead = x.shape[:-1]
    num_groups = x.shape[-1] // pool_stride
    g = x.reshape(*lead, num_groups, pool_stride)
    num_pools = 1 + (num_groups - pool_size) // pool_step
    pools = [g[..., i * pool_step: i * pool_step + pool_size, :].max(-2)
             for i in range(num_pools)]
    return jnp.stack(pools, axis=-2).reshape(*lead, -1)
