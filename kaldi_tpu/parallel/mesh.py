"""Device mesh construction and sharding rules.

Replaces the reference's distributed backend (NFS + qsub job arrays,
SURVEY.md §2.11): gradients and sufficient statistics reduce with psum over
collectives inside one jit program; model-parallel shardings cover the case where
the output (pdf) layer exceeds one chip.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """2-D mesh ('data', 'model'). Defaults to all devices on 'data'."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data is None:
        data = n // model
    assert data * model == n, (data, model, n)
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def data_parallel_sharding(mesh: Mesh):
    """(batch_sharding, replicated_sharding) for the common DP case."""
    return (NamedSharding(mesh, P("data")), NamedSharding(mesh, P()))


def tdnn_param_sharding(mesh: Mesh, params) -> dict:
    """Sharding pytree for Tdnn params: final affine sharded over 'model'
    (output/pdf dim), hidden layers replicated."""
    def leaf_spec(path, leaf):
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if "final" in names:
            if leaf.ndim == 2:
                return NamedSharding(mesh, P(None, "model"))
            return NamedSharding(mesh, P("model"))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(leaf_spec, params)


def batch_sharding(mesh: Mesh, ndim: int):
    """Shard leading (batch) dim over 'data'."""
    return NamedSharding(mesh, P(*(["data"] + [None] * (ndim - 1))))


def decode_sharded(decoder, loglikes, num_frames, mesh: Mesh):
    """Batched decode with the utterance batch sharded over the mesh's
    'data' axis — the replacement for job-array decode sharding
    (`$cmd JOB=1:N gmm-latgen-faster`, SURVEY.md §2.11: utterance-level
    shell parallelism becomes a sharded batch dim; GSPMD partitions the
    whole decode program, graph tables replicated, frontier sharded).

    B must be divisible by the data-axis size. Works with both
    DenseViterbiDecoder and BeamSearchDecoder.
    """
    B = loglikes.shape[0]
    ddim = mesh.shape["data"]
    assert B % ddim == 0, (B, ddim)
    ll = jax.device_put(jnp.asarray(loglikes),
                        batch_sharding(mesh, 3))
    with mesh:
        return decoder.decode(ll, np.asarray(num_frames))
