"""Single-round-trip device->host result transfer for the decoders.

Fetching the decode outputs (olabels, ilabels, init olabels, costs) as
four separate np.asarray calls costs four device->host round trips.
Packing everything into ONE int32 buffer on device makes the host sync a
single transfer.

(ref: the reference decoder has no analogue — it is host-resident; this
is the device-side replacement for its result marshalling.)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


@jax.jit
def _pack4(ols, ils, init_ols, cost):
    """-> one [B, n_ol + n_il + n_init + 1] int32 buffer (cost bitcast)."""
    B = ols.shape[0]
    return jnp.concatenate([
        ols.reshape(B, -1).astype(jnp.int32),
        ils.reshape(B, -1).astype(jnp.int32),
        init_ols.reshape(B, -1).astype(jnp.int32),
        jax.lax.bitcast_convert_type(
            cost.astype(jnp.float32), jnp.int32).reshape(B, 1),
    ], axis=1)


def pack4(ols, ils, init_ols, cost):
    """Device-side pack; -> (packed device buffer, shapes) for unpack4."""
    return _pack4(ols, ils, init_ols, cost), (ols.shape, ils.shape,
                                              init_ols.shape)


def unpack4(buf: np.ndarray, shapes):
    """Host-side unpack of a fetched pack4 buffer."""
    shp_o, shp_i, shp_n = shapes
    n_o = int(np.prod(shp_o[1:]))
    n_i = int(np.prod(shp_i[1:]))
    n_n = int(np.prod(shp_n[1:]))
    out_o = buf[:, :n_o].reshape(shp_o)
    out_i = buf[:, n_o: n_o + n_i].reshape(shp_i)
    out_n = buf[:, n_o + n_i: n_o + n_i + n_n].reshape(shp_n)
    out_c = buf[:, -1].view(np.float32)
    return out_o, out_i, out_n, out_c


def fetch4(ols, ils, init_ols, cost):
    """Fetch the four decode outputs with ONE device->host transfer.

    -> (ols, ils, init_ols, cost) as numpy arrays with original shapes.
    """
    packed, shapes = pack4(ols, ils, init_ols, cost)
    return unpack4(np.asarray(packed), shapes)


@jax.jit
def _pack_tree_flat(leaves):
    """Flatten heterogeneous arrays into ONE int32 buffer (floats
    bitcast) so a whole output pytree costs a single device->host
    transfer."""
    parts = []
    for x in leaves:
        flat = x.reshape(-1)
        if flat.dtype == jnp.float32:
            flat = jax.lax.bitcast_convert_type(flat, jnp.int32)
        elif flat.dtype == jnp.float16:
            # two f16 per int32 word (little-endian pairing; host
            # unpacks with a uint16 view) — keeps half-precision
            # records at half the wire bytes
            pad = (-flat.shape[0]) % 2
            f = jnp.pad(flat, (0, pad))
            u = jax.lax.bitcast_convert_type(f, jnp.uint16) \
                .astype(jnp.uint32).reshape(-1, 2)
            flat = jax.lax.bitcast_convert_type(
                u[:, 0] | (u[:, 1] << 16), jnp.int32)
        elif flat.dtype == jnp.bool_:
            flat = flat.astype(jnp.int32)
        else:
            flat = flat.astype(jnp.int32)
        parts.append(flat)
    return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.int32)


def fetch_tree_async(tree):
    """Dispatch the device-side pack for a pytree of device arrays and
    return a finisher; calling it performs the ONE blocking
    device->host transfer and unpacks. The device keeps executing
    queued programs while the host delays the fetch — the overlap that
    lets a lattice-decode pipeline hide transfer time behind the next
    batch's decode."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    metas = [(x.shape, str(x.dtype)) for x in leaves]
    dev_buf = _pack_tree_flat(leaves)

    def finish():
        buf = np.asarray(dev_buf)
        out = []
        pos = 0
        for (shape, dtype) in metas:
            n = int(np.prod(shape)) if shape else 1
            if dtype == "float16":
                words = (n + 1) // 2
                chunk = buf[pos: pos + words]
                pos += words
                arr = chunk.view(np.float16)[:n]
            else:
                chunk = buf[pos: pos + n]
                pos += n
                if dtype == "float32":
                    arr = chunk.view(np.float32)
                elif dtype == "bool":
                    arr = chunk.astype(bool)
                else:
                    arr = chunk
            out.append(arr.reshape(shape))
        return jax.tree_util.tree_unflatten(treedef, out)

    return finish


def fetch_tree(tree):
    """Fetch an arbitrary pytree of device arrays with ONE transfer;
    -> same structure as numpy arrays (dtypes preserved for
    f32/bool/int32)."""
    return fetch_tree_async(tree)()
