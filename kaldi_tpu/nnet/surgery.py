"""Model surgery for TDNN acoustic models: widen, shrink, rank-limit,
fix dead/saturated units, replace the output layer, per-layer lr scales.

(ref: the nnet2bin model-surgery tool family —
 nnet2/widen-nnet.h WidenNnet (bin nnet-am-widen),
 nnet2/shrink-nnet.h ShrinkNnet (bin nnet-am-shrink: optimize per-layer
   scales on held-out frames),
 nnet2bin/nnet-am-limit-rank.cc (SVD-factor each affine),
 nnet2/nnet-fix.h FixNnet (bin nnet-am-fix: rescale dead / oversaturated
   hidden units),
 nnet2bin/nnet-replace-last-layers.cc + nnet2bin/nnet-insert.cc (transfer
   a trained stack onto a new output layer / tree),
 nnet2bin/nnet-modify-learning-rates.cc (per-layer learning rates).

Accelerator-first shape: all surgery is pure functions params -> params on the
Tdnn pytree (kaldi_tpu/nnet/tdnn.py); "learning rates" become an optax
multi_transform label tree instead of mutable component state.)
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax


def widen(params: dict, config, new_hidden_dim: int, key,
          new_unit_stddev_scale: float = 1e-4) -> dict:
    """Grow every hidden layer's output dim to new_hidden_dim
    (ref: nnet2/widen-nnet.h WidenNnet — new units get ZERO outgoing
    weights so the network function is unchanged at the moment of
    widening, and small random incoming weights so gradient can revive
    them during further training).

    Our relu layers are followed by NormalizeComponent-style RMS
    normalization, whose scale is a MEAN over the unit dim: growing the
    dim from D to D' multiplies every old unit's normalized output by
    k = sqrt(D'/D) (the new units contribute ~0 to the mean square).
    The successor's old input rows are scaled by 1/k so the function is
    preserved exactly, unlike a naive append.

    Only relu nets; pnorm ties hidden_dim to the group structure, which
    the reference does not widen either.
    """
    if config.nonlinearity == "pnorm":
        raise ValueError("widen() applies to relu nets; pnorm group "
                         "structure ties hidden_dim to output_dim")
    old = config.hidden_dim
    add = new_hidden_dim - old
    if add <= 0:
        return params
    k = math.sqrt(new_hidden_dim / old)
    layers = [dict(l) for l in params["layers"]]
    keys = jax.random.split(key, len(layers))
    for i, layer in enumerate(layers):
        in_dim = layer["w"].shape[0]
        stddev = new_unit_stddev_scale / math.sqrt(in_dim)
        neww = stddev * jax.random.normal(keys[i], (in_dim, add), jnp.float32)
        layer["w"] = jnp.concatenate([layer["w"], neww], axis=1)
        layer["b"] = jnp.concatenate(
            [layer["b"], jnp.zeros((add,), jnp.float32)])
        # successor's input rows: one block of `old` rows per splice offset,
        # old rows scaled by 1/k (RMS-normalize dim change), new rows zero
        nxt_ctx = (config.splice_indexes[i + 1]
                   if i + 1 < len(config.splice_indexes) else (0,))
        nxt = layers[i + 1] if i + 1 < len(layers) else dict(params["final"])
        w = nxt["w"].reshape(len(nxt_ctx), old, -1) / k
        w = jnp.concatenate(
            [w, jnp.zeros((len(nxt_ctx), add, w.shape[-1]), jnp.float32)],
            axis=1)
        nxt["w"] = w.reshape(len(nxt_ctx) * new_hidden_dim, -1)
        if i + 1 < len(layers):
            layers[i + 1] = nxt
        else:
            params = dict(params)
            params["final"] = nxt
    out = dict(params)
    out["layers"] = layers
    return out


def shrink(apply_fn, params: dict, feats, labels, num_steps: int = 50,
           lr: float = 0.1):
    """Optimize one log-scale per layer on held-out frames
    (ref: nnet2/shrink-nnet.h ShrinkNnet — LBFGS over per-component scales
    maximizing validation log-prob; here Adam over log-scales under jit).

    apply_fn(params, feats) -> log-posteriors [..., T, num_pdfs];
    labels: int array broadcastable to the output frames. -> new params.
    """
    n_layers = len(params["layers"]) + 1

    def scaled(params, logs):
        sc = jnp.exp(logs)
        out = dict(params)
        out["layers"] = [
            jax.tree_util.tree_map(lambda p: p * sc[i], l)
            for i, l in enumerate(params["layers"])]
        out["final"] = jax.tree_util.tree_map(
            lambda p: p * sc[-1], params["final"])
        return out

    labels = jnp.asarray(labels)

    @jax.jit
    def objective(logs):
        lp = apply_fn(scaled(params, logs), feats)
        return -jnp.mean(jnp.take_along_axis(
            lp, labels[..., None], axis=-1))

    logs = jnp.zeros(n_layers, jnp.float32)
    tx = optax.adam(lr)
    st = tx.init(logs)
    grad = jax.jit(jax.grad(objective))
    best = (logs, float(objective(logs)))
    for _ in range(num_steps):
        g = grad(logs)
        upd, st = tx.update(g, st)
        logs = optax.apply_updates(logs, upd)
        val = float(objective(logs))
        if val < best[1]:
            best = (logs, val)
    return scaled(params, best[0])


def limit_rank(params: dict, rank: int, layers: list[int] | None = None):
    """Rank-limit hidden affines by truncated SVD
    (ref: nnet2bin/nnet-am-limit-rank.cc — replaces W with the product of
    two low-rank factors; here the same low-rank matrix is kept in one
    piece, which is what XLA would fuse the factor pair back into anyway).

    -> (new params, factors) where factors[i] = (U_r*S_r [in,r], Vt_r [r,out])
    for callers that do want the two-matmul form.
    """
    out = dict(params)
    out["layers"] = [dict(l) for l in params["layers"]]
    idxs = range(len(out["layers"])) if layers is None else layers
    factors = {}
    for i in idxs:
        w = np.asarray(out["layers"][i]["w"], np.float64)
        u, s, vt = np.linalg.svd(w, full_matrices=False)
        r = min(rank, len(s))
        a = (u[:, :r] * s[:r]).astype(np.float32)
        b = vt[:r].astype(np.float32)
        factors[i] = (a, b)
        out["layers"][i]["w"] = jnp.asarray(a @ b)
    return out, factors


def fix(params: dict, config, apply_hidden_stats, feats,
        min_average: float = 0.1, max_average: float = 2.0,
        parameter_factor: float = 2.0) -> dict:
    """Rescale hidden units that are dead or oversaturated
    (ref: nnet2/nnet-fix.h FixNnet: for ReLU units whose average activation
    is ~0, scale incoming weights UP; for units dominating the layer,
    scale DOWN; both capped at parameter_factor).

    apply_hidden_stats(params, feats) -> list of per-layer mean |activation|
    vectors [hidden] (the Tdnn exposes this as hidden_activations()); any
    callable with that contract works.
    """
    stats = apply_hidden_stats(params, feats)
    out = dict(params)
    out["layers"] = [dict(l) for l in params["layers"]]
    for i, avg in enumerate(stats):
        avg = np.asarray(avg)
        mean = max(float(avg.mean()), 1e-20)
        rel = avg / mean
        scale = np.ones_like(rel)
        low = rel < min_average
        high = rel > max_average
        scale[low] = np.minimum(min_average / np.maximum(rel[low], 1e-20),
                                parameter_factor)
        scale[high] = np.maximum(max_average / rel[high],
                                 1.0 / parameter_factor)
        s = jnp.asarray(scale, jnp.float32)
        out["layers"][i]["w"] = out["layers"][i]["w"] * s[None, :]
        out["layers"][i]["b"] = out["layers"][i]["b"] * s
    return out


def replace_last_layers(params: dict, config, new_num_pdfs: int, key) -> dict:
    """Re-initialize the output affine for a new pdf inventory
    (ref: nnet2bin/nnet-replace-last-layers.cc + nnet-insert — keep the
    trained hidden stack, zero-init a fresh softmax layer for transfer to
    a new tree)."""
    from kaldi_tpu.nnet.components import affine_init
    in_dim = params["final"]["w"].shape[0]
    out = dict(params)
    out["final"] = affine_init(key, in_dim, new_num_pdfs,
                               param_stddev=0.0, bias_stddev=0.0)
    return out


def layerwise_lr_labels(params: dict) -> dict:
    """Label tree for optax.multi_transform: 'layer0'..'layerN-1', 'final'
    (ref: nnet2bin/nnet-modify-learning-rates.cc — per-component learning
    rates; in the optax world the schedule lives in the optimizer, keyed
    by these labels)."""
    return {
        "layers": [jax.tree_util.tree_map(lambda _: f"layer{i}", l)
                   for i, l in enumerate(params["layers"])],
        "final": jax.tree_util.tree_map(lambda _: "final", params["final"]),
    }


def layerwise_optimizer(params: dict, base_lr: float,
                        scales: dict[str, float]):
    """optax.multi_transform SGD with per-layer lr = base_lr * scales[label]
    (missing labels default to 1.0)."""
    labels = layerwise_lr_labels(params)
    names = {leaf for leaf in jax.tree_util.tree_leaves(labels)}
    txs = {n: optax.sgd(base_lr * scales.get(n, 1.0)) for n in names}
    return optax.multi_transform(txs, labels)
