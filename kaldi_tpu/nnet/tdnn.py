"""Multisplice TDNN acoustic model.

(ref: the nnet2 online multisplice system — steps/nnet2/
 train_multisplice_accel2.sh with splice_indexes like "-2,-1,0,1,2 -1,2 -3,3
 -7,2 0", components Splice->Affine->Pnorm->Normalize per layer and a final
 Affine->Softmax; also nnet3 TDNN configs from
 steps/nnet3/make_tdnn_configs.py. This is the reference's strongest
 production AM family — LibriSpeech RESULTS:314.)

The whole utterance batch [B, T, D] flows through; each layer's
splice is a strided gather; affines are big GEMMs in bf16-friendly shapes.
Model parallelism: the final affine (hidden x num_pdfs, the largest matrix)
shards over the 'model' mesh axis; everything else is replicated and batch
shards over 'data' (SURVEY.md §2.11 row "tensor parallelism").
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.nnet.components import (
    splice_valid, affine_init, affine_apply, pnorm, normalize,
    ACTIVATIONS,
)


@dataclasses.dataclass(frozen=True)
class TdnnConfig:
    feat_dim: int = 40
    num_pdfs: int = 2000
    # per-layer splice offsets (nnet2 multisplice notation)
    splice_indexes: tuple = ((-2, -1, 0, 1, 2), (-1, 2), (-3, 3), (-7, 2), (0,))
    hidden_dim: int = 2048        # pnorm input dim
    pnorm_output_dim: int = 256   # pnorm output dim (group 8 by default)
    nonlinearity: str = "pnorm"   # pnorm | relu
    final_hidden: int | None = None

    @property
    def left_context(self) -> int:
        return -sum(min(c) for c in self.splice_indexes if min(c) < 0)

    @property
    def right_context(self) -> int:
        return sum(max(c) for c in self.splice_indexes if max(c) > 0)


class Tdnn:
    """init(key) -> params pytree; apply(params, feats) -> log-softmax posts."""

    def __init__(self, config: TdnnConfig):
        self.config = config

    def init(self, key) -> dict:
        cfg = self.config
        params = {"layers": []}
        in_dim = cfg.feat_dim
        keys = jax.random.split(key, len(cfg.splice_indexes) + 1)
        for i, ctx in enumerate(cfg.splice_indexes):
            spliced = in_dim * len(ctx)
            if cfg.nonlinearity == "pnorm":
                layer = affine_init(keys[i], spliced, cfg.hidden_dim)
                in_dim = cfg.pnorm_output_dim
            else:
                layer = affine_init(keys[i], spliced, cfg.hidden_dim)
                in_dim = cfg.hidden_dim
            params["layers"].append(layer)
        params["final"] = affine_init(keys[-1], in_dim, cfg.num_pdfs,
                                      param_stddev=0.0, bias_stddev=0.0)
        return params

    def context_of(self, num_layers: int | None) -> tuple[int, int]:
        """(left, right) context of the first `num_layers` layers."""
        sp = self.config.splice_indexes[:num_layers]
        lc = -sum(min(c) for c in sp if min(c) < 0)
        rc = sum(max(c) for c in sp if max(c) > 0)
        return lc, rc

    def edge_pad(self, feats, num_layers: int | None = None):
        """Replicate the first/last frames of feats [..., T, D] by the
        (left, right) context of the first `num_layers` layers."""
        lc, rc = self.context_of(num_layers)
        pads = [(0, 0)] * (feats.ndim - 2) + [(lc, rc), (0, 0)]
        return jnp.pad(jnp.asarray(feats), pads, mode="edge")

    def apply(self, params, feats: jnp.ndarray, pad_context: bool = True,
              compute_dtype=None, num_layers: int | None = None):
        """feats [..., T, D] -> log posteriors [..., T(out), num_pdfs].

        pad_context=True replicates the first and last input frames by
        the model's left/right context (decode mode, output T == input
        T), as the reference pads nnet input at utterance edges; the
        streaming decoders clamp their feature ring the same way, so
        streamed and offline scores agree frame for frame. False uses
        valid frames only (training on chunks that already carry their
        context).

        compute_dtype=jnp.bfloat16 runs the affine GEMMs with bf16
        operands and f32 accumulation — the inference fast path.
        Nonlinearities and the final log-softmax stay f32.

        num_layers runs only the first k hidden layers before the final
        affine (layer-wise discriminative pretraining, ref:
        steps/nnet2/train_pnorm_accel2.sh's growing num-hidden-layers;
        valid for pnorm/relu nets whose hidden output dim is constant).
        """
        cfg = self.config
        x = self.edge_pad(feats, num_layers) if pad_context else feats
        cast = ((lambda a: a.astype(compute_dtype))
                if compute_dtype is not None else (lambda a: a))
        if compute_dtype is not None:
            # bf16 fast path (training AND batched inference): the splice
            # is folded into the GEMM as a sum of per-offset slabs —
            # x@W == sum_k slice_k(x) @ W[kD:(k+1)D] — so the
            # [.., T, D*n] concat buffer never materializes (the layer is
            # expected to be memory-bound at these widths). Activations
            # stay f32 through the nonlinearity/normalize: quantizing the
            # hidden representation to bf16 moved calibrated-corpus WER
            # by >10 points, which is not a rounding-level change
            # (WER-level parity with f32 asserted in
            # tests/test_bf16_parity.py).
            for ctx, layer in zip(cfg.splice_indexes[:num_layers],
                                  params["layers"][:num_layers]):
                w = cast(layer["w"])
                xc = cast(x)
                lo, hi = min(ctx), max(ctx)
                D = xc.shape[-1]
                Tout = xc.shape[-2] - (hi - lo)
                acc = None
                for k, off in enumerate(ctx):
                    xs = jax.lax.slice_in_dim(xc, off - lo,
                                              off - lo + Tout, axis=-2)
                    part = jnp.matmul(xs, w[k * D:(k + 1) * D])
                    acc = part if acc is None else acc + part
                x = acc.astype(jnp.float32) + layer["b"]
                if cfg.nonlinearity == "pnorm":
                    x = pnorm(x, cfg.pnorm_output_dim)
                    x = normalize(x)
                else:
                    x = ACTIVATIONS["relu"](x)
                    x = normalize(x)
            logits = jnp.matmul(cast(x),
                                cast(params["final"]["w"])).astype(
                jnp.float32) + params["final"]["b"]
            return jax.nn.log_softmax(logits, axis=-1)
        for ctx, layer in zip(cfg.splice_indexes[:num_layers],
                              params["layers"][:num_layers]):
            x = splice_valid(x, ctx)
            x = jnp.matmul(x, layer["w"]).astype(jnp.float32) \
                + layer["b"]
            if cfg.nonlinearity == "pnorm":
                x = pnorm(x, cfg.pnorm_output_dim)
                x = normalize(x)
            else:
                x = ACTIVATIONS["relu"](x)
                x = normalize(x)
        logits = jnp.matmul(x, params["final"]["w"]).astype(
            jnp.float32) + params["final"]["b"]
        return jax.nn.log_softmax(logits, axis=-1)

    def apply_logits(self, params, feats, pad_context: bool = True):
        cfg = self.config
        x = self.edge_pad(feats) if pad_context else feats
        for ctx, layer in zip(cfg.splice_indexes, params["layers"]):
            x = splice_valid(x, ctx)
            x = affine_apply(layer, x)
            if cfg.nonlinearity == "pnorm":
                x = pnorm(x, cfg.pnorm_output_dim)
                x = normalize(x)
            else:
                x = ACTIVATIONS["relu"](x)
                x = normalize(x)
        return affine_apply(params["final"], x)

    def hidden_mean_abs(self, params, feats, pad_context: bool = True):
        """Per-layer mean |activation| of each hidden unit (the statistic
        nnet-am-fix thresholds; ref: nnet2/nnet-fix.h FixNnet). -> list of
        [hidden_dim] arrays, one per hidden layer."""
        cfg = self.config
        x = self.edge_pad(feats) if pad_context else feats
        stats = []
        for ctx, layer in zip(cfg.splice_indexes, params["layers"]):
            x = splice_valid(x, ctx)
            x = affine_apply(layer, x)
            if cfg.nonlinearity == "pnorm":
                act = jnp.abs(x)
                stats.append(act.reshape(-1, act.shape[-1]).mean(axis=0))
                x = pnorm(x, cfg.pnorm_output_dim)
                x = normalize(x)
            else:
                x = ACTIVATIONS["relu"](x)
                stats.append(jnp.abs(x).reshape(-1, x.shape[-1]).mean(axis=0))
                x = normalize(x)
        return stats

    def num_params(self, params) -> int:
        return sum(int(np.prod(p.shape))
                   for p in jax.tree_util.tree_leaves(params))
