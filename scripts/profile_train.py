"""Decompose the TDNN train step: where do the non-MFU milliseconds go?

Times the bench's exact train step, then ablated variants, at the bench
shapes on the real chip:
  base      — the shipped step (bf16 GEMMs, f32 activations/elementwise)
  fwd       — loss forward only (isolates bwd+update share)
  act16     — activations kept bf16 THROUGH relu/normalize (halves the
              elementwise HBM traffic; reductions still accumulate f32)
  fsplice   — splice folded into the GEMM as a sum of per-offset
              slabs (x @ W == sum_k slice_k(x) @ W_k): the [B,T,D*n]
              concat buffer is never materialized
  both      — act16 + fsplice
  gemm-only — an equivalent pure-GEMM stack (no splice/normalize):
              the step's matmul upper bound at these dims
  prod-dims — `both` at production dims (hidden 2048, pdfs 8192 — the
              reference's big systems, e.g. sre10's 5297-senone DNN)

Prints frames/s and bf16 MFU per variant (MFU against the bf16 peak in
bench.py's table; "not measured" for a device the table does not list).
Every timing ends in jax.block_until_ready.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from kaldi_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from bench import bf16_peak_tflops
from kaldi_tpu.nnet.tdnn import Tdnn, TdnnConfig
from kaldi_tpu.nnet.components import splice_valid, pnorm, normalize, \
    ACTIVATIONS
from kaldi_tpu.nnet.train import (NnetTrainOpts, make_optimizer,
                                  cross_entropy_loss)

def timed_step(step, params, opt_state, feats, tgt, w, n=30):
    p, st = params, opt_state
    p, st, loss, acc = step(p, st, feats, tgt, w)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(n):
        p, st, loss, acc = step(p, st, feats, tgt, w)
    jax.block_until_ready((p, loss))
    return (time.perf_counter() - t0) / n


def report(name, dt, frames, n_wparams):
    fps = frames / dt
    tflops = 6.0 * n_wparams * fps / 1e12
    peak = bf16_peak_tflops(jax.devices()[0].device_kind)
    mfu = "not measured" if peak is None else f"{100 * tflops / peak:5.1f}%"
    print(f"{name:12s} step={dt*1e3:7.2f} ms  {fps/1e6:6.2f} Mframes/s  "
          f"{tflops:6.1f} TFLOP/s  MFU={mfu}")
    return fps


def variant_apply(cfg, mode):
    """apply(params, feats) -> log_post (valid mode) per variant."""
    act16 = mode in ("act16", "both", "prod")
    fsp = mode in ("fsplice", "both", "prod")
    cd = jnp.bfloat16

    def apply(params, feats):
        x = feats.astype(cd)
        for ctx, layer in zip(cfg.splice_indexes, params["layers"]):
            w = layer["w"].astype(cd)
            if fsp:
                lo, hi = min(ctx), max(ctx)
                T = x.shape[-2]
                Tout = T - (hi - lo)
                D = x.shape[-1]
                acc = None
                for k, off in enumerate(ctx):
                    xs = jax.lax.slice_in_dim(x, off - lo, off - lo + Tout,
                                              axis=-2)
                    part = jnp.matmul(xs, w[k * D:(k + 1) * D])
                    acc = part if acc is None else acc + part
                x = acc
            else:
                x = splice_valid(x, ctx)
                x = jnp.matmul(x, w)
            if act16:
                x = x + layer["b"].astype(cd)
                x = ACTIVATIONS["relu"](x)
                x = normalize(x).astype(cd)
            else:
                x = x.astype(jnp.float32) + layer["b"]
                x = ACTIVATIONS["relu"](x)
                x = normalize(x)
                x = x.astype(cd)
        logits = jnp.matmul(x, params["final"]["w"].astype(cd)) \
            .astype(jnp.float32) + params["final"]["b"]
        return jax.nn.log_softmax(logits, axis=-1)

    return apply


def run_variant(name, cfg, mode, B, Tt):
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    apply_fn = variant_apply(cfg, mode)
    opts = NnetTrainOpts(initial_lr=0.1, final_lr=0.02, max_grad_norm=5.0)
    optimizer = make_optimizer(opts, 10)
    opt_state = optimizer.init(params)

    def loss_fn(p, feats, tgt, w):
        log_post = apply_fn(p, feats)
        ll = jnp.take_along_axis(log_post, tgt[..., None], axis=-1)[..., 0]
        tw = jnp.maximum(jnp.sum(w), 1.0)
        return -jnp.sum(ll * w) / tw, \
            jnp.sum((jnp.argmax(log_post, -1) == tgt) * w) / tw

    @jax.jit
    def step(p, st, feats, tgt, w):
        (loss, acc), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, feats, tgt, w)
        updates, st = optimizer.update(grads, st, p)
        import optax
        p = optax.apply_updates(p, updates)
        return p, st, loss, acc

    lc, rc = cfg.left_context, cfg.right_context
    rng = np.random.RandomState(0)
    feats = jnp.asarray(rng.randn(B, Tt + lc + rc,
                                  cfg.feat_dim).astype(np.float32))
    tgt = jnp.asarray(rng.randint(0, cfg.num_pdfs, (B, Tt)).astype(np.int32))
    w = jnp.ones((B, Tt), jnp.float32)
    n_w = (sum(int(np.prod(l["w"].shape)) for l in params["layers"])
           + int(np.prod(params["final"]["w"].shape)))
    dt = timed_step(step, params, opt_state, feats, tgt, w)
    report(name, dt, B * Tt, n_w)


def main():
    cfg = TdnnConfig(feat_dim=40, num_pdfs=2048, hidden_dim=1024,
                     pnorm_output_dim=256, nonlinearity="relu")
    B, Tt = 16, 986

    # ---- the shipped step (baseline) ----
    model = Tdnn(cfg)
    params = model.init(jax.random.PRNGKey(0))
    from kaldi_tpu.nnet.train import make_train_step
    opts = NnetTrainOpts(initial_lr=0.1, final_lr=0.02, max_grad_norm=5.0)
    optimizer = make_optimizer(opts, 10)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer, compute_dtype=jnp.bfloat16)
    lc, rc = cfg.left_context, cfg.right_context
    rng = np.random.RandomState(0)
    feats = jnp.asarray(rng.randn(B, Tt + lc + rc, 40).astype(np.float32))
    tgt = jnp.asarray(rng.randint(0, 2048, (B, Tt)).astype(np.int32))
    w = jnp.ones((B, Tt), jnp.float32)
    n_w = (sum(int(np.prod(l["w"].shape)) for l in params["layers"])
           + int(np.prod(params["final"]["w"].shape)))
    dt = timed_step(step, params, opt_state, feats, tgt, w)
    report("base", dt, B * Tt, n_w)

    # forward only
    @jax.jit
    def fwd(p, feats, tgt, w):
        return cross_entropy_loss(model, p, feats, tgt, w,
                                  compute_dtype=jnp.bfloat16)
    jax.block_until_ready(fwd(params, feats, tgt, w))
    t0 = time.perf_counter()
    for _ in range(30):
        out = fwd(params, feats, tgt, w)
    jax.block_until_ready(out)
    dtf = (time.perf_counter() - t0) / 30
    print(f"{'fwd only':12s} step={dtf*1e3:7.2f} ms")

    for name, mode in (("act16", "act16"), ("fsplice", "fsplice"),
                       ("both", "both")):
        run_variant(name, cfg, mode, B, Tt)

    # pure-GEMM upper bound at same dims (no splice/normalize)
    run_variant("gemm-ish", dataclasses_replace_splice(cfg), "both", B, Tt)

    # production dims
    cfg_p = TdnnConfig(feat_dim=40, num_pdfs=8192, hidden_dim=2048,
                       pnorm_output_dim=256, nonlinearity="relu")
    run_variant("prod-dims", cfg_p, "prod", B, Tt)


def dataclasses_replace_splice(cfg):
    import dataclasses
    return dataclasses.replace(
        cfg, splice_indexes=tuple((0,) for _ in cfg.splice_indexes))


if __name__ == "__main__":
    main()
