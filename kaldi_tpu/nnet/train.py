"""DNN training: synchronous data-parallel SGD with natural-gradient
preconditioning, sharded over a device mesh.

(ref: the nnet2 training loop — nnet2/nnet-update.h:46-94 NnetUpdater,
 steps/nnet2/train_multisplice_accel2.sh:466-539 parallel-SGD-with-model-
 averaging, nnet2/nnet-precondition-online.h:446 OnlinePreconditioner.
 Model averaging across jobs + NG-SGD is the reference's substitute for
 synchronous data parallelism; on the mesh we do the strictly-stronger
 thing: one global step with gradients psum'd across devices, SURVEY.md §2.11.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax

from kaldi_tpu.nnet.tdnn import Tdnn
from kaldi_tpu.parallel.mesh import tdnn_param_sharding, batch_sharding


@dataclasses.dataclass(frozen=True)
class NnetTrainOpts:
    """(ref: nnet2/nnet-trnopts + train_multisplice_accel2.sh lr schedule)"""

    initial_lr: float = 0.0015
    final_lr: float = 0.00015
    num_epochs: int = 8
    minibatch_size: int = 128
    momentum: float = 0.0
    max_grad_norm: float = 5.0
    l2_regularize: float = 0.0


def cross_entropy_loss(model: Tdnn, params, feats, targets, weights,
                       compute_dtype=None):
    """feats [B, T+ctx, D] (valid-mode), targets [B, T], weights [B, T].

    compute_dtype=jnp.bfloat16 runs the affine GEMMs (and their grads)
    with bf16 operands and f32 master params; loss reduction and
    log-softmax stay f32."""
    # only Tdnn.apply knows compute_dtype; other models (e.g. Nnet3
    # config nets) share this loss with their own apply signature
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    log_post = model.apply(params, feats, pad_context=False, **kw)
    ll = jnp.take_along_axis(log_post, targets[..., None], axis=-1)[..., 0]
    tot_w = jnp.maximum(jnp.sum(weights), 1.0)
    loss = -jnp.sum(ll * weights) / tot_w
    acc = jnp.sum((jnp.argmax(log_post, -1) == targets) * weights) / tot_w
    return loss, acc


def make_optimizer(opts: NnetTrainOpts, num_steps: int):
    sched = optax.exponential_decay(
        opts.initial_lr, max(num_steps, 1),
        opts.final_lr / opts.initial_lr, end_value=opts.final_lr)
    chain = []
    if opts.max_grad_norm > 0:
        chain.append(optax.clip_by_global_norm(opts.max_grad_norm))
    if opts.l2_regularize > 0:
        chain.append(optax.add_decayed_weights(opts.l2_regularize))
    if opts.momentum > 0:
        chain.append(optax.sgd(sched, momentum=opts.momentum))
    else:
        chain.append(optax.sgd(sched))
    return optax.chain(*chain)


def make_train_step(model: Tdnn, optimizer, mesh=None, compute_dtype=None):
    """Returns jitted step(params, opt_state, feats, targets, weights).

    With a mesh: batch shards over 'data', final layer over 'model' — XLA
    inserts the gradient all-reduce automatically.
    compute_dtype=jnp.bfloat16 selects mixed-precision GEMMs (f32 master
    params, bf16 matmuls).
    """

    def step(params, opt_state, feats, targets, weights):
        (loss, acc), grads = jax.value_and_grad(
            lambda p: cross_entropy_loss(model, p, feats, targets, weights,
                                         compute_dtype=compute_dtype),
            has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, acc

    if mesh is None:
        return jax.jit(step)

    return jax.jit(
        step,
        in_shardings=(None, None, batch_sharding(mesh, 3),
                      batch_sharding(mesh, 2), batch_sharding(mesh, 2)),
    )


def shard_params(params, mesh):
    """Place params with the model-parallel sharding rules."""
    shardings = tdnn_param_sharding(mesh, params)
    return jax.device_put(params, shardings), shardings


def train_epochs(
    model: Tdnn,
    params,
    egs,  # dict with feats [N, chunk+ctx, D], targets [N, chunk], weights
    opts: NnetTrainOpts = NnetTrainOpts(),
    mesh=None,
    rng: np.random.RandomState | None = None,
    log_every: int = 50,
    callback=None,
):
    """Simple in-memory trainer (recipe-scale; the streaming version feeds
    from the egs pipeline)."""
    rng = rng or np.random.RandomState(0)
    N = egs["feats"].shape[0]
    mb = opts.minibatch_size
    steps_per_epoch = max(N // mb, 1)
    optimizer = make_optimizer(opts, steps_per_epoch * opts.num_epochs)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer, mesh)
    history = []
    for epoch in range(opts.num_epochs):
        perm = rng.permutation(N)
        for k in range(steps_per_epoch):
            sel = perm[k * mb: (k + 1) * mb]
            if len(sel) < mb:
                # pad the tail minibatch to a FULL mb rows (tiling the
                # permutation if N < mb): a short batch would retrace the
                # jit program and break the 'data'-axis divisibility of
                # the mesh sharding
                pad = np.resize(perm, mb - len(sel))
                sel = np.concatenate([sel, pad])
            params, opt_state, loss, acc = step_fn(
                params, opt_state,
                jnp.asarray(egs["feats"][sel]),
                jnp.asarray(egs["targets"][sel]),
                jnp.asarray(egs["weights"][sel]))
            if k % log_every == 0:
                history.append((epoch, k, float(loss), float(acc)))
                if callback:
                    callback(epoch, k, float(loss), float(acc))
    return params, history


def make_egs(
    utts,            # list of (feats [T,D], pdf_ids [T]) aligned utterances
    left_context: int,
    right_context: int,
    chunk: int = 8,
):
    """Chunked frame examples: [N, chunk + l + r, D] with [N, chunk] targets.

    (ref: steps/nnet2/get_egs2.sh — frame egs with spliced context; chunked
    rather than single-frame so the TDNN's temporal gathers amortize.)
    """
    feats_out, tgt_out, w_out = [], [], []
    for feats, pdfs in utts:
        T, D = feats.shape
        padded = np.pad(feats, ((left_context, right_context), (0, 0)),
                        mode="edge")
        for start in range(0, T, chunk):
            end = min(start + chunk, T)
            n = end - start
            win = padded[start: start + chunk + left_context + right_context]
            if win.shape[0] < chunk + left_context + right_context:
                win = np.pad(win, ((0, chunk + left_context + right_context
                                    - win.shape[0]), (0, 0)), mode="edge")
            t = np.zeros(chunk, np.int32)
            t[:n] = pdfs[start:end]
            w = np.zeros(chunk, np.float32)
            w[:n] = 1.0
            feats_out.append(win)
            tgt_out.append(t)
            w_out.append(w)
    return {
        "feats": np.stack(feats_out).astype(np.float32),
        "targets": np.stack(tgt_out),
        "weights": np.stack(w_out),
    }


def train_progressive(
    model: Tdnn,
    params,
    feats,        # [B, T + full_ctx, D] (valid-mode for the FULL net)
    targets,      # [B, T]
    weights,      # [B, T]
    opts: NnetTrainOpts = NnetTrainOpts(),
    steps_per_stage: int = 100,
    final_steps: int = 300,
    compute_dtype=None,
    log_every: int = 0,
    optimizer_factory=None,   # (opts, num_steps) -> optax transform;
                              # default = ng_sgd (the reference's NG-SGD)
):
    """Layer-wise discriminative pretraining (ref: the growing
    num-hidden-layers schedule of steps/nnet2/train_pnorm_accel2.sh and
    train_multisplice_accel2.sh:466-539): train with 1 active hidden
    layer, then 2, ... up to the full stack, keeping the learned final
    affine across stages. Deep pnorm stacks do not converge from
    scratch under any flat optimizer (the hidden-layer gradients vanish
    through the zero-init final affine + p-norm chain); growing the
    depth is how the reference trains them.

    feats must carry the FULL net's context; shallower stages slice the
    matching output window. -> (params, history list of (stage, loss,
    acc))."""
    import jax.numpy as jnp

    if optimizer_factory is None:
        # Adam, not the NG-SGD the reference pairs with layer growth:
        # p-norm layers' gradient scales span ~7 orders of magnitude
        # between the final affine and the hidden stack, and Adam's
        # per-parameter normalization is what bridges that here (our
        # Kronecker NG preconditioner corrects directionality, not the
        # cross-layer scale gap; measured: flat/NG/SGD all stall at the
        # class prior on deep pnorm, progressive+Adam reaches ~0 loss —
        # tests/test_progressive_training.py)
        def optimizer_factory(o, n):
            sched = optax.exponential_decay(
                2e-3, max(n, 1), 0.25, end_value=5e-4)
            return optax.adam(sched)
    n_layers = len(model.config.splice_indexes)
    lc_full = model.config.left_context
    T = targets.shape[1]
    history = []
    for k in range(1, n_layers + 1):
        steps = final_steps if k == n_layers else steps_per_stage
        optimizer = optimizer_factory(opts, steps)
        opt_state = optimizer.init(params)
        lc_k, _rc_k = model.context_of(k)
        off = lc_full - lc_k

        def loss_fn(p, k=k, off=off):
            log_post = model.apply(p, feats, pad_context=False,
                                   compute_dtype=compute_dtype,
                                   num_layers=k)
            log_post = jax.lax.dynamic_slice_in_dim(log_post, off, T,
                                                    axis=1)
            ll = jnp.take_along_axis(log_post, targets[..., None],
                                     axis=-1)[..., 0]
            tot_w = jnp.maximum(jnp.sum(weights), 1.0)
            loss = -jnp.sum(ll * weights) / tot_w
            acc = jnp.sum((jnp.argmax(log_post, -1) == targets)
                          * weights) / tot_w
            return loss, acc

        @jax.jit
        def step(p, s):
            (l, a), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            updates, s = optimizer.update(g, s, p)
            return optax.apply_updates(p, updates), s, l, a

        loss = acc = None
        for i in range(steps):
            params, opt_state, loss, acc = step(params, opt_state)
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"stage {k}/{n_layers} step {i}: "
                      f"loss {float(loss):.3f} acc {float(acc):.3f}")
        history.append((k, float(loss), float(acc)))
    return params, history
