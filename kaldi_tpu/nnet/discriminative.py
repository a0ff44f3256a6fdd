"""Sequence-discriminative nnet training: MMI / bMMI / MPE / sMBR.

(ref: nnet2/nnet-compute-discriminative.h:35 NnetDiscriminativeUpdate and
 steps/nnet2/train_discriminative2.sh. The gradient of every lattice-based
 sequence objective w.r.t. the log acoustic likelihood at (t, pdf) is the
 signed posterior computed by the lattice forward-backward — numerator
 minus denominator for (b)MMI, the MPE "gamma" for MPE/sMBR. The posterior
 pass runs on host over lattices; the parameter update is one jit step with
 a surrogate loss  L = -Σ post[t,pdf] · logprob[t,pdf]  whose gradient
 equals the true objective's gradient, with `post` stop-gradiented.)
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import jax
import jax.numpy as jnp
import optax

from kaldi_tpu.lat.posteriors import (
    rescore_lattice, lattice_boost, lattice_forward_backward_mmi,
    lattice_forward_backward_mpe_variants,
)

log = logging.getLogger("kaldi_tpu.nnet.discriminative")


@dataclasses.dataclass
class NnetDiscriminativeOpts:
    """(ref: nnet2/nnet-compute-discriminative.h:35
    NnetDiscriminativeUpdateOptions)"""
    criterion: str = "smbr"       # 'mmi' | 'smbr' | 'mpfe'
    acoustic_scale: float = 0.1
    boost: float = 0.0
    drop_frames: bool = True
    learning_rate: float = 1e-4
    num_epochs: int = 1
    one_silence_class: bool = True


def compute_discriminative_post(
    am_nnet, lat, num_ali, tm, opts: NnetDiscriminativeOpts,
    loglikes: np.ndarray, silence_phones=frozenset(),
):
    """-> (post [T, num_pdfs] dense signed gradient, objf).

    `loglikes` are the current model's (prior-divided, unscaled) acoustic
    log-likelihoods for this utterance; the lattice is rescored with them
    before the forward-backward (ref: nnet2/nnet-compute-discriminative.cc
    LatticeComputations).
    """
    rescore_lattice(lat, loglikes, tm, opts.acoustic_scale)
    T = loglikes.shape[0]
    P = loglikes.shape[1]
    if opts.criterion == "mmi":
        sparse, den_like = lattice_forward_backward_mmi(
            lat, num_ali, tm, opts.drop_frames, cancel=True)
        # true MMI objective = num loglike - den loglike; the num term is
        # NOT constant across epochs (loglikes move with the params), so
        # reporting -den alone would make the history useless for
        # divergence detection (ref: nnet-compute-discriminative.cc
        # LatticeComputations computes tot_num_objf the same way)
        pdfs = np.fromiter(
            (tm.transition_id_to_pdf(int(t)) for t in num_ali), np.int64,
            count=T)
        num_like = opts.acoustic_scale * float(
            loglikes[np.arange(T), pdfs].sum())
        objf = num_like - den_like
    else:
        sparse, objf = lattice_forward_backward_mpe_variants(
            lat, num_ali, tm, opts.criterion, silence_phones,
            opts.one_silence_class)
    dense = np.zeros((T, P), np.float32)
    for t, frame in enumerate(sparse):
        for pdf, w in frame:
            dense[t, pdf] = w
    return dense, objf


def train_nnet_discriminative(
    am_nnet,                      # AmNnet (model + params + priors)
    tm,                           # TransitionModel
    egs,                          # [(feats [T+ctx, D], num_ali [T], lattice)]
    opts: NnetDiscriminativeOpts = NnetDiscriminativeOpts(),
    silence_phones=frozenset(),
):
    """Sequence-discriminative fine-tuning of a hybrid TDNN.

    Returns (new_params, objf_history). Lattices are rescored with the
    current model each epoch (ref: steps/nnet2/train_discriminative2.sh
    regenerates posteriors per iteration against fixed denlats).
    """
    model = am_nnet.model
    params = am_nnet.params
    tx = optax.sgd(opts.learning_rate)
    opt_state = tx.init(params)

    # NOTE on the two forward passes per utterance (loglikes_np for the
    # lattice rescoring + the one inside value_and_grad): an eager
    # jax.vjp could share one forward across the host lattice pass and
    # the pullback, but it cannot live inside jit (the posterior pass is
    # host code between fwd and bwd), and the lost XLA fusion of an
    # un-jitted fwd+bwd is expected to outweigh the saved jitted forward.
    @jax.jit
    def step(params, opt_state, feats, post):
        def loss_fn(p):
            logprob = model.apply(p, feats[None], pad_context=False)[0]
            # surrogate: gradient wrt logprob equals -post
            return -jnp.sum(jax.lax.stop_gradient(post) * logprob)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    hist = []
    boosted = set()
    for epoch in range(opts.num_epochs):
        tot_objf, tot_frames = 0.0, 0
        for i, (feats, num_ali, lat) in enumerate(egs):
            cur = am_nnet.replace_params(params)
            # feats carry the model's context; the lattice's frame t is the
            # output frame at offset left_context under pad_context=True
            ll = cur.loglikes_np(feats[None])[0]
            T = len(num_ali)
            # Tdnn exposes context via config; config-defined Nnet3 nets
            # expose it directly (duck-typed AmNnet3)
            lc = getattr(model, "left_context", None)
            if lc is None:
                lc = model.config.left_context
            ll = ll[lc:lc + T]
            if opts.boost != 0.0 and i not in boosted:
                lattice_boost(lat, num_ali, tm, opts.boost, silence_phones)
                boosted.add(i)
            post, objf = compute_discriminative_post(
                cur, lat, num_ali, tm, opts, ll, silence_phones)
            params, opt_state, _loss = step(
                params, opt_state, jnp.asarray(feats), jnp.asarray(post))
            tot_objf += objf
            tot_frames += T
        hist.append(tot_objf / max(tot_frames, 1))
        log.info("epoch %d: %s objf/frame %.6f", epoch, opts.criterion,
                 hist[-1])
    return params, hist
