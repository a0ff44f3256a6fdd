"""Natural-gradient preconditioning for affine layers.

(ref: nnet2/nnet-precondition-online.h:446 OnlinePreconditioner and
 nnet3/natural-gradient-online.h:420 OnlineNaturalGradient — Povey, Zhang
 & Khudanpur 2014. The reference maintains a LOW-RANK online Fisher
 estimate per side because full matrices were too slow on 2014 CPUs/GPUs;
 on an accelerator the full Kronecker factors are cheap, so the idiomatic
 realization is: EMA covariance of the gradient's row and column spaces,
 periodic inverse-square-roots (eigh), and — like the reference — a final
 rescale so preconditioning changes the gradient's DIRECTION but not its
 Frobenius norm (nnet-precondition-online.h's scale-preserving contract,
 which is what makes periodic model averaging work).)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax


class _FactorState(NamedTuple):
    cov_in: jnp.ndarray
    cov_out: jnp.ndarray
    p_in: jnp.ndarray       # inverse-sqrt preconditioners
    p_out: jnp.ndarray


class NgSgdState(NamedTuple):
    factors: dict
    step: jnp.ndarray


def _inv_sqrt_psd(M: jnp.ndarray, eps: float) -> jnp.ndarray:
    d = M.shape[0]
    tr = jnp.trace(M) / d
    w, V = jnp.linalg.eigh(M + (eps * tr + 1e-8) * jnp.eye(d, dtype=M.dtype))
    w = jnp.maximum(w, 1e-10)
    return (V * (w ** -0.5)) @ V.T


def natural_gradient(alpha: float = 4.0, update_period: int = 10,
                     eps: float = 1e-3,
                     min_dim: int = 2, max_dim: int = 4096,
                     param_filter=None,
                     ) -> optax.GradientTransformation:
    """Optax transform: precondition every 2-D parameter's gradient by
    inverse-sqrt Kronecker factors of its own row/column covariance,
    then rescale to the original Frobenius norm.

    alpha: identity smoothing toward the scaled identity, as the
    reference's alpha (natural-gradient-online.h:420) — larger = closer
    to plain SGD.

    param_filter: optional predicate on the keystr path; parameters it
    rejects get plain gradients (the reference only preconditions
    NaturalGradientAffineComponent weights — nnet3 passes the component
    names here)."""

    def is_mat(p):
        return (p.ndim == 2 and min(p.shape) >= min_dim
                and max(p.shape) <= max_dim)

    def init(params):
        factors = {}
        flat = jax.tree_util.tree_leaves_with_path(params)
        for path, p in flat:
            if param_filter is not None and \
                    not param_filter(jax.tree_util.keystr(path)):
                continue
            if is_mat(p):
                o, i = p.shape
                factors[jax.tree_util.keystr(path)] = _FactorState(
                    cov_in=jnp.eye(i, dtype=jnp.float32),
                    cov_out=jnp.eye(o, dtype=jnp.float32),
                    p_in=jnp.eye(i, dtype=jnp.float32),
                    p_out=jnp.eye(o, dtype=jnp.float32))
        return NgSgdState(factors=factors, step=jnp.zeros((), jnp.int32))

    def update(grads, state, params=None):
        step = state.step + 1
        beta = 0.95
        new_factors = dict(state.factors)

        def precondition(path, g):
            key = jax.tree_util.keystr(path)
            if key not in state.factors:
                return g
            f = state.factors[key]
            o, i = g.shape
            g32 = g.astype(jnp.float32)
            cov_in = beta * f.cov_in + (1 - beta) * (g32.T @ g32) / o
            cov_out = beta * f.cov_out + (1 - beta) * (g32 @ g32.T) / i

            def refresh(_):
                smooth_i = alpha / i * jnp.trace(cov_in) * jnp.eye(i)
                smooth_o = alpha / o * jnp.trace(cov_out) * jnp.eye(o)
                return (_inv_sqrt_psd(cov_in + smooth_i, eps),
                        _inv_sqrt_psd(cov_out + smooth_o, eps))

            p_in, p_out = jax.lax.cond(
                step % update_period == 0, refresh,
                lambda _: (f.p_in, f.p_out), None)
            new_factors[key] = _FactorState(cov_in, cov_out, p_in, p_out)
            pg = p_out @ g32 @ p_in
            # scale-preserving contract (see module docstring)
            norm_g = jnp.linalg.norm(g32) + 1e-20
            norm_pg = jnp.linalg.norm(pg) + 1e-20
            return (pg * (norm_g / norm_pg)).astype(g.dtype)

        out = jax.tree_util.tree_map_with_path(precondition, grads)
        return out, NgSgdState(factors=new_factors, step=step)

    return optax.GradientTransformation(init, update)


def ng_sgd(learning_rate, alpha: float = 4.0, update_period: int = 10,
           momentum: float = 0.0) -> optax.GradientTransformation:
    """NG-SGD: natural-gradient preconditioning + SGD
    (ref: nnet2's AffineComponentPreconditionedOnline update rule)."""
    chain = [natural_gradient(alpha=alpha, update_period=update_period)]
    if momentum > 0:
        chain.append(optax.sgd(learning_rate, momentum=momentum))
    else:
        chain.append(optax.sgd(learning_rate))
    return optax.chain(*chain)
