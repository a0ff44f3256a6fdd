"""Multiclass logistic regression (the LID classifier over i-vectors).

(ref: ivector/logistic-regression.h LogisticRegression — trained with
 L-BFGS on the multiclass log-loss with L2 prior ('normalizer'); supports
 class priors adjustment and mixture components per class via
 --mix-up (single-component here). Training is full-batch gradient steps
 under jit — the dataset is i-vectors, tiny by accelerator standards.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass
class LogisticRegressionConfig:
    max_steps: int = 100
    normalizer: float = 0.0025    # L2 regularizer (ref default)
    learning_rate: float = 0.5


class LogisticRegression:
    def __init__(self, weights: np.ndarray | None = None):
        self.weights = weights    # [C, D+1]

    def train(self, X: np.ndarray, labels: np.ndarray,
              config: LogisticRegressionConfig = LogisticRegressionConfig()):
        """X [N, D], labels [N] ints in [0, C)."""
        N, D = X.shape
        C = int(labels.max()) + 1
        Xp = jnp.concatenate([jnp.asarray(X, jnp.float32),
                              jnp.ones((N, 1), jnp.float32)], axis=1)
        y = jnp.asarray(labels)
        w0 = jnp.zeros((C, D + 1), jnp.float32)

        def loss_fn(w):
            logits = Xp @ w.T
            lp = jax.nn.log_softmax(logits, axis=1)
            nll = -jnp.mean(jnp.take_along_axis(lp, y[:, None], 1))
            return nll + config.normalizer * jnp.sum(w * w)

        tx = optax.adam(config.learning_rate)
        st = tx.init(w0)

        @jax.jit
        def step(w, st):
            loss, g = jax.value_and_grad(loss_fn)(w)
            upd, st = tx.update(g, st)
            return optax.apply_updates(w, upd), st, loss

        w = w0
        for _ in range(config.max_steps):
            w, st, _loss = step(w, st)
        self.weights = np.array(w)
        # loss of the FINAL weights (also well-defined for max_steps=0,
        # where the in-loop value would be unbound)
        return float(loss_fn(w))

    def log_posteriors(self, X: np.ndarray) -> np.ndarray:
        Xp = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        logits = Xp @ self.weights.T
        m = logits.max(axis=1, keepdims=True)
        lse = m + np.log(np.exp(logits - m).sum(axis=1, keepdims=True))
        return logits - lse

    def classify(self, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.log_posteriors(X), axis=1)

    def scale_priors(self, log_priors: np.ndarray):
        """Adjust the bias column by new class log-priors
        (ref: logistic-regression.cc ScalePriors)."""
        self.weights[:, -1] += np.asarray(log_priors)
