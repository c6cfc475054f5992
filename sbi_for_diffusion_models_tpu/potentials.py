"""Posterior potentials: conditioned summed log-likelihood + theta-only prior.

API parity with the reference (src/sbi_for_diffusion_models/potentials.py):
``ConditionedMNLELogLikelihood`` (reference :59-117) and
``ThetaOnlyPosteriorPotential`` (reference :7-57).

Design: the reference materializes a (num_trials * num_thetas, 85)
tiled condition matrix and calls estimator.log_prob once over it (reference
potentials.py:98-117). In JAX the same computation is two nested ``vmap``s —
over thetas and over trials — which XLA fuses into one batched network forward
with no host-side tiling. The potential is a pure function of theta, so
``jax.grad`` gives NUTS gradients with no ``track_gradients`` toggling
(reference potentials.py:49-53).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .distributions import Distribution
from .nets.mnle_net import MNLE

__all__ = ["ConditionedMNLELogLikelihood", "ThetaOnlyPosteriorPotential"]


class ConditionedMNLELogLikelihood:
    """Summed per-trial log-likelihood conditioned on each trial's stimulus.

    Given a trained estimator and the session's realized pulse matrix
    ``local_theta`` (T, P), computes ``ll(theta) = sum_i log p(x_i | theta,
    s_i)`` for batches of global theta (reference potentials.py:59-117).
    """

    def __init__(self, estimator: MNLE, local_theta):
        self.estimator = estimator
        self.local_theta = jnp.asarray(local_theta, jnp.float32)
        if self.local_theta.ndim != 2:
            raise ValueError(
                f"local_theta must be (num_trials, P), got {self.local_theta.shape}"
            )

    def __call__(self, x, theta):
        return self.forward(x, theta)

    def log_lik_fn(self, params, x, theta):
        """Pure function: x (T, 2), theta (N, D) -> (N,) summed log-lik.

        Safe to close over under jit/grad/vmap; ``params`` is explicit so the
        same compiled program serves different checkpoints.
        """
        est = self.estimator
        s = self.local_theta  # (T, P)
        T = s.shape[0]

        def per_theta(th):  # th: (D,)
            cond = jnp.concatenate(
                [jnp.broadcast_to(th, (T, th.shape[-1])), s], axis=-1
            )
            return jnp.sum(est.log_prob_fn(params, x, cond))

        return jax.vmap(per_theta)(theta)

    def forward(self, x, theta):
        """Reference-shaped entry point (potentials.py:75-117).

        x: (T, 2) or (1, T, 2); theta: (N, D). Returns (1, N) to match the
        reference's ``(num_xs, num_thetas)`` output with num_xs == 1
        (reference potentials.py:91,115-117).
        """
        x = jnp.asarray(x, jnp.float32)
        if x.ndim == 3:
            if x.shape[0] != 1:
                raise ValueError(f"only num_xs == 1 is supported, got {x.shape[0]}")
            x = x[0]
        theta = jnp.asarray(theta, jnp.float32)
        if theta.ndim == 1:
            theta = theta.reshape(1, -1)
        if x.shape[0] != self.local_theta.shape[0]:
            raise ValueError(
                f"x has {x.shape[0]} trials but local_theta has "
                f"{self.local_theta.shape[0]} (reference potentials.py:92-94)"
            )
        return self.log_lik_fn(self.estimator.params, x, theta)[None, :]


class ThetaOnlyPosteriorPotential:
    """log p(theta) + sum_i log p(x_i | theta, s_i) / temperature
    (reference potentials.py:7-57).

    Callable on (N, D) theta batches; also exposes ``potential_fn`` — a pure
    single-theta function for jit/grad-based samplers. ``set_x_o``/``set_x``
    mutate the conditioning data as the reference requires for sbi's
    ``potential(theta, x_o)`` call pattern (reference potentials.py:26-36).
    """

    def __init__(
        self,
        prior: Distribution,
        likelihood: ConditionedMNLELogLikelihood,
        x_o=None,
        temperature: float = 1.0,
    ):
        self.prior = prior
        self.likelihood = likelihood
        self.temperature = float(temperature)
        self.x_o = jnp.asarray(x_o, jnp.float32) if x_o is not None else None

    def set_x_o(self, x_o):
        self.x_o = jnp.asarray(x_o, jnp.float32)

    set_x = set_x_o

    def potential_fn(self, theta, x=None):
        """Pure per-theta potential: theta (D,) -> scalar."""
        x = self.x_o if x is None else jnp.asarray(x, jnp.float32)
        lp_prior = self.prior.log_prob(theta)
        ll = self.likelihood.log_lik_fn(
            self.likelihood.estimator.params, x, theta.reshape(1, -1)
        )[0]
        return lp_prior + ll / self.temperature

    def __call__(self, theta, x_o=None, track_gradients: bool = True):
        """Batched potential: theta (N, D) -> (N,).

        Rows with -inf prior are masked out before the likelihood evaluates
        (reference potentials.py:44-53) — in JAX the network still runs on
        those rows (no dynamic shapes) but NaN/Inf propagation is suppressed
        via where-masking. ``track_gradients`` is accepted for parity and
        ignored: JAX differentiates pure functions on demand.
        """
        if x_o is not None:
            self.set_x_o(x_o)
        theta = jnp.asarray(theta, jnp.float32)
        squeeze = theta.ndim == 1
        if squeeze:
            theta = theta.reshape(1, -1)
        lp_prior = self.prior.log_prob(theta)
        finite = jnp.isfinite(lp_prior)
        safe_theta = jnp.where(
            finite[:, None], theta, jnp.ones_like(theta)
        )
        ll = self.likelihood.log_lik_fn(
            self.likelihood.estimator.params, self.x_o, safe_theta
        )
        out = jnp.where(finite, lp_prior + ll / self.temperature, -jnp.inf)
        return out[0] if squeeze else out
