"""Training proposals over z = [theta, pulse_sides].

API parity with the reference (src/sbi_for_diffusion_models/proposals.py):
``PulseSequenceProposal`` samples stimulus matrices s in {+1,-1}^P and
deliberately reports ``log_prob = 0`` — only sampling is needed for MNLE
training and the constant cancels in the posterior (reference
proposals.py:42-44; keep it). ``ExtendedProposal`` is the product distribution
over the 5+P-dim z handed to the MNLE trainer (reference proposals.py:47-74).

Differences: sampling is driven by ``jax.random`` keys (an int seed
is promoted via ``as_key``), generated fully on device, and vectorized over
trials instead of the reference's per-trial Python loop
(reference rt_choice_model.py:89-90).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .distributions import Distribution, Support, real_support
from .run_config import RUN_CONFIG_PARAMS
from .utils.rng import as_key

__all__ = ["PulseSequenceProposal", "ExtendedProposal"]


class PulseSequenceProposal(Distribution):
    """Distribution over pulse-side sequences s in {+1,-1}^P.

    Per trial: a correct side is drawn ±1 with p=0.5; each pulse matches it
    with probability ``p_success`` (reference choice_model.py:43-60).
    """

    def __init__(
        self,
        n_pulses: int,
        p_success: float = RUN_CONFIG_PARAMS.P_SUCCESS,
        seed: int | None = 0,
    ):
        self.n_pulses = int(n_pulses)
        self.p_success = float(p_success)
        self.event_shape = (self.n_pulses,)
        self._key = as_key(seed)
        self._counter = 0

    def sample(self, key=None, sample_shape=()):
        """Stateless if a key is given; otherwise consumes the owned stream
        (mirroring the reference's owned ``np.random.Generator``,
        proposals.py:23,30-40)."""
        if key is None:
            key = jax.random.fold_in(self._key, self._counter)
            self._counter += 1
        n = 1
        for d in sample_shape:
            n *= int(d)
        k1, k2 = jax.random.split(key)
        correct = jnp.where(
            jax.random.uniform(k1, (n, 1)) < 0.5, 1.0, -1.0
        ).astype(jnp.float32)
        match = jax.random.uniform(k2, (n, self.n_pulses)) < self.p_success
        s = jnp.where(match, correct, -correct)
        return s.reshape(tuple(sample_shape) + (self.n_pulses,))

    def log_prob(self, value):
        """Intentionally 0: constant in theta, cancels in the posterior
        (reference proposals.py:42-44)."""
        return jnp.zeros(value.shape[:-1], jnp.float32)

    def supports(self) -> list[Support]:
        return [real_support() for _ in range(self.n_pulses)]


class ExtendedProposal(Distribution):
    """Product proposal over z = [theta (5), pulse_sides (P)]
    (reference proposals.py:47-74)."""

    def __init__(self, theta_prior: Distribution, pulse_proposal: PulseSequenceProposal):
        self.theta_prior = theta_prior
        self.pulse_proposal = pulse_proposal
        self.theta_dim = theta_prior.event_dim
        self.event_shape = (self.theta_dim + pulse_proposal.n_pulses,)

    def sample(self, key=None, sample_shape=()):
        if key is None:
            key = self.pulse_proposal._key
            key = jax.random.fold_in(key, 10_000 + self.pulse_proposal._counter)
            self.pulse_proposal._counter += 1
        k_theta, k_pulse = jax.random.split(key)
        theta = self.theta_prior.sample(k_theta, sample_shape)
        pulses = self.pulse_proposal.sample(k_pulse, sample_shape)
        return jnp.concatenate([theta, pulses], axis=-1)

    def log_prob(self, z):
        theta = z[..., : self.theta_dim]
        pulses = z[..., self.theta_dim :]
        return self.theta_prior.log_prob(theta) + self.pulse_proposal.log_prob(pulses)

    def supports(self) -> list[Support]:
        return self.theta_prior.supports() + self.pulse_proposal.supports()
