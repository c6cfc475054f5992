"""SNPE & SNLE on the choice-only pulse-DDM (the ryans_test.ipynb workflow).

Reference workflow (src/notebooks/ryans_test.ipynb cells 0-4): simulate the
choice-only model under a BoxUniform prior, train SNPE (amortized posterior)
and SNLE (neural likelihood + MCMC), then sample both posteriors for one
observed session. Rebuilt here on the JAX stack.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from sbi_for_diffusion_models_tpu.distributions import BoxUniform
from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_choice_scan
from sbi_for_diffusion_models_tpu.run_config import RUN_CONFIG_PARAMS
from sbi_for_diffusion_models_tpu.snpe import train_snle, train_snpe


def main():
    cfg = RUN_CONFIG_PARAMS.replace(
        TRAIN_MAX_EPOCHS=60, TRAIN_STOP_AFTER_EPOCHS=12, TRAIN_BATCH_SIZE=1024,
        NUM_CHAINS=4, WARMUP_STEPS=100,
    )
    # BoxUniform prior over [a0, lam, v, B, t_nd] (ryans_test.ipynb cell 0).
    lo = jnp.array([0.1, 0.05, 0.2, 2.0, 0.0])
    hi = jnp.array([0.9, 1.00, 3.0, 20.0, 0.5])
    prior = BoxUniform(lo, hi)

    key = jax.random.key(0)
    n = 20_000
    theta = prior.sample(jax.random.fold_in(key, 0), (n,))
    # Summary statistic x = mean choice over an 8-trial mini-session per theta
    # (choice-only model gives one categorical value per trial).
    reps = 8
    theta_rep = jnp.repeat(theta, reps, axis=0)
    choices = ddm_choice_scan(
        theta_rep, jax.random.fold_in(key, 1), max_resamples=2,
        n_max=4000, steps_per_pulse=200, chunk_steps=200, t_max=2.0,
    )
    x = choices.reshape(n, reps).mean(axis=1, keepdims=True).astype(jnp.float32)

    theta_true = jnp.array([0.5, 0.3, 1.5, 8.0, 0.1])
    obs = ddm_choice_scan(
        jnp.tile(theta_true, (reps, 1)), jax.random.fold_in(key, 2),
        max_resamples=2, n_max=4000, steps_per_pulse=200, chunk_steps=200, t_max=2.0,
    )
    x_o = obs.reshape(1, reps).mean(axis=1, keepdims=True).astype(jnp.float32)
    print("theta_true:", np.asarray(theta_true), " x_o:", np.asarray(x_o))

    # --- SNPE: amortized q(theta | x) (ryans_test.ipynb cell 1) ---
    posterior_npe = train_snpe(cfg, prior, theta, x, seed=3, verbose=True)
    s_npe = np.asarray(posterior_npe.sample((2000,), x_o[0], seed=4))
    print("SNPE posterior mean:", s_npe.mean(0).round(3))

    # --- SNLE: q(x | theta) + NUTS (ryans_test.ipynb cells 2-4) ---
    flow, make_posterior = train_snle(cfg, prior, theta, x, seed=5, verbose=True)
    posterior_nle = make_posterior(x_o)
    s_nle = np.asarray(posterior_nle.sample((1000,), key=jax.random.fold_in(key, 6)))
    print("SNLE posterior mean:", s_nle.mean(0).round(3))


if __name__ == "__main__":
    main()
