"""Training-set and observed-session generation, fully on device.

API parity with the reference (src/sbi_for_diffusion_models/data_simulator.py):
``simulate_training_set_with_conditions`` (reference :33-71),
``simulate_observed_session`` (reference :74-99), ``summarize_trials``
(reference :102-111) and the z-splitting ``sim_wrapper`` (reference :14-30).

Design: the reference loops Python batches and accumulates on CPU;
here one jitted program samples z, runs the simulator kernel, and packs x for the
whole batch — batching exists only to bound device memory, not to amortize
interpreter overhead. The reference's post-hoc asserts (finiteness, choice in
{0,1,2}; data_simulator.py:62-66) are kept as host-side checks.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .models.rt_choice_model import (
    generate_pulse_matrix,
    n_pulses_max_from_schedule,
    pack_x_rt_choice,
    pulse_schedule,
    rt_choice_model_simulator_torch,
)
from .run_config import RUN_CONFIG_PARAMS, RunConfig
from .utils.rng import as_key

__all__ = [
    "sim_wrapper",
    "simulate_training_set_with_conditions",
    "simulate_observed_session",
    "summarize_trials",
]


def sim_wrapper(
    z: jnp.ndarray,
    *,
    theta_dim: int = 5,
    n_pulses: Optional[int] = None,
    mu_sensory: float = RUN_CONFIG_PARAMS.MU_SENSORY,
    log_rt: bool = RUN_CONFIG_PARAMS.LOG_RT_MANUALLY,
    rng=None,
) -> jnp.ndarray:
    """Split z = [theta, pulses] -> run simulator -> pack x
    (reference data_simulator.py:14-30)."""
    if n_pulses is None:
        n_pulses = n_pulses_max_from_schedule(*pulse_schedule())
    theta = z[:, :theta_dim]
    pulses = z[:, theta_dim : theta_dim + n_pulses]
    x = rt_choice_model_simulator_torch(
        theta, rng=rng, mu_sensory=mu_sensory, pulse_sides=pulses
    )
    return pack_x_rt_choice(x, log_rt=log_rt)


def simulate_training_set_with_conditions(
    cfg: RunConfig,
    proposal,
    *,
    num_simulations: Optional[int] = None,
    batch_size: Optional[int] = None,
    device=None,
    seed: int | jax.Array | None = 0,
    verbose: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Simulate (z, x) training pairs (reference data_simulator.py:33-71).

    Returns z: (N, 5+P) float32, x: (N, 2) float32 [rt, choice], both device-
    resident. ``device`` is accepted for signature parity and ignored (arrays
    live wherever jax's default device is).
    """
    num_simulations = int(num_simulations or cfg.NUM_SIMULATIONS)
    batch_size = int(batch_size or cfg.TRAIN_BATCH_SIZE)
    key = as_key(seed)

    # One jitted program per batch shape: proposal sampling + simulation +
    # packing fuse into a single launch.
    @partial(jax.jit, static_argnames=("bs",))
    def batch_step(k_prop, k_sim, *, bs):
        z = proposal.sample(k_prop, (bs,))
        x = sim_wrapper(
            z,
            mu_sensory=cfg.MU_SENSORY,
            log_rt=cfg.LOG_RT_MANUALLY,
            rng=k_sim,
        )
        return z, x

    zs, xs = [], []
    n_batches = -(-num_simulations // batch_size)
    for b in range(n_batches):
        start = b * batch_size
        bs = min(batch_size, num_simulations - start)
        k_prop = jax.random.fold_in(key, 2 * b)
        k_sim = jax.random.fold_in(key, 2 * b + 1)
        z, x = batch_step(k_prop, k_sim, bs=bs)
        zs.append(z)
        xs.append(x)
        if verbose and (b % 50 == 0 or b == n_batches - 1):
            print(f"[simulate] batch {b + 1}/{n_batches} ({start + bs}/{num_simulations} trials)")

    z_all = jnp.concatenate(zs, axis=0)
    x_all = jnp.concatenate(xs, axis=0)

    # Invariant checks, as in the reference (data_simulator.py:62-66).
    x_host = np.asarray(x_all)
    assert np.isfinite(x_host).all(), "non-finite simulator outputs"
    choices = x_host[:, 1]
    assert np.isin(choices, [0.0, 1.0, 2.0]).all(), "choice outside {0,1,2}"
    return z_all, x_all


def simulate_observed_session(
    theta_true,
    num_trials: int,
    *,
    mu_sensory: float = RUN_CONFIG_PARAMS.MU_SENSORY,
    p_success: float = RUN_CONFIG_PARAMS.P_SUCCESS,
    log_rt: bool = RUN_CONFIG_PARAMS.LOG_RT_MANUALLY,
    seed: int | jax.Array | None = 123,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Seeded observed session: (x_o, pulses_o)
    (reference data_simulator.py:74-99)."""
    key = as_key(seed)
    theta_true = jnp.asarray(theta_true, jnp.float32).reshape(1, -1)
    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    pulses_o = generate_pulse_matrix(
        jax.random.fold_in(key, 0), int(num_trials), P, p_success=p_success
    )
    theta_rep = jnp.broadcast_to(theta_true, (int(num_trials), theta_true.shape[1]))
    x = rt_choice_model_simulator_torch(
        theta_rep,
        rng=jax.random.fold_in(key, 1),
        mu_sensory=mu_sensory,
        pulse_sides=pulses_o,
    )
    return pack_x_rt_choice(x, log_rt=log_rt), pulses_o


def summarize_trials(name: str, x) -> None:
    """Print-based diagnostics (reference data_simulator.py:102-111)."""
    x = np.asarray(x)
    n = x.shape[0]
    rt = x[:, 0]
    choice = x[:, 1].astype(np.int64)
    counts = np.bincount(choice, minlength=3)
    fracs = counts / max(n, 1)
    print(
        f"[{name}] n={n} rt[min={rt.min():.4f}, max={rt.max():.4f}] "
        f"choices: 0={counts[0]} ({fracs[0]:.2%}), 1={counts[1]} ({fracs[1]:.2%}), "
        f"2={counts[2]} ({fracs[2]:.2%})"
    )
