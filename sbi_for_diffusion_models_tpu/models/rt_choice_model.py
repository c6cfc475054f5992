"""RT+choice pulse-DDM: public API (parity with the reference module).

Every public symbol of the reference module exists here with the same name,
signature shape, and output convention (reference:
src/sbi_for_diffusion_models/models/rt_choice_model.py). The compute path is
the scan kernel in ``ops/ddm_scan.py`` or, on the GPU, the fused kernel in
``ops/ddm_pallas.py``;
the ``*_torch`` suffix is kept for drop-in compatibility but the functions
accept/return JAX or NumPy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DT_CHOICE, PULSE_INTERVAL, T_MAX
from ..ops.ddm_scan import ddm_rt_choice_scan
from ..run_config import RUN_CONFIG_PARAMS
from ..utils.rng import as_key
from .choice_model import generate_pulse_sides

cfg = RUN_CONFIG_PARAMS


def resolve_sim_kernel(sim_kernel: Optional[str] = None) -> str:
    """Name of the simulator kernel a call runs: the fused Pallas kernel on
    the GPU (its Triton route compiles only there), the XLA scan kernel
    elsewhere (cfg.SIM_KERNEL: "auto" | "scan" | "pallas")."""
    choice = sim_kernel or cfg.SIM_KERNEL
    if choice == "auto":
        choice = "pallas" if jax.default_backend() == "gpu" else "scan"
    if choice not in ("scan", "pallas"):
        raise ValueError(f"unknown SIM_KERNEL {choice!r}")
    return choice


def dispatch_sim_kernel(sim_kernel: Optional[str] = None):
    """The simulator kernel :func:`resolve_sim_kernel` names, as one
    callable with the scan kernel's signature."""
    if resolve_sim_kernel(sim_kernel) == "pallas":
        from ..ops.ddm_pallas import ddm_rt_choice_pallas

        def run(theta, s, key, *, mu_sensory, collapse_rate, steps_per_pulse, n_max):
            return ddm_rt_choice_pallas(
                theta,
                s,
                key,
                mu_sensory=mu_sensory,
                collapse_rate=collapse_rate,
                steps_per_pulse=steps_per_pulse,
                n_max=n_max,
            )

        return run

    def run(theta, s, key, *, mu_sensory, collapse_rate, steps_per_pulse, n_max):
        return ddm_rt_choice_scan(
            theta,
            s,
            key,
            mu_sensory=mu_sensory,
            collapse_rate=collapse_rate,
            steps_per_pulse=steps_per_pulse,
            chunk_steps=min(cfg.SIM_CHUNK_STEPS, steps_per_pulse),
            n_max=n_max,
        )

    return run

ArrayLike = Union[np.ndarray, jnp.ndarray]


@dataclass(frozen=True)
class RTChoiceModelParams:
    """Named scalar parameters (reference rt_choice_model.py:15-42)."""

    a0_frac: float
    lam: float
    v: float
    B: float
    t_nd: float

    @staticmethod
    def from_theta(theta: np.ndarray) -> "RTChoiceModelParams":
        if theta.shape[-1] != 5:
            raise ValueError(
                f"Expected theta with 5 params [a0, lam, v, B, t_nd], got shape {theta.shape}."
            )
        a0, lam, v, B, t_nd = np.asarray(theta, dtype=np.float64)

        B = float(abs(B)) if np.isfinite(B) else 1.0
        B = max(B, 1e-6)
        a0 = float(np.clip(a0, 0.0, 1.0)) if np.isfinite(a0) else 0.5
        lam = float(lam) if np.isfinite(lam) else 0.0
        v = float(v) if np.isfinite(v) else 0.0
        t_nd = float(t_nd) if np.isfinite(t_nd) else 0.0
        t_nd = float(np.clip(t_nd, 0.0, float(T_MAX) - 1e-6))
        return RTChoiceModelParams(a0_frac=a0, lam=lam, v=v, B=B, t_nd=t_nd)


def pulse_schedule(*, dt: float = float(DT_CHOICE)) -> Tuple[int, int]:
    """(n_max, steps_per_pulse) for the time grid (reference rt_choice_model.py:45-54)."""
    n_max = int(np.floor(float(T_MAX) / float(dt)))
    steps_per_pulse = max(int(np.round(float(PULSE_INTERVAL) / float(dt))), 1)
    return n_max, steps_per_pulse


def n_pulses_max_from_schedule(n_max: int, steps_per_pulse: int) -> int:
    """Max pulse slots for a trial of n_max steps (reference rt_choice_model.py:57-59)."""
    return (int(n_max) + int(steps_per_pulse) - 1) // int(steps_per_pulse)


def generate_pulse_matrix_numpy(
    rng: np.random.Generator,
    n_trials: int,
    n_pulses: int,
    *,
    p_success: float = cfg.P_SUCCESS,
) -> np.ndarray:
    """Host-side stimulus matrix s in {+1,-1}^(n_trials, n_pulses).

    Same distribution as the reference (rt_choice_model.py:62-91) but
    vectorized over trials instead of a per-trial Python loop: correct side is
    50/50 per trial, each pulse matches it with probability p_success.
    """
    if n_trials < 0:
        raise ValueError("n_trials must be >= 0")
    if n_pulses < 0:
        raise ValueError("n_pulses must be >= 0")
    p = float(np.clip(p_success, 0.0, 1.0))
    correct = np.where(rng.random(n_trials) < 0.5, 1.0, -1.0).astype(np.float32)
    match = rng.random((n_trials, n_pulses)) < p
    return np.where(match, correct[:, None], -correct[:, None]).astype(np.float32)


def generate_pulse_matrix(
    key: jax.Array,
    n_trials: int,
    n_pulses: int,
    *,
    p_success: float = cfg.P_SUCCESS,
) -> jnp.ndarray:
    """Device-side stimulus matrix (same distribution, jax.random-driven)."""
    k1, k2 = jax.random.split(key)
    correct = jnp.where(
        jax.random.uniform(k1, (n_trials, 1)) < 0.5, 1.0, -1.0
    ).astype(jnp.float32)
    match = jax.random.uniform(k2, (n_trials, n_pulses)) < p_success
    return jnp.where(match, correct, -correct)


def as_pulse_tensor(
    pulse_sides: ArrayLike, *, dtype=jnp.float32, device=None
) -> jnp.ndarray:
    """Normalize pulse_sides to a (N, P) device array (reference rt_choice_model.py:94-109)."""
    s = jnp.asarray(pulse_sides, dtype=dtype)
    if s.ndim == 1:
        s = s.reshape(1, -1)
    if s.ndim != 2:
        raise ValueError(
            f"pulse_sides must have shape (N,P) or (P,), got {tuple(s.shape)}"
        )
    return s


def _simulate_rt_choice_batch(
    theta: jnp.ndarray,
    *,
    mu_sensory: float,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    rng=None,
    collapse_rate: float = 0.0,
) -> jnp.ndarray:
    """Batched simulator core wrapper (reference rt_choice_model.py:112-221).

    theta: (N,5); returns (N,2) float32 [rt, choice] with choice in {0,1,2}.
    If ``pulse_sides`` is None the stimulus is sampled internally
    (marginalizing); otherwise the simulator conditions on it, broadcasting a
    single stimulus row across the batch and truncating any extra tail.
    """
    theta = jnp.asarray(theta, jnp.float32)
    N = theta.shape[0]
    n_max, steps_per_pulse = pulse_schedule()
    n_pulses_max = n_pulses_max_from_schedule(n_max, steps_per_pulse)
    key = as_key(rng)

    if pulse_sides is None:
        s = generate_pulse_matrix(
            jax.random.fold_in(key, 1), N, n_pulses_max, p_success=p_success
        )
    else:
        s = as_pulse_tensor(pulse_sides)
        if s.shape[0] == 1 and N > 1:
            s = jnp.broadcast_to(s, (N, s.shape[1]))
        if s.shape[0] != N:
            raise ValueError(
                f"pulse_sides first dim must match batch size N={N} (or be 1 for broadcast), got {s.shape[0]}"
            )
        if s.shape[1] < n_pulses_max:
            raise ValueError(
                f"pulse_sides has P={s.shape[1]} pulses but simulator needs at least "
                f"{n_pulses_max} for T_MAX={T_MAX}s"
            )
        s = s[:, :n_pulses_max]

    run = dispatch_sim_kernel()
    return run(
        theta,
        s,
        jax.random.fold_in(key, 0),
        mu_sensory=float(mu_sensory),
        collapse_rate=float(collapse_rate),
        steps_per_pulse=steps_per_pulse,
        n_max=n_max,
    )


def rt_choice_model_simulator(
    theta: np.ndarray,
    rng: np.random.Generator,
    *,
    mu_sensory: float = 1.0,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
) -> tuple[float, int]:
    """Single-trial NumPy API (reference rt_choice_model.py:224-248)."""
    th = jnp.asarray(theta, jnp.float32).reshape(1, 5)
    x = _simulate_rt_choice_batch(
        th,
        mu_sensory=float(mu_sensory),
        pulse_sides=pulse_sides,
        p_success=float(p_success),
        rng=rng,
    )
    return float(x[0, 0]), int(x[0, 1])


def rt_choice_model_simulator_torch(
    theta: ArrayLike,
    rng=None,
    *,
    mu_sensory: float = 1.0,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    collapse_rate: float = 0.0,
) -> jnp.ndarray:
    """Batched simulator, SBI-friendly (reference rt_choice_model.py:251-283).

    The ``_torch`` suffix is historical (API parity); inputs/outputs are JAX
    arrays. theta: (N,5) or (5,), returns (N,2) float32 [rt, choice].
    """
    theta = jnp.asarray(theta, jnp.float32)
    if theta.ndim == 1:
        theta = theta.reshape(1, -1)
    if theta.shape[-1] != 5:
        raise ValueError(
            f"Expected theta shape (N,5) or (5,), got {tuple(theta.shape)}"
        )
    return _simulate_rt_choice_batch(
        theta,
        mu_sensory=float(mu_sensory),
        pulse_sides=pulse_sides,
        p_success=float(p_success),
        rng=rng,
        collapse_rate=collapse_rate,
    )


def simulate_session_data_rt_choice(
    theta_true: ArrayLike,
    num_trials: int,
    rng=None,
    *,
    mu_sensory: float = 1.0,
    pulse_sides: Optional[ArrayLike] = None,
    p_success: float = cfg.P_SUCCESS,
    return_pulse_sides: bool = False,
) -> Union[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """IID session simulator: (num_trials, 2) [rt, choice]
    (reference rt_choice_model.py:286-329). With ``return_pulse_sides=True``
    also returns the realized (num_trials, P) stimulus."""
    key = as_key(rng)
    theta_true = jnp.asarray(theta_true, jnp.float32).reshape(1, -1)
    theta_rep = jnp.broadcast_to(theta_true, (num_trials, theta_true.shape[1]))

    if pulse_sides is None:
        n_max, steps_per_pulse = pulse_schedule()
        P = n_pulses_max_from_schedule(n_max, steps_per_pulse)
        pulse_sides = generate_pulse_matrix(
            jax.random.fold_in(key, 7), num_trials, P, p_success=p_success
        )

    x = rt_choice_model_simulator_torch(
        theta_rep,
        rng=jax.random.fold_in(key, 8),
        mu_sensory=mu_sensory,
        pulse_sides=pulse_sides,
        p_success=p_success,
    )

    if return_pulse_sides:
        return x, as_pulse_tensor(pulse_sides)
    return x


def pack_x_rt_choice(rt_choice: ArrayLike, *, log_rt: bool) -> jnp.ndarray:
    """Pack to MNLE x-convention: continuous column first, discrete last;
    RT clamped then optionally logged, choice never logged
    (reference rt_choice_model.py:332-343)."""
    rt_choice = jnp.asarray(rt_choice, jnp.float32)
    rt = jnp.maximum(rt_choice[:, 0:1], 1e-6)
    if log_rt:
        rt = jnp.log(rt)
    choice = rt_choice[:, 1:2]
    return jnp.concatenate([rt, choice], axis=1)
