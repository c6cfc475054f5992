"""Pulse-DDM Euler-Maruyama kernels as chunked ``lax.scan`` programs.

This replaces the reference's interpreted hot loop
(reference: src/sbi_for_diffusion_models/models/rt_choice_model.py:181-221 and
choice_model.py:144-171): a Python ``for t in range(16000)`` over batched torch
ops with an early ``break`` once every trial has hit a bound.

Design
------
* The time axis is an inherently sequential absorbing-boundary recurrence, so
  it stays sequential -- but as a compiled ``lax.scan``, not Python dispatch.
* The trial axis is the parallel axis: all state is ``(N,)`` vectors;
  shard the trial axis over a mesh to scale out.
* **Chunked early exit**: XLA requires a fixed trip count, so the reference's
  ``break`` becomes an outer scan over pulse-aligned chunks whose body is a
  ``lax.cond`` that skips the whole chunk once no trial is active. This
  recovers most of the early-exit win (trials typically absorb long before
  T_MAX) at chunk granularity while keeping everything static-shaped.
* **Bulk RNG**: noise is generated once per chunk as a ``(chunk, N)`` block
  (one fused PRNG kernel) instead of 16,000 tiny per-step draws. The chunk key
  is derived with ``fold_in(key, chunk_idx)`` so the random stream does not
  depend on which chunks were skipped.

Exact semantics preserved from the reference (locked by unit tests):
step update ``a += (-lam*a)*dt + sigma*sqrt(dt)*eps`` then pulse kick
``a += v*s[:,t//spp]*active`` on pulse steps, bound check after both, first
hit records ``hit_step = t+1``; non-hits censored to choice 2 with
``hit_step = n_steps``; ``rt = clip(t_nd + hit_step*dt, 1e-6, T_MAX)``
(reference rt_choice_model.py:186-218).

Collapsing-bound variant (a capability extension, see BASELINE.json configs):
with ``collapse_rate c > 0`` the bounds collapse symmetrically toward the
midline, ``upper(t) = B*f(t)``, ``lower(t) = B*(1-f(t))`` with
``f(t) = 0.5 + 0.5*exp(-c*t)``; ``c = 0`` reduces exactly to the fixed-bound
model (upper=B, lower=0).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import DT_CHOICE, T_MAX

__all__ = [
    "sanitize_theta",
    "ddm_rt_choice_scan",
    "ddm_choice_scan",
]


def sanitize_theta(theta: jnp.ndarray):
    """Parameter sanitation identical to the reference batched path
    (reference rt_choice_model.py:131-135)."""
    theta = theta.astype(jnp.float32)
    a0_frac = jnp.clip(theta[:, 0], 0.0, 1.0)
    lam = theta[:, 1]
    v = jnp.abs(theta[:, 2])
    B = jnp.maximum(jnp.abs(theta[:, 3]), 1e-6)
    t_nd = jnp.clip(theta[:, 4], 0.0, float(T_MAX) - 1e-6)
    return a0_frac, lam, v, B, t_nd


@partial(
    jax.jit,
    static_argnames=(
        "dt",
        "t_max",
        "steps_per_pulse",
        "chunk_steps",
        "n_max",
    ),
)
def ddm_rt_choice_scan(
    theta: jnp.ndarray,
    pulse_sides: jnp.ndarray,
    key: jax.Array,
    *,
    mu_sensory: float = 1.0,
    collapse_rate: float = 0.0,
    dt: float = float(DT_CHOICE),
    t_max: float = float(T_MAX),
    steps_per_pulse: int = 200,
    chunk_steps: int = 200,
    n_max: int | None = None,
) -> jnp.ndarray:
    """Batched RT+choice pulse-DDM simulator.

    Args:
      theta: (N, 5) float array [a0_frac, lam, v, B, t_nd].
      pulse_sides: (N, P) float array in {+1, -1}; P >= ceil(n_max/steps_per_pulse).
      key: jax PRNG key driving the diffusion noise.
      mu_sensory: noise sigma (reference calls it mu_sensory; rt_choice_model.py:146).
      collapse_rate: >0 enables the collapsing-bound variant; 0 = reference model.

    Returns:
      x: (N, 2) float32 [rt, choice] with choice in {0., 1., 2.} (2 = censored).
    """
    if n_max is None:
        n_max = int(t_max / dt)
    if n_max % chunk_steps != 0:
        raise ValueError(f"n_max={n_max} must be divisible by chunk_steps={chunk_steps}")
    n_chunks = n_max // chunk_steps

    a0_frac, lam, v, B, t_nd = sanitize_theta(theta)
    N = theta.shape[0]
    P = pulse_sides.shape[1]
    s = pulse_sides.astype(jnp.float32)

    # Per-trial decision window in steps (reference rt_choice_model.py:141).
    n_steps = jnp.clip(
        jnp.floor((t_max - t_nd) / dt).astype(jnp.int32), 0, n_max
    )

    # Scalar or per-trial (N,) noise scale (the 7-param variant passes
    # per-trial sigma_a; the reference model uses one global mu_sensory).
    sigma_sqrt_dt = jnp.asarray(mu_sensory, jnp.float32) * jnp.float32(dt) ** 0.5
    dtf = jnp.float32(dt)
    crate = jnp.float32(collapse_rate)

    a0 = a0_frac * B
    init = (
        a0,
        jnp.zeros((N,), jnp.bool_),
        jnp.zeros((N,), jnp.int32),
        jnp.zeros((N,), jnp.int32),
    )

    def bounds_at(t_step):
        """(upper, lower) bounds at integer step t (per-trial vectors)."""
        tt = t_step.astype(jnp.float32) * dtf
        f = 0.5 + 0.5 * jnp.exp(-crate * tt)  # f==1 when crate==0
        upper = B * f
        lower = B * (1.0 - f)
        return upper, lower

    # Fast path: chunks are exactly pulse-aligned (the default), so the pulse
    # column gather hoists out of the inner time loop and the per-step body is
    # pure leak+noise+bound-check. The inner scan is unrolled to amortize
    # per-step loop overhead.
    pulse_hoisted = chunk_steps == steps_per_pulse
    unroll = min(10, chunk_steps)

    def chunk_body(carry, chunk_idx):
        a, hit, choice, hit_step = carry
        t0 = chunk_idx * chunk_steps
        chunk_key = jax.random.fold_in(key, chunk_idx)
        any_active = jnp.any((~hit) & (t0 < n_steps))

        def run(c):
            a, hit, choice, hit_step = c
            noise = (
                jax.random.normal(chunk_key, (chunk_steps, N), jnp.float32)
                * sigma_sqrt_dt
            )
            local_i = jnp.arange(chunk_steps, dtype=jnp.int32)
            if pulse_hoisted:
                p_idx = jnp.minimum(chunk_idx, P - 1)
                s_col_hoisted = v * lax.dynamic_index_in_dim(
                    s, p_idx, axis=1, keepdims=False
                )

            def step(c2, xs):
                a, hit, choice, hit_step = c2
                i, eps = xs
                t = t0 + i
                active = (~hit) & (t < n_steps)

                # Leak + diffusion (applied unmasked, as in the reference;
                # post-hit values are never read). rt_choice_model.py:186-187.
                a = a + (-lam * a) * dtf + eps

                # Pulse kick on pulse steps, masked by active
                # (rt_choice_model.py:190-192).
                if pulse_hoisted:
                    kick = s_col_hoisted
                    is_pulse = i == 0
                else:
                    is_pulse = (t % steps_per_pulse) == 0
                    p_idx = jnp.minimum(t // steps_per_pulse, P - 1)
                    kick = v * lax.dynamic_index_in_dim(
                        s, p_idx, axis=1, keepdims=False
                    )
                a = a + kick * (is_pulse & active).astype(jnp.float32)

                # Bound crossing; first-hit step recorded as t+1
                # (rt_choice_model.py:195-204).
                upper, lower = bounds_at(t)
                hit_upper = active & (a >= upper)
                hit_lower = active & (a <= lower)
                newly = hit_upper | hit_lower
                hit_step = jnp.where(newly, t + 1, hit_step)
                choice = jnp.where(
                    hit_upper, 1, jnp.where(hit_lower, 0, choice)
                )
                hit = hit | newly
                return (a, hit, choice, hit_step), None

            (a, hit, choice, hit_step), _ = lax.scan(
                step, (a, hit, choice, hit_step), (local_i, noise), unroll=unroll
            )
            return (a, hit, choice, hit_step)

        new_carry = lax.cond(any_active, run, lambda c: c, (a, hit, choice, hit_step))
        return new_carry, None

    (a, hit, choice, hit_step), _ = lax.scan(
        chunk_body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )

    # Censoring: non-hits get category 2 with RT at the window end
    # (rt_choice_model.py:206-218).
    hit_step = jnp.where(hit, hit_step, n_steps)
    outcome = jnp.where(hit, choice, 2)
    rt = jnp.clip(t_nd + hit_step.astype(jnp.float32) * dtf, 1e-6, t_max)
    return jnp.stack([rt, outcome.astype(jnp.float32)], axis=-1)


@partial(
    jax.jit,
    static_argnames=(
        "dt",
        "t_max",
        "steps_per_pulse",
        "chunk_steps",
        "n_max",
        "max_resamples",
    ),
)
def ddm_choice_scan(
    theta: jnp.ndarray,
    key: jax.Array,
    *,
    mu_sensory: float = 1.0,
    p_success: float = 0.75,
    max_resamples: int = 0,
    dt: float = float(DT_CHOICE),
    t_max: float = float(T_MAX),
    steps_per_pulse: int = 200,
    chunk_steps: int = 200,
    n_max: int | None = None,
) -> jnp.ndarray:
    """Choice-only pulse-DDM (reference choice_model.py:62-188).

    Returns (N,) int32 choices in {-1, 0, 1}; -1 = no bound hit (invalid).
    With ``max_resamples > 0``, invalid trials are re-simulated with fresh
    noise AND fresh stimulus up to that many passes (reference
    choice_model.py:178-186), expressed as a bounded ``fori_loop`` whose body
    merges the re-run results into the invalid slots only.
    """
    if n_max is None:
        n_max = int(t_max / dt)
    N = theta.shape[0]
    P = -(-n_max // steps_per_pulse)

    def one_pass(pass_key):
        k_stim, k_noise = jax.random.split(pass_key)
        # Stimulus: correct side 50/50 per trial, each pulse matches w.p.
        # p_success (choice_model.py:43-60), generated on-device.
        correct = jnp.where(
            jax.random.uniform(jax.random.fold_in(k_stim, 0), (N, 1)) < 0.5,
            1.0,
            -1.0,
        ).astype(jnp.float32)
        match = (
            jax.random.uniform(jax.random.fold_in(k_stim, 1), (N, P))
            < p_success
        )
        s = jnp.where(match, correct, -correct)
        x = ddm_rt_choice_scan(
            theta,
            s,
            k_noise,
            mu_sensory=mu_sensory,
            dt=dt,
            t_max=t_max,
            steps_per_pulse=steps_per_pulse,
            chunk_steps=chunk_steps,
            n_max=n_max,
        )
        out = x[:, 1].astype(jnp.int32)
        return jnp.where(out == 2, -1, out)  # censored -> invalid (-1)

    out = one_pass(jax.random.fold_in(key, 0))

    if max_resamples > 0:

        def resample(i, out):
            invalid = out < 0

            def rerun(out):
                fresh = one_pass(jax.random.fold_in(key, i + 1))
                return jnp.where(invalid, fresh, out)

            return lax.cond(jnp.any(invalid), rerun, lambda o: o, out)

        out = lax.fori_loop(0, max_resamples, resample, out)

    return out
