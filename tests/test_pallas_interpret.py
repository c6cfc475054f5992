"""Pallas simulator kernel (Triton route) on CPU through interpret mode.

``ops/ddm_pallas.py`` compiles only for the GPU; ``interpret=True`` runs the
same kernel body on CPU, so every ``pytest tests/`` run exercises its
shapes, padding, indexing and while-loop semantics.

Determinism strategy: with ``mu_sensory=0`` the diffusion term vanishes and
both kernels follow the identical leak + pulse-kick recurrence (reference
rt_choice_model.py:186-204), so the Pallas output must match the XLA scan
kernel *exactly* (not just distributionally) — and match analytic hit times.
The in-kernel noise (threefry-2x32 + Box-Muller) is checked here against
``jax.random``'s threefry and by its moments; distributional parity with
the scan kernel at full size is a GPU test (tests/test_pallas_gpu.py).

Small shapes keep the interpreter fast: t_max=0.8 s -> 1,600 steps,
block_trials=16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbi_for_diffusion_models_tpu.ops.ddm_pallas import (
    box_muller,
    ddm_rt_choice_pallas,
    threefry2x32,
)
from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_rt_choice_scan

DT = 5e-4
T_MAX = 0.8  # 1600 steps, 8 pulses
N_MAX = 1600
SPP = 200
P = 8


def _run_both(theta, pulses, *, mu_sensory=0.0, collapse_rate=0.0, seed=0):
    common = dict(
        mu_sensory=mu_sensory,
        collapse_rate=collapse_rate,
        dt=DT,
        t_max=T_MAX,
        steps_per_pulse=SPP,
        n_max=N_MAX,
    )
    xp = np.asarray(
        ddm_rt_choice_pallas(
            theta,
            pulses,
            jax.random.key(seed),
            block_trials=16,
            interpret=True,
            **common,
        )
    )
    xs = np.asarray(
        ddm_rt_choice_scan(
            theta, pulses, jax.random.key(seed + 1), chunk_steps=SPP, **common
        )
    )
    return xp, xs


def test_zero_noise_pulse_integration_matches_scan_and_analytic():
    """lam=0, sigma=0: a accumulates v*s kicks only; hit time is analytic.

    a0 = 0.5*B = 5.0, v = 1.2, all pulses +1 -> needs ceil(5/1.2) = 5 kicks
    to reach B = 10; the 5th kick lands on step t = 4*200 = 800, recorded as
    hit_step = 801 (first-hit off-by-one, reference rt_choice_model.py:201).
    """
    N = 16
    theta = jnp.tile(jnp.asarray([[0.5, 0.0, 1.2, 10.0, 0.0]], jnp.float32), (N, 1))
    pulses = jnp.ones((N, P), jnp.float32)
    xp, xs = _run_both(theta, pulses)
    np.testing.assert_array_equal(xp, xs)
    np.testing.assert_allclose(xp[:, 0], 801 * DT, rtol=1e-6)
    np.testing.assert_array_equal(xp[:, 1], 1.0)


def test_zero_noise_lower_bound_choice_zero():
    """All pulses -1 drive a to the lower bound -> choice 0."""
    N = 16
    theta = jnp.tile(jnp.asarray([[0.5, 0.0, 1.5, 8.0, 0.0]], jnp.float32), (N, 1))
    pulses = -jnp.ones((N, P), jnp.float32)
    xp, xs = _run_both(theta, pulses)
    np.testing.assert_array_equal(xp, xs)
    np.testing.assert_array_equal(xp[:, 1], 0.0)


def test_zero_noise_censoring_and_t_nd_window():
    """v=0, sigma=0: never hits -> censored to choice 2 with
    rt = t_nd + n_steps*dt, n_steps = floor((t_max - t_nd)/dt)
    (reference rt_choice_model.py:141,206-218)."""
    # Values chosen off the exact step-boundary: when (t_max - t_nd)/dt is an
    # integer in real arithmetic (e.g. t_nd = 0), float32 rounding of the
    # quotient differs between numpy and XLA and the floor flips by one step.
    # The Pallas==scan array_equal below locks the boundary semantics; the
    # analytic check uses interior points.
    t_nds = np.asarray([0.0501, 0.1002, 0.3333, 0.7899], np.float32)
    theta = jnp.stack(
        [
            jnp.full((4,), 0.5),
            jnp.zeros((4,)),
            jnp.zeros((4,)),
            jnp.full((4,), 10.0),
            jnp.asarray(t_nds),
        ],
        axis=-1,
    )
    pulses = jnp.ones((4, P), jnp.float32)
    xp, xs = _run_both(theta, pulses)
    np.testing.assert_array_equal(xp, xs)
    np.testing.assert_array_equal(xp[:, 1], 2.0)
    # Window math in float32, as both kernels compute it (e.g. t_nd=0 gives
    # floor(0.8f/5e-4f) = 1599, not the float64 1600).
    n_steps = np.clip(
        np.floor(
            (np.float32(T_MAX) - t_nds) / np.float32(DT)
        ).astype(int),
        0,
        N_MAX,
    )
    expected_rt = np.clip(
        t_nds + n_steps.astype(np.float32) * np.float32(DT), 1e-6, T_MAX
    )
    np.testing.assert_allclose(xp[:, 0], expected_rt, rtol=1e-5)


def test_zero_noise_leak_trajectory_matches_scan():
    """lam>0 exercises the per-step leak arithmetic in both kernels."""
    N = 8
    theta = jnp.tile(jnp.asarray([[0.4, 2.0, 1.0, 6.0, 0.05]], jnp.float32), (N, 1))
    pulses = jnp.asarray(
        np.where(np.arange(P) % 2 == 0, 1.0, -1.0)[None].repeat(N, 0), jnp.float32
    )
    xp, xs = _run_both(theta, pulses)
    np.testing.assert_allclose(xp, xs, rtol=1e-6, atol=1e-6)


def test_zero_noise_collapsing_bounds_match_scan():
    """collapse_rate > 0: the time-dependent bound check must agree exactly
    with the scan kernel's ``bounds_at`` (same f(t) = 0.5 + 0.5*exp(-c*t))."""
    N = 8
    theta = jnp.tile(jnp.asarray([[0.55, 0.0, 0.0, 9.0, 0.0]], jnp.float32), (N, 1))
    pulses = jnp.ones((N, P), jnp.float32)
    xp, xs = _run_both(theta, pulses, collapse_rate=4.0)
    np.testing.assert_allclose(xp, xs, rtol=1e-6)
    # The collapsing upper bound must eventually absorb a static a > B/2.
    np.testing.assert_array_equal(xp[:, 1], 1.0)


def _noise_kwargs(**kw):
    return dict(mu_sensory=1.0, dt=DT, t_max=T_MAX, steps_per_pulse=SPP,
                n_max=N_MAX, interpret=True, **kw)


def test_threefry_matches_jax_random():
    """The in-kernel hash is bit-identical to jax.random's threefry2x32."""
    from jax._src import prng

    k = jnp.asarray([0x243F6A88, 0x85A308D3], jnp.uint32)
    c0 = jnp.arange(64, dtype=jnp.uint32)
    c1 = jnp.arange(64, dtype=jnp.uint32) * jnp.uint32(2654435761)
    got = threefry2x32(k[0], k[1], c0, c1)
    want = prng.threefry2x32_p.bind(k[0], k[1], c0, c1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_in_kernel_normals_moments_and_ks():
    """Box-Muller over threefry words, counted by (trial, step pair) as in
    the kernel, gives independent standard normals."""
    from scipy import stats

    n = 1 << 16
    trial = jnp.arange(n, dtype=jnp.uint32) % 512
    pair = jnp.arange(n, dtype=jnp.uint32) // 512
    z0, z1 = box_muller(*threefry2x32(jnp.uint32(7), jnp.uint32(11), trial, pair))
    z0, z1 = np.asarray(z0, np.float64), np.asarray(z1, np.float64)
    for z in (z0, z1):
        assert abs(z.mean()) < 4 / np.sqrt(n)
        assert abs(z.var() - 1.0) < 4 * np.sqrt(2.0 / n)
        assert abs(stats.skew(z)) < 4 * np.sqrt(6.0 / n)
        assert abs(stats.kurtosis(z)) < 4 * np.sqrt(24.0 / n)
        assert stats.kstest(z, "norm").pvalue > 1e-3
    assert abs(np.corrcoef(z0, z1)[0, 1]) < 4 / np.sqrt(n)


def test_noise_stream_block_size_invariant():
    """Noise is keyed by (global trial, step pair), so the output does not
    depend on how trials are grouped into blocks — including a padded last
    block — and is a pure function of the key."""
    N = 40  # not a multiple of 16 or 32: the wrapper pads the last block
    theta = jnp.tile(jnp.asarray([[0.5, 0.5, 1.0, 4.0, 0.1]], jnp.float32), (N, 1))
    pulses = jnp.ones((N, P), jnp.float32)
    run = lambda key, b: np.asarray(
        ddm_rt_choice_pallas(theta, pulses, key, **_noise_kwargs(block_trials=b))
    )
    a, b = run(jax.random.key(3), 16), run(jax.random.key(3), 32)
    assert a.shape == (N, 2)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.isfinite(a))
    assert set(np.unique(a[:, 1])) <= {0.0, 1.0, 2.0}
    assert np.all((a[:, 0] >= 1e-6) & (a[:, 0] <= T_MAX))
    # Identical trials draw different noise: the stream is per trial.
    assert len(np.unique(a[:, 0])) > 1
    assert not np.array_equal(a, run(jax.random.key(4), 16))


@pytest.mark.parametrize("collapse_rate", [0.0, 5.0])
@pytest.mark.parametrize("mu_sensory", [0.0, 1.0])
def test_kernel_lowers_for_cuda(collapse_rate, mu_sensory):
    """Interpret mode bypasses the Triton lowering, so lower the kernel for
    CUDA here, with no GPU: an op the lowering rejects (e.g. negating a
    constant operand) fails on the CPU instead of on the card."""
    from functools import partial

    theta = jnp.zeros((256, 5), jnp.float32)
    pulses = jnp.ones((256, 80), jnp.float32)
    f = jax.jit(partial(ddm_rt_choice_pallas, collapse_rate=collapse_rate,
                        mu_sensory=mu_sensory))
    lowered = f.trace(theta, pulses, jax.random.key(0)).lower(
        lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()


def test_wrapper_rejects_bad_shapes():
    theta = jnp.zeros((4, 5), jnp.float32)
    with pytest.raises(ValueError, match="power of two"):
        ddm_rt_choice_pallas(theta, jnp.ones((4, P)), jax.random.key(0),
                             **_noise_kwargs(block_trials=24))
    with pytest.raises(ValueError, match="n_chunks"):
        ddm_rt_choice_pallas(theta, jnp.ones((4, P - 1)), jax.random.key(0),
                             **_noise_kwargs())
    with pytest.raises(ValueError, match="even"):
        ddm_rt_choice_pallas(theta, jnp.ones((4, 20)), jax.random.key(0),
                             mu_sensory=1.0, dt=DT, t_max=T_MAX,
                             steps_per_pulse=85, n_max=1700, interpret=True)
