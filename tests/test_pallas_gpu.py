"""Pallas simulator kernel against the XLA scan kernel on the GPU.

The Triton route compiles only for the GPU, so these skip elsewhere (the
``gpu`` marker; decided at run time in conftest's ``_gpu_only`` fixture).
On the card: ``python -m pytest -m gpu tests/``. ``chip_smoke.py`` phase (b)
checks the same parity at the full 16,000-step schedule. Parity is
distributional (different random streams, same model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _inputs(N, P=80, seed=0):
    key = jax.random.key(seed)
    theta = jnp.stack(
        [
            jax.random.beta(jax.random.fold_in(key, 0), 2.0, 2.0, (N,)),
            jnp.exp(-1.0 + jax.random.normal(jax.random.fold_in(key, 1), (N,))),
            jnp.exp(jax.random.normal(jax.random.fold_in(key, 2), (N,))),
            jnp.exp(2.75 + 0.5 * jax.random.normal(jax.random.fold_in(key, 3), (N,))),
            jax.random.beta(jax.random.fold_in(key, 4), 2.0, 2.0, (N,)),
        ],
        axis=-1,
    ).astype(jnp.float32)
    pulses = jnp.where(jax.random.uniform(jax.random.fold_in(key, 5), (N, P)) < 0.75, 1.0, -1.0)
    return theta, pulses


def test_pallas_matches_scan_distribution():
    from sbi_for_diffusion_models_tpu.ops.ddm_pallas import ddm_rt_choice_pallas
    from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_rt_choice_scan

    N = 65536
    theta, pulses = _inputs(N)
    xp = np.asarray(ddm_rt_choice_pallas(theta, pulses, jax.random.key(1)))
    xs = np.asarray(ddm_rt_choice_scan(theta, pulses, jax.random.key(2)))
    fp = np.bincount(xp[:, 1].astype(int), minlength=3) / N
    fs = np.bincount(xs[:, 1].astype(int), minlength=3) / N
    np.testing.assert_allclose(fp, fs, atol=0.01)
    qp = np.quantile(xp[:, 0], [0.1, 0.25, 0.5, 0.75, 0.9])
    qs = np.quantile(xs[:, 0], [0.1, 0.25, 0.5, 0.75, 0.9])
    np.testing.assert_allclose(qp, qs, rtol=0.03)


def test_pallas_zero_noise_equals_scan():
    from sbi_for_diffusion_models_tpu.ops.ddm_pallas import ddm_rt_choice_pallas
    from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_rt_choice_scan

    theta, pulses = _inputs(16384, seed=3)
    xp = np.asarray(ddm_rt_choice_pallas(theta, pulses, jax.random.key(1), mu_sensory=0.0))
    xs = np.asarray(ddm_rt_choice_scan(theta, pulses, jax.random.key(2), mu_sensory=0.0))
    np.testing.assert_array_equal(xp[:, 1], xs[:, 1])
    np.testing.assert_allclose(xp[:, 0], xs[:, 0], rtol=0, atol=1e-6)


def test_pallas_deterministic_given_key():
    from sbi_for_diffusion_models_tpu.ops.ddm_pallas import ddm_rt_choice_pallas

    theta, pulses = _inputs(8192)
    a = np.asarray(ddm_rt_choice_pallas(theta, pulses, jax.random.key(7)))
    b = np.asarray(ddm_rt_choice_pallas(theta, pulses, jax.random.key(7)))
    c = np.asarray(ddm_rt_choice_pallas(theta, pulses, jax.random.key(8)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_pallas_collapsing_bounds():
    from sbi_for_diffusion_models_tpu.ops.ddm_pallas import ddm_rt_choice_pallas

    N = 8192
    theta = jnp.tile(jnp.array([[0.5, 0.1, 0.05, 8.0, 0.0]], jnp.float32), (N, 1))
    pulses = jnp.ones((N, 80), jnp.float32)
    fixed = np.asarray(
        ddm_rt_choice_pallas(theta, pulses, jax.random.key(0), collapse_rate=0.0)
    )
    coll = np.asarray(
        ddm_rt_choice_pallas(theta, pulses, jax.random.key(0), collapse_rate=5.0)
    )
    assert coll[:, 0].mean() < fixed[:, 0].mean()


def test_auto_dispatch_picks_the_kernel_on_gpu():
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import resolve_sim_kernel

    assert resolve_sim_kernel("auto") == "pallas"


@pytest.mark.parametrize("block_trials", [32, 256])
def test_pallas_block_size_invariant(block_trials):
    """Noise is keyed by the global trial index, so the block size (and the
    warp count derived from it) leaves every trial's outcome unchanged."""
    from sbi_for_diffusion_models_tpu.ops.ddm_pallas import ddm_rt_choice_pallas

    theta, pulses = _inputs(8192 + 40, seed=4)
    ref = np.asarray(ddm_rt_choice_pallas(theta, pulses, jax.random.key(5)))
    got = np.asarray(
        ddm_rt_choice_pallas(theta, pulses, jax.random.key(5), block_trials=block_trials)
    )
    np.testing.assert_array_equal(got, ref)
