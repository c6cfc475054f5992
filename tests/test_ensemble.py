"""Deep-ensemble MNLE (mnle.MNLEEnsemble): mixture likelihood semantics,
duck-typing through the potential stack, persistence.

No reference counterpart — the reference trains a single estimator
(src/sbi_for_diffusion_models/mnle.py:16-50); the ensemble is this
framework's calibration lever for seed-idiosyncratic estimator bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbi_for_diffusion_models_tpu.mnle import (
    MNLEEnsemble,
    load_ensemble,
    save_model,
)
from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig, build_mnle

SMALL = dict(hidden_features=32, num_transforms=3, num_bins=8)


def _member(seed, condition_dim=9, **kw):
    cfg = MNLEConfig(condition_dim=condition_dim, num_categories=3, **SMALL, **kw)
    est = build_mnle(jax.random.key(seed), cfg)
    return est.__class__(
        cfg=cfg,
        params=est.params,
        cond_mean=0.1 * jnp.arange(condition_dim, dtype=jnp.float32),
        cond_std=jnp.linspace(0.5, 2.0, condition_dim),
        x_mean=jnp.float32(0.3),
        x_std=jnp.float32(1.7),
        train_meta={"num_train": 100 * (seed + 1)},
    )


def _data(key, n, condition_dim=9):
    k1, k2, k3 = jax.random.split(key, 3)
    rt = jnp.exp(0.5 * jax.random.normal(k1, (n,)))
    choice = jax.random.randint(k2, (n,), 0, 3).astype(jnp.float32)
    x = jnp.stack([rt, choice], -1)
    cond = jax.random.normal(k3, (n, condition_dim)) * 0.7 + 0.2
    return x, cond


@pytest.fixture(scope="module")
def ens():
    return MNLEEnsemble([_member(0), _member(1), _member(2)])


def test_log_prob_is_log_mean_exp(ens):
    x, cond = _data(jax.random.key(1), 21)
    got = ens.log_prob(x, cond)
    member_lps = np.stack(
        [np.asarray(m.log_prob(x, cond)) for m in ens.members]
    )
    want = np.log(np.mean(np.exp(member_lps), axis=0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)


def test_mixture_density_normalizes(ens):
    """A uniform mixture of normalized conditionals is normalized."""
    cond = jax.random.normal(jax.random.key(2), (9,))
    rts = jnp.linspace(1e-3, 60.0, 6000)
    total = 0.0
    for c in range(3):
        x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        lp = jax.jit(ens.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 9)))
        total += jnp.trapezoid(jnp.exp(lp), rts)
    assert abs(float(total) - 1.0) < 0.03, f"mixture integrates to {float(total)}"


def test_potential_stack_duck_typing(ens):
    """ConditionedMNLELogLikelihood + ThetaOnlyPosteriorPotential accept the
    ensemble and reproduce the manual mixture sum."""
    from sbi_for_diffusion_models_tpu.distributions import BoxUniform
    from sbi_for_diffusion_models_tpu.potentials import (
        ConditionedMNLELogLikelihood,
        ThetaOnlyPosteriorPotential,
    )

    T, D, P = 11, 5, 4
    x, _ = _data(jax.random.key(3), T)
    pulses = (jax.random.uniform(jax.random.key(4), (T, P)) > 0.5).astype(
        jnp.float32
    )
    lik = ConditionedMNLELogLikelihood(ens, pulses)
    theta = jnp.abs(jax.random.normal(jax.random.key(5), (3, D))) * 0.3 + 0.2
    out = lik(x, theta)
    assert out.shape == (1, 3)

    cond = jnp.concatenate(
        [jnp.broadcast_to(theta[0], (T, D)), pulses], axis=-1
    )
    want = float(jnp.sum(ens.log_prob(x, cond)))
    np.testing.assert_allclose(float(out[0, 0]), want, rtol=1e-5)

    prior = BoxUniform(jnp.zeros(D), jnp.ones(D) * 2)
    pot = ThetaOnlyPosteriorPotential(prior=prior, likelihood=lik, x_o=x)
    vals = pot(theta)
    assert vals.shape == (3,) and bool(jnp.all(jnp.isfinite(vals)))
    # potential_fn (the NUTS path) is differentiable through the mixture
    g = jax.grad(pot.potential_fn)(theta[0])
    assert g.shape == (D,) and bool(jnp.all(jnp.isfinite(g)))


def test_sample_rows_come_from_members(ens):
    _, cond = _data(jax.random.key(6), 8)
    key = jax.random.key(7)
    draw = ens.sample(key, cond)
    assert draw.shape == (8, 2)
    # Each row must equal one member's draw for that row under the same key
    # threading (k_draw = split(key)[1], member i uses fold_in(k_draw, i)).
    k_draw = jax.random.split(key)[1]
    member_draws = np.stack(
        [
            np.asarray(m.sample_fn(m.params, jax.random.fold_in(k_draw, i), cond))
            for i, m in enumerate(ens.members)
        ]
    )
    d = np.asarray(draw)
    for r in range(8):
        assert any(
            np.allclose(d[r], member_draws[k, r]) for k in range(len(ens.members))
        )


def test_save_load_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    m0, m1 = _member(0), _member(1)
    save_model(m0, filename="e.m0.npz")
    save_model(m1, filename="e.m1.npz")
    ens2 = load_ensemble("e.m0.npz,e.m1.npz")
    assert len(ens2) == 2
    x, cond = _data(jax.random.key(9), 7)
    want = MNLEEnsemble([m0, m1]).log_prob(x, cond)
    np.testing.assert_allclose(
        np.asarray(ens2.log_prob(x, cond)), np.asarray(want), rtol=1e-5, atol=1e-6
    )
    assert ens2.train_meta["ensemble_size"] == 2
    assert ens2.train_meta["num_train"] == 300


def test_config_mismatch_raises():
    with pytest.raises(ValueError, match="share one MNLEConfig"):
        MNLEEnsemble([_member(0), _member(1, condition_dim=10)])


def test_empty_raises():
    with pytest.raises(ValueError, match="at least one member"):
        MNLEEnsemble([])
