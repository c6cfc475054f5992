"""MNLE estimator: normalization, training, save/load round-trip."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbi_for_diffusion_models_tpu.mnle import load_model, save_model, train_mnle
from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig, build_mnle
from sbi_for_diffusion_models_tpu.run_config import RUN_CONFIG_PARAMS

SMALL = dict(hidden_features=32, num_transforms=3, num_bins=8)


@pytest.fixture(scope="module")
def untrained():
    cfg = MNLEConfig(condition_dim=4, num_categories=3, **SMALL)
    return build_mnle(jax.random.key(0), cfg)


def test_log_prob_normalizes(untrained):
    """Integral over rt x sum over choices of p(x|z) must be ~1."""
    est = untrained
    cond = jax.random.normal(jax.random.key(1), (4,))
    rts = jnp.linspace(1e-3, 60.0, 8000)
    total = 0.0
    for c in range(3):
        x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        lp = jax.jit(est.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 4)))
        total += jnp.trapezoid(jnp.exp(lp), rts)
    assert abs(float(total) - 1.0) < 0.02, f"density integrates to {float(total)}"


def test_training_learns_synthetic_likelihood():
    """Train on rt ~ LogNormal(0.5 z0, 0.3), choice ~ Bern(sigmoid(2 z1))."""
    key = jax.random.key(3)
    N, D = 3000, 4
    z = jax.random.normal(jax.random.fold_in(key, 0), (N, D))
    rt = jnp.exp(0.5 * z[:, 0] + 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (N,)))
    choice = (
        jax.random.uniform(jax.random.fold_in(key, 2), (N,))
        < jax.nn.sigmoid(2.0 * z[:, 1])
    ).astype(jnp.float32)
    x = jnp.stack([rt, choice], -1)
    cfg = RUN_CONFIG_PARAMS.replace(
        TRAIN_BATCH_SIZE=500,
        TRAIN_MAX_EPOCHS=60,
        TRAIN_STOP_AFTER_EPOCHS=12,
        MNLE_HIDDEN_FEATURES=32,
        MNLE_NUM_TRANSFORMS=3,
        MNLE_NUM_BINS=8,
    )
    est = train_mnle(cfg, None, z, x, verbose=False)

    zt, xt = z[:200], x[:200]
    lp = jax.jit(est.log_prob)(xt, zt)
    mu_t = 0.5 * zt[:, 0]
    ln = (
        -jnp.log(xt[:, 0])
        - jnp.log(0.3)
        - 0.5 * math.log(2 * math.pi)
        - 0.5 * ((jnp.log(xt[:, 0]) - mu_t) / 0.3) ** 2
    )
    p1 = jax.nn.sigmoid(2.0 * zt[:, 1])
    cat = jnp.where(xt[:, 1] == 1, jnp.log(p1), jnp.log1p(-p1))
    true_lp = ln + cat
    corr = float(jnp.corrcoef(lp, true_lp)[0, 1])
    assert corr > 0.8, f"learned log-lik poorly correlated with truth: {corr}"


def test_tail_sharp_auto_c_from_training_data(monkeypatch, tmp_path):
    """MNLE_TAIL_SHARP_C=None resolves to just below the training data's
    left edge in standardized units (train_mnle), so real decision times
    are never distorted."""
    key = jax.random.key(9)
    N = 1500
    z = jax.random.normal(jax.random.fold_in(key, 0), (N, 4))
    rt = 0.3 + jnp.exp(
        0.3 * z[:, 0]
        + 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (N,))
    )
    choice = (
        jax.random.uniform(jax.random.fold_in(key, 2), (N,)) < 0.5
    ).astype(jnp.float32)
    x = jnp.stack([rt, choice], -1)
    cfg = RUN_CONFIG_PARAMS.replace(
        TRAIN_BATCH_SIZE=500, TRAIN_MAX_EPOCHS=2, TRAIN_STOP_AFTER_EPOCHS=2,
        MNLE_HIDDEN_FEATURES=16, MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=5,
        MNLE_TAIL_SHARP_K=1.5,  # MNLE_TAIL_SHARP_C stays None (auto)
    )
    est = train_mnle(cfg, None, z, x, verbose=False)
    c = est.cfg.tail_sharp_c
    assert c is not None and np.isfinite(c)
    # c sits below the standardized training t's 0.1% quantile.
    t_std = (jnp.log(rt) - est.x_mean) / est.x_std
    assert c <= float(np.quantile(np.asarray(t_std), 1e-3))
    # and the trained estimator round-trips through save/load with it.
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    save_model(est, cfg, filename="sharp.npz")
    est2 = load_model("sharp.npz")
    assert est2.cfg.tail_sharp_k == est.cfg.tail_sharp_k
    assert est2.cfg.tail_sharp_c == est.cfg.tail_sharp_c


def test_sample_roundtrip(untrained):
    est = untrained
    cond = jnp.zeros((512, 4))
    samp = jax.jit(est.sample)(jax.random.key(5), cond)
    assert samp.shape == (512, 2)
    assert bool(jnp.all(samp[:, 0] > 0))  # rt positive after exp
    assert set(np.unique(np.asarray(samp[:, 1]))) <= {0.0, 1.0, 2.0}


def test_embedded_log_prob_normalizes():
    """The pulse-embedding context path must stay a normalized density."""
    cfg = MNLEConfig(
        condition_dim=12, num_categories=3, pulse_dim=8, embed_dim=6, **SMALL
    )
    est = build_mnle(jax.random.key(7), cfg)
    key = jax.random.key(8)
    theta = jnp.abs(jax.random.normal(jax.random.fold_in(key, 0), (4,))) + 0.1
    pulses = jnp.where(
        jax.random.uniform(jax.random.fold_in(key, 1), (8,)) < 0.5, 1.0, -1.0
    )
    cond = jnp.concatenate([theta, pulses])
    rts = jnp.linspace(1e-3, 60.0, 8000)
    total = 0.0
    for c in range(3):
        x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        lp = jax.jit(est.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 12)))
        total += jnp.trapezoid(jnp.exp(lp), rts)
    assert abs(float(total) - 1.0) < 0.02, f"density integrates to {float(total)}"


def test_append_mode_log_prob_normalizes():
    """embed_mode="append" (raw pulses kept + features appended, with and
    without a learned embedding) must stay a normalized density."""
    for embed_dim in (0, 6):
        cfg = MNLEConfig(
            condition_dim=12, num_categories=3, pulse_dim=8,
            embed_dim=embed_dim, embed_mode="append", **SMALL,
        )
        est = build_mnle(jax.random.key(17), cfg)
        key = jax.random.key(18)
        theta = jnp.abs(jax.random.normal(jax.random.fold_in(key, 0), (4,))) + 0.1
        pulses = jnp.where(
            jax.random.uniform(jax.random.fold_in(key, 1), (8,)) < 0.5, 1.0, -1.0
        )
        cond = jnp.concatenate([theta, pulses])
        rts = jnp.linspace(1e-3, 60.0, 8000)
        total = 0.0
        for c in range(3):
            x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
            lp = jax.jit(est.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 12)))
            total += jnp.trapezoid(jnp.exp(lp), rts)
        assert abs(float(total) - 1.0) < 0.02, (
            f"embed_dim={embed_dim}: density integrates to {float(total)}"
        )


def test_pulse_physics_features():
    """Decayed-evidence summaries: all-same-side pulses with zero leak give
    F = n_visible / sqrt(n_visible); flipping the stimulus flips the sign."""
    from sbi_for_diffusion_models_tpu.nets.mnle_net import (
        _FEATURE_HORIZONS,
        pulse_physics_features,
    )

    P = 8
    theta = jnp.array([0.5, 1e-8, 1.0, 10.0, 0.1])  # lam ~ 0 at index 1
    s = jnp.ones((P,))
    c = jnp.concatenate([theta, s])
    f = pulse_physics_features(c, 5, P, 1)
    assert f.shape == (len(_FEATURE_HORIZONS),)
    # Horizon 0.25s sees pulses at t=0.0,0.1,0.2 -> 3 pulses.
    np.testing.assert_allclose(float(f[0]), 3.0 / np.sqrt(3.0), rtol=1e-3)
    f_neg = pulse_physics_features(jnp.concatenate([theta, -s]), 5, P, 1)
    np.testing.assert_allclose(np.asarray(f_neg), -np.asarray(f), rtol=1e-5)
    # Strong leak shrinks nothing in the normalized statistic's variance
    # scale but the values stay finite.
    theta_hi = theta.at[1].set(5.0)
    f_hi = pulse_physics_features(jnp.concatenate([theta_hi, s]), 5, P, 1)
    assert bool(jnp.all(jnp.isfinite(f_hi)))


def test_embedded_training_uses_pulse_block():
    """Train with embedding on data where rt depends on a decayed pulse sum;
    the estimator must track it (correlation with truth)."""
    from sbi_for_diffusion_models_tpu.proposals import (
        ExtendedProposal,
        PulseSequenceProposal,
    )
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta

    key = jax.random.key(11)
    prior = build_prior_theta()
    prop = ExtendedProposal(prior, PulseSequenceProposal(16, 0.75))
    N = 3000
    z = prop.sample(jax.random.fold_in(key, 0), (N,))
    drive = jnp.tanh(z[:, 5:].sum(-1) / 4.0)
    rt = jnp.exp(0.3 * drive + 0.25 * jax.random.normal(jax.random.fold_in(key, 1), (N,)))
    choice = (jax.random.uniform(jax.random.fold_in(key, 2), (N,)) < 0.5).astype(
        jnp.float32
    )
    x = jnp.stack([rt, choice], -1)
    cfg = RUN_CONFIG_PARAMS.replace(
        TRAIN_BATCH_SIZE=500,
        TRAIN_MAX_EPOCHS=40,
        TRAIN_STOP_AFTER_EPOCHS=10,
        MNLE_HIDDEN_FEATURES=32,
        MNLE_NUM_TRANSFORMS=3,
        MNLE_NUM_BINS=8,
        MNLE_EMBED_DIM=8,
    )
    est = train_mnle(cfg, prop, z, x, verbose=False)
    assert est.cfg.pulse_dim == 16 and est.cfg.embed_dim == 8
    lp = jax.jit(est.log_prob)(x[:300], z[:300])
    assert bool(jnp.all(jnp.isfinite(lp)))
    assert est.train_meta is not None and est.train_meta["num_train"] == N


def test_save_load_roundtrip_embedded(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    cfg = MNLEConfig(
        condition_dim=12, num_categories=3, pulse_dim=8, embed_dim=6, **SMALL
    )
    est = build_mnle(jax.random.key(13), cfg)
    save_model(est, RUN_CONFIG_PARAMS, filename="embedded.npz")
    est2 = load_model("embedded.npz")
    x = jnp.array([[0.5, 1.0], [2.0, 0.0]])
    c = jnp.concatenate(
        [jnp.abs(jax.random.normal(jax.random.key(14), (2, 4))) + 0.1,
         jnp.ones((2, 8))], axis=-1,
    )
    np.testing.assert_allclose(
        np.asarray(est.log_prob(x, c)), np.asarray(est2.log_prob(x, c)), rtol=1e-6
    )


def test_double_log_transform_rejected():
    cfg = RUN_CONFIG_PARAMS.replace(LOG_RT_MANUALLY=True, SBI_LOG_TRANSFORM_X=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_mnle(cfg, None, jnp.zeros((20, 4)), jnp.ones((20, 2)))


def test_pulse_grid_split_join_roundtrip():
    """rt -> (k, s) -> rt must round-trip away from clip boundaries, with the
    logit log-det matching autodiff."""
    from sbi_for_diffusion_models_tpu.nets.mnle_net import (
        pulse_grid_join,
        pulse_grid_split,
    )

    cfg = MNLEConfig(
        condition_dim=9, rt_rep="pulse", censor_rt=True, num_pulse_slots=8,
        pulse_interval=0.1, grid_anchor="tnd", **SMALL,
    )
    t_nd = jnp.float32(0.23)
    rt = jnp.array([0.2315, 0.3301, 0.5250, 0.9999, 1.0295], jnp.float32)
    k, phi, s, ds, barrier = pulse_grid_split(cfg, rt, t_nd)
    np.testing.assert_array_equal(np.asarray(k), [0, 1, 2, 7, 7])
    # absolute anchor: slots counted from 0, phase is the raw fraction
    cfg_abs = MNLEConfig(
        condition_dim=9, rt_rep="pulse", censor_rt=True, num_pulse_slots=16,
        pulse_interval=0.1, grid_anchor="absolute", **SMALL,
    )
    ka, phia, sa, dsa, _ = pulse_grid_split(cfg_abs, rt, t_nd)
    np.testing.assert_array_equal(np.asarray(ka), [2, 3, 5, 9, 10])
    np.testing.assert_allclose(np.asarray(sa), np.asarray(phia))
    backa = pulse_grid_join(cfg_abs, ka, sa, t_nd)
    np.testing.assert_allclose(np.asarray(backa), np.asarray(rt), atol=1e-5)
    assert float(jnp.abs(barrier).max()) == 0.0
    back = pulse_grid_join(cfg, k, s, t_nd)
    np.testing.assert_allclose(np.asarray(back), np.asarray(rt), atol=1e-5)
    # log-det parity with autodiff of s(rt)
    def s_of_rt(r):
        return pulse_grid_split(cfg, r, t_nd)[2]
    g = jax.vmap(jax.grad(s_of_rt))(rt)
    np.testing.assert_allclose(np.asarray(ds), np.log(np.abs(np.asarray(g))),
                               rtol=1e-4)
    # barrier activates smoothly for rt <= t_nd
    *_, b2 = pulse_grid_split(cfg, jnp.float32(0.2), t_nd)
    assert float(b2) < 0.0


@pytest.mark.parametrize("anchor", ["tnd", "absolute"])
def test_pulse_rep_log_prob_normalizes(anchor):
    """The slot/phase factorization must integrate to 1 - P(censored) over rt
    exactly (neither phase transform has support leak)."""
    cfg = MNLEConfig(
        condition_dim=9, num_categories=3, rt_rep="pulse", censor_rt=True,
        num_pulse_slots=8, pulse_interval=0.1, grid_anchor=anchor, **SMALL,
    )
    est = build_mnle(jax.random.key(21), cfg)
    theta = jnp.array([0.5, 0.4, 1.2, 8.0, 0.31], jnp.float32)
    pulses = jnp.where(
        jax.random.uniform(jax.random.key(22), (4,)) < 0.5, 1.0, -1.0
    )
    cond = jnp.concatenate([theta, pulses])
    t_nd = float(theta[4]) if anchor == "tnd" else 0.0
    # integrate per-slot in phase space (the density is spiky in rt)
    phis = jnp.linspace(1e-4, 1.0 - 1e-4, 4000)
    total = 0.0
    for c in (0, 1):
        for k in range(8):
            rts = t_nd + (k + phis) * 0.1
            x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
            lp = jax.jit(est.log_prob)(
                x, jnp.broadcast_to(cond, (rts.shape[0], 9))
            )
            total += jnp.trapezoid(jnp.exp(lp), rts)
    # categorical mass of the censored category
    logits = est._net.choice_logits(
        est.params,
        est._net.make_context(
            est.params, (cond - est.cond_mean) / est.cond_std, cond
        ),
    )
    p_cens = float(jnp.exp(logits[2]))
    assert abs(float(total) + p_cens - 1.0) < 0.01, (
        f"sum over non-censored = {float(total)}, P(cens) = {p_cens}"
    )


def test_pulse_rep_learns_atomic_rts():
    """Training data with RTs atomic on the pulse grid (slot depending on a
    pulse feature): the pulse rep must concentrate slot probability far more
    sharply than chance."""
    cfg = RUN_CONFIG_PARAMS.replace(
        MNLE_RT_REP="pulse", MNLE_CENSOR_RT=True,
        MNLE_HIDDEN_FEATURES=32, MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=8,
        TRAIN_MAX_EPOCHS=80, TRAIN_LEARNING_RATE=2e-3, TRAIN_BATCH_SIZE=256,
    )
    key = jax.random.key(30)
    N, P = 4000, 8
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu.proposals import (
        ExtendedProposal,
        PulseSequenceProposal,
    )

    prior = build_prior_theta()
    prop = ExtendedProposal(prior, PulseSequenceProposal(P, 0.75))
    z = prop.sample(jax.random.fold_in(key, 0), (N,))
    # slot index driven by the first pulse sign; phase concentrated near 0.03
    k_slot = jnp.where(z[:, 5] > 0, 2, 5)
    phi = 0.02 + 0.02 * jax.random.uniform(jax.random.fold_in(key, 1), (N,))
    rt = z[:, 4] + (k_slot + phi) * 0.1
    choice = (jax.random.uniform(jax.random.fold_in(key, 2), (N,)) < 0.5)
    x = jnp.stack([rt, choice.astype(jnp.float32)], -1)
    est = train_mnle(cfg, prop, z, x, seed=3, verbose=False)
    assert est.cfg.rt_rep == "pulse"
    # slot head must put most mass on the correct slot per condition
    cond = z[:7]
    c_std = (cond - est.cond_mean) / est.cond_std
    ctx = est._net.make_context(est.params, c_std, cond)
    oh = jax.nn.one_hot(jnp.asarray(x[:7, 1], jnp.int32), 3)
    slot_lp = est._net.slot_logits(est.params, ctx, oh)
    k_hat = jnp.argmax(slot_lp, -1)
    # default anchor is absolute: expected slot = floor(rt / Delta) per row.
    # Atoms near a slot boundary legitimately split mass across the two
    # adjacent slots, so allow off-by-one with a majority exactly right.
    k_want = jnp.floor(x[:7, 0] / 0.1).astype(jnp.int32)
    assert int((jnp.abs(k_hat - k_want) <= 1).sum()) == 7, (
        f"slot head missed: {k_hat} vs {k_want}"
    )
    assert int((k_hat == k_want).sum()) >= 4
    # samples respect the grid: phase of sampled rts near the data's phase
    samp = est.sample(jax.random.key(31), jnp.broadcast_to(cond[0], (256, 85 - 80 + P + 0)))
    samp_rt = samp[:, 0][samp[:, 1] != 2]
    ph = ((samp_rt - cond[0, 4]) / 0.1) % 1.0
    assert float(jnp.median(ph)) < 0.25


def test_pulse_rep_requires_censoring():
    cfg = MNLEConfig(condition_dim=9, rt_rep="pulse", censor_rt=False, **SMALL)
    with pytest.raises(ValueError, match="censor_rt"):
        build_mnle(jax.random.key(0), cfg)


def test_num_categories_explicit_and_validated():
    """MNLE_NUM_CATEGORIES pins the category count (for variants whose rare
    categories may be missing from a finite training draw); data containing
    an out-of-range category is rejected loudly."""
    cfg = RUN_CONFIG_PARAMS.replace(
        MNLE_NUM_CATEGORIES=4,
        NUM_SIMULATIONS=64,
        TRAIN_MAX_EPOCHS=1,
        MNLE_HIDDEN_FEATURES=16,
        MNLE_NUM_TRANSFORMS=2,
        MNLE_NUM_BINS=8,
    )
    z = jnp.concatenate(
        [jnp.abs(jax.random.normal(jax.random.key(0), (64, 5))) + 0.2,
         jnp.ones((64, 3))], -1,
    )
    x = jnp.stack(
        [jnp.exp(0.1 * jax.random.normal(jax.random.key(1), (64,))),
         jnp.zeros((64,))], -1,
    )
    est = train_mnle(cfg, None, z, x)
    assert est.cfg.num_categories == 4  # not the data-inferred 3
    bad = x.at[0, 1].set(7.0)
    with pytest.raises(ValueError, match="MNLE_NUM_CATEGORIES"):
        train_mnle(cfg, None, z, bad)


def test_z_score_x_string_semantics():
    """Z_SCORE_X is a string in the reference; unknown values must be loudly
    rejected, and None/'none' must disable x standardization."""
    cfg = RUN_CONFIG_PARAMS.replace(Z_SCORE_X="banana")
    with pytest.raises(ValueError, match="Z_SCORE_X"):
        train_mnle(cfg, None, jnp.zeros((20, 4)), jnp.ones((20, 2)))

    key = jax.random.key(21)
    z = jax.random.normal(jax.random.fold_in(key, 0), (64, 4))
    rt = jnp.exp(jax.random.normal(jax.random.fold_in(key, 1), (64,)))
    x = jnp.stack([rt, jnp.zeros((64,))], -1)
    small = dict(
        TRAIN_BATCH_SIZE=32, TRAIN_MAX_EPOCHS=2, TRAIN_STOP_AFTER_EPOCHS=1,
        MNLE_HIDDEN_FEATURES=16, MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=4,
    )
    est_none = train_mnle(
        RUN_CONFIG_PARAMS.replace(Z_SCORE_X=None, **small), None, z, x,
        verbose=False,
    )
    assert not est_none.cfg.z_score_x
    for name in ("independent", "structured"):
        est = train_mnle(
            RUN_CONFIG_PARAMS.replace(Z_SCORE_X=name, **small), None, z, x,
            verbose=False,
        )
        assert est.cfg.z_score_x


def test_censored_rt_likelihood():
    """With censor_rt=True, censored rows contribute exactly the categorical
    log-probability (no flow term), and sampling pins censored RT to T_MAX."""
    from sbi_for_diffusion_models_tpu.constants import T_MAX

    cfg = MNLEConfig(condition_dim=4, num_categories=3, censor_rt=True, **SMALL)
    est = build_mnle(jax.random.key(17), cfg)
    cond = jax.random.normal(jax.random.key(18), (6, 4))
    x_cens = jnp.stack([jnp.full((6,), T_MAX), jnp.full((6,), 2.0)], -1)
    lp = est.log_prob(x_cens, cond)
    # Pure categorical: independent of the RT value for censored rows.
    x_cens_other = x_cens.at[:, 0].set(1.234)
    np.testing.assert_allclose(
        np.asarray(lp), np.asarray(est.log_prob(x_cens_other, cond)), rtol=1e-6
    )
    # Sum over choices of P(choice | z) must be exactly 1 for the discrete
    # block, and the (rt, choice in {0,1}) part must integrate to
    # 1 - P(censored | z).
    rts = jnp.linspace(1e-3, 60.0, 8000)
    c0 = jnp.broadcast_to(cond[0], (rts.shape[0], 4))
    total = 0.0
    for c in range(2):
        xx = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        total += jnp.trapezoid(jnp.exp(jax.jit(est.log_prob)(xx, c0)), rts)
    p_cens = float(jnp.exp(lp[0]))
    np.testing.assert_allclose(float(total), 1.0 - p_cens, atol=0.02)
    # Sampling: censored draws carry rt == T_MAX.
    samp = np.asarray(est.sample(jax.random.key(19), jnp.zeros((2048, 4))))
    cens = samp[:, 1] == 2.0
    assert cens.any()
    np.testing.assert_allclose(samp[cens, 0], T_MAX)


def test_save_load_roundtrip(tmp_path, untrained, monkeypatch):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    save_model(untrained, RUN_CONFIG_PARAMS)
    est2 = load_model()
    x = jnp.array([[0.5, 1.0], [2.0, 0.0]])
    c = jnp.zeros((2, 4))
    np.testing.assert_allclose(
        np.asarray(untrained.log_prob(x, c)),
        np.asarray(est2.log_prob(x, c)),
        rtol=1e-6,
    )


def test_pulse_rep_warns_uncalibrated():
    """MNLE_RT_REP='pulse' is research scaffolding: every measured
    96-dataset SBC run failed rank uniformity (round-2 VERDICT), so
    train_mnle must warn loudly on use."""
    import warnings

    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu.proposals import (
        ExtendedProposal,
        PulseSequenceProposal,
    )

    cfg = RUN_CONFIG_PARAMS.replace(
        MNLE_RT_REP="pulse", MNLE_CENSOR_RT=True,
        MNLE_HIDDEN_FEATURES=8, MNLE_NUM_TRANSFORMS=1, MNLE_NUM_BINS=4,
        TRAIN_MAX_EPOCHS=1, TRAIN_BATCH_SIZE=64,
    )
    prior = build_prior_theta()
    prop = ExtendedProposal(prior, PulseSequenceProposal(8, 0.75))
    key = jax.random.key(0)
    z = prop.sample(key, (128,))
    rt = z[:, 4] + 0.25
    choice = jnp.zeros((128,), jnp.float32)
    x = jnp.stack([rt, choice], -1)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        train_mnle(cfg, prop, z, x, seed=0, verbose=False)
    assert any("UNCALIBRATED" in str(w.message) for w in rec)


# ---------------------------------------------------------------------------
# Log-theta conditioning (MNLE_LOG_THETA_DIMS / MNLEConfig.log_condition_dims)
# ---------------------------------------------------------------------------
def test_log_condition_dims_equals_manual_pretransform():
    """log_prob with log_condition_dims == log_prob of a raw-conditioned
    twin evaluated on the pre-logged condition (same params/stats)."""
    from sbi_for_diffusion_models_tpu.nets.mnle_net import transform_condition

    cfg_log = MNLEConfig(
        condition_dim=4, num_categories=3, log_condition_dims=(1, 2), **SMALL
    )
    cfg_raw = MNLEConfig(condition_dim=4, num_categories=3, **SMALL)
    est_log = build_mnle(jax.random.key(0), cfg_log)
    est_raw = build_mnle(jax.random.key(0), cfg_raw)  # same init key
    x = jnp.array([[0.5, 1.0], [2.0, 0.0], [0.9, 2.0]])
    cond = jnp.abs(jax.random.normal(jax.random.key(1), (3, 4))) + 0.1
    got = est_log.log_prob(x, cond)
    want = est_raw.log_prob(x, transform_condition(cfg_log, cond))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_log_condition_dims_normalizes():
    cfg = MNLEConfig(
        condition_dim=4, num_categories=3, log_condition_dims=(1, 2), **SMALL
    )
    est = build_mnle(jax.random.key(2), cfg)
    cond = jnp.abs(jax.random.normal(jax.random.key(3), (4,))) + 0.1
    rts = jnp.linspace(1e-3, 60.0, 8000)
    total = 0.0
    for c in range(3):
        x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        lp = jax.jit(est.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 4)))
        total += jnp.trapezoid(jnp.exp(lp), rts)
    assert abs(float(total) - 1.0) < 0.02


def test_log_theta_dims_train_and_roundtrip(tmp_path, monkeypatch):
    """train_mnle computes stats on the logged view, persists the tuple
    through save/load, and the gradient w.r.t. condition is finite."""
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    key = jax.random.key(5)
    N = 600
    z = jnp.abs(jax.random.normal(jax.random.fold_in(key, 0), (N, 4))) + 0.05
    rt = jnp.exp(
        0.4 * jnp.log(z[:, 1]) + 0.2 * jax.random.normal(jax.random.fold_in(key, 1), (N,))
    )
    choice = (jax.random.uniform(jax.random.fold_in(key, 2), (N,)) < 0.5).astype(
        jnp.float32
    )
    x = jnp.stack([rt, choice], -1)
    cfg = RUN_CONFIG_PARAMS.replace(
        TRAIN_BATCH_SIZE=200,
        TRAIN_MAX_EPOCHS=3,
        TRAIN_STOP_AFTER_EPOCHS=3,
        MNLE_HIDDEN_FEATURES=32,
        MNLE_NUM_TRANSFORMS=3,
        MNLE_NUM_BINS=8,
        MNLE_LOG_THETA_DIMS=(1, 2),
    )
    est = train_mnle(cfg, None, z, x, verbose=False)
    assert est.cfg.log_condition_dims == (1, 2)
    # stats computed on the logged view: mean of logged col 1
    np.testing.assert_allclose(
        float(est.cond_mean[1]), float(jnp.mean(jnp.log(z[:, 1]))), rtol=1e-5
    )
    save_model(est, cfg, filename="logdims.npz")
    est2 = load_model("logdims.npz")
    assert est2.cfg.log_condition_dims == (1, 2)  # JSON list -> tuple
    xt, zt = x[:8], z[:8]
    np.testing.assert_allclose(
        np.asarray(est.log_prob(xt, zt)), np.asarray(est2.log_prob(xt, zt)),
        rtol=1e-6,
    )
    g = jax.grad(lambda c: jnp.sum(est.log_prob(xt, c)))(zt)
    assert bool(jnp.all(jnp.isfinite(g)))


def test_log_theta_dims_out_of_range_rejected():
    cfg = RUN_CONFIG_PARAMS.replace(
        MNLE_HIDDEN_FEATURES=32, MNLE_NUM_TRANSFORMS=3, MNLE_NUM_BINS=8,
        MNLE_LOG_THETA_DIMS=(9,),
    )
    z = jnp.ones((50, 4))
    x = jnp.stack([jnp.ones(50), jnp.zeros(50)], -1)
    with pytest.raises(ValueError, match="outside the condition block"):
        train_mnle(cfg, None, z, x, verbose=False)


def test_cond_affine_with_pulse_rep_rejected():
    """MNLE_COND_AFFINE is a spline-chain preconditioner; with the pulse
    slot/phase factorization there is no spline chain, so train_mnle must
    reject the combination instead of silently ignoring the flag (advisor
    round-4 finding)."""
    cfg = RUN_CONFIG_PARAMS.replace(
        MNLE_HIDDEN_FEATURES=32, MNLE_NUM_TRANSFORMS=3, MNLE_NUM_BINS=8,
        MNLE_RT_REP="pulse", MNLE_CENSOR_RT=True, MNLE_COND_AFFINE=True,
    )
    z = jnp.ones((50, 9))
    x = jnp.stack([jnp.full(50, 0.4), jnp.zeros(50)], -1)
    with pytest.raises(ValueError, match="MNLE_COND_AFFINE"):
        train_mnle(cfg, None, z, x, verbose=False)


# ---------------------------------------------------------------------------
# Shifted-log RT representation (rt_rep="shifted_log": flow over decision
# time log(rt - t_nd); hard onset built into the representation)
# ---------------------------------------------------------------------------
def _shifted_small_est(key=31):
    cfg = MNLEConfig(
        condition_dim=9, num_categories=3, rt_rep="shifted_log",
        censor_rt=True, **SMALL,
    )
    return build_mnle(jax.random.key(key), cfg), cfg


def test_shifted_log_normalizes():
    """p(rt, c=0..1 | z) must integrate (over rt in (t_nd, inf)) to
    1 - P(censored): the shifted-log change of variables is exact."""
    est, cfg = _shifted_small_est()
    theta = jnp.array([0.5, 0.4, 1.2, 8.0, 0.31], jnp.float32)
    pulses = jnp.where(
        jax.random.uniform(jax.random.key(32), (4,)) < 0.5, 1.0, -1.0
    )
    cond = jnp.concatenate([theta, pulses])
    # integrate in decision-time space (log-spaced grid covers the spike)
    dts = jnp.exp(jnp.linspace(jnp.log(1e-5), jnp.log(200.0), 8000))
    total = 0.0
    for c in (0, 1):
        rts = float(theta[4]) + dts
        x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        lp = jax.jit(est.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 9)))
        total += jnp.trapezoid(jnp.exp(lp), rts)
    logits = est._net.choice_logits(
        est.params,
        est._net.make_context(
            est.params, (cond - est.cond_mean) / est.cond_std, cond
        ),
    )
    p_cens = float(jnp.exp(logits[2]))
    assert abs(float(total) + p_cens - 1.0) < 0.02, (
        f"sum over non-censored = {float(total)}, P(cens) = {p_cens}"
    )


def test_shifted_log_zero_below_onset():
    """Density for rt <= t_nd is numerically zero (clamped log -> flow
    Gaussian tail, ~-70 log-units per violating trial, plus a gentle
    linear barrier), and the gradient w.r.t. the condition points back
    into the support (restoring force for NUTS)."""
    est, cfg = _shifted_small_est()
    theta = jnp.array([0.5, 0.4, 1.2, 8.0, 0.4], jnp.float32)
    cond = jnp.concatenate([theta, jnp.ones((4,), jnp.float32)])
    x = jnp.array([[0.35, 0.0]])  # rt < t_nd = 0.4
    lp = est.log_prob(x, cond[None])
    assert float(lp[0]) < -50.0
    # gradient w.r.t. t_nd: decreasing t_nd (toward support) must raise logp
    g = jax.grad(
        lambda c: est.log_prob_fn(est.params, x, c[None])[0]
    )(cond)
    assert float(g[4]) < 0.0
    assert np.isfinite(np.asarray(g)).all()


def test_shifted_log_samples_respect_onset():
    est, cfg = _shifted_small_est()
    theta = jnp.array([0.5, 0.4, 1.2, 8.0, 0.47], jnp.float32)
    cond = jnp.broadcast_to(
        jnp.concatenate([theta, jnp.ones((4,), jnp.float32)]), (256, 9)
    )
    s = est.sample(jax.random.key(33), cond)
    rt, choice = np.asarray(s[..., 0]), np.asarray(s[..., 1])
    assert (rt[choice != 2] > 0.47).all()


# ---------------------------------------------------------------------------
# Left-tail sharpening (MNLEConfig.tail_sharp_k: doubly-exponential
# near-onset decay — the round-4 tau-bias fix)
# ---------------------------------------------------------------------------
def _sharp_est(key=41, **kw):
    cfg = MNLEConfig(
        condition_dim=9, num_categories=3, rt_rep="shifted_log",
        censor_rt=True, tail_sharp_k=1.5, tail_sharp_c=-3.5, **SMALL, **kw,
    )
    return build_mnle(jax.random.key(key), cfg), cfg


def test_tail_sharp_normalizes():
    """The sharpening pre-transform is a diffeomorphism with an exact
    log-det, so the density must still integrate to 1 - P(censored)."""
    est, cfg = _sharp_est()
    theta = jnp.array([0.5, 0.4, 1.2, 8.0, 0.31], jnp.float32)
    pulses = jnp.where(
        jax.random.uniform(jax.random.key(42), (4,)) < 0.5, 1.0, -1.0
    )
    cond = jnp.concatenate([theta, pulses])
    dts = jnp.exp(jnp.linspace(jnp.log(1e-5), jnp.log(200.0), 8000))
    total = 0.0
    for c in (0, 1):
        rts = float(theta[4]) + dts
        x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        lp = jax.jit(est.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 9)))
        total += jnp.trapezoid(jnp.exp(lp), rts)
    logits = est._net.choice_logits(
        est.params,
        est._net.make_context(
            est.params, (cond - est.cond_mean) / est.cond_std, cond
        ),
    )
    p_cens = float(jnp.exp(logits[2]))
    assert abs(float(total) + p_cens - 1.0) < 0.02, (
        f"sum over non-censored = {float(total)}, P(cens) = {p_cens}"
    )


def test_tail_sharp_inverse_roundtrip():
    from sbi_for_diffusion_models_tpu.nets.mnle_net import (
        tail_sharp_inverse,
        tail_sharp_transform,
    )

    _, cfg = _sharp_est()
    t = jnp.linspace(-8.0, 5.0, 301)
    y, ld = tail_sharp_transform(cfg, t)
    assert np.all(np.diff(np.asarray(y)) > 0)  # strictly increasing
    assert np.isfinite(np.asarray(ld)).all()
    t_back = tail_sharp_inverse(cfg, y)
    np.testing.assert_allclose(np.asarray(t_back), np.asarray(t),
                               rtol=1e-5, atol=1e-5)


def test_tail_sharp_suppresses_near_onset_density():
    """Same network weights with/without sharpening: the density just above
    onset (tiny decision time, below the c threshold in standardized units)
    must drop by orders of magnitude, while the data bulk is barely
    affected — the structural left-tail prior the spline cannot undo."""
    est_s, cfg_s = _sharp_est()
    cfg0 = MNLEConfig(
        condition_dim=9, num_categories=3, rt_rep="shifted_log",
        censor_rt=True, **SMALL,
    )
    est0 = est_s.__class__(
        cfg=cfg0, params=est_s.params, cond_mean=est_s.cond_mean,
        cond_std=est_s.cond_std, x_mean=est_s.x_mean, x_std=est_s.x_std,
        train_meta=None,
    )
    theta = jnp.array([0.5, 0.4, 1.2, 8.0, 0.3], jnp.float32)
    cond = jnp.concatenate([theta, jnp.ones((4,), jnp.float32)])[None]
    # standardized t = log(dt) (x_mean=0, x_std=1 defaults): dt = e^-6 puts
    # t = -6 well below c = -3.5; dt = 1 puts t = 0 in the bulk.
    near = jnp.array([[0.3 + float(np.exp(-6.0)), 0.0]])
    bulk = jnp.array([[1.3, 0.0]])
    drop = float(est0.log_prob(near, cond)[0] - est_s.log_prob(near, cond)[0])
    bulk_shift = abs(
        float(est0.log_prob(bulk, cond)[0] - est_s.log_prob(bulk, cond)[0])
    )
    assert drop > 5.0, f"near-onset suppression only {drop} log-units"
    assert bulk_shift < 0.5, f"bulk density moved by {bulk_shift} log-units"


def test_shifted_log_requires_censoring():
    cfg = MNLEConfig(
        condition_dim=9, rt_rep="shifted_log", censor_rt=False, **SMALL
    )
    with pytest.raises(ValueError, match="censor_rt"):
        build_mnle(jax.random.key(0), cfg)


def test_shifted_log_train_recovers_onset():
    """Train on synthetic data rt = t_nd + LogNormal decision time: the
    learned likelihood must place the onset at t_nd — evaluating a dataset
    against a shifted t_nd condition must score far lower than the truth.
    This is the representation's raison d'etre (the 'log' rep's smoothed
    onset produced the measured tau bias, artifacts/calibration_censor10m_
    pt6_96)."""
    key = jax.random.key(34)
    N = 4000
    tnd = jax.random.uniform(jax.random.fold_in(key, 0), (N,), minval=0.1,
                             maxval=0.9)
    dt = jnp.exp(-1.5 + 0.4 * jax.random.normal(jax.random.fold_in(key, 1), (N,)))
    rt = tnd + dt
    choice = (jax.random.uniform(jax.random.fold_in(key, 2), (N,)) < 0.5
              ).astype(jnp.float32)
    z = jnp.stack([
        jnp.ones((N,)), jnp.ones((N,)), jnp.ones((N,)), jnp.ones((N,)), tnd
    ], -1)
    x = jnp.stack([rt, choice], -1)
    cfg = RUN_CONFIG_PARAMS.replace(
        TRAIN_BATCH_SIZE=500, TRAIN_MAX_EPOCHS=60, TRAIN_STOP_AFTER_EPOCHS=60,
        MNLE_HIDDEN_FEATURES=32, MNLE_NUM_TRANSFORMS=3, MNLE_NUM_BINS=8,
        MNLE_RT_REP="shifted_log", MNLE_CENSOR_RT=True,
    )
    est = train_mnle(cfg, None, z, x, seed=0, verbose=False)
    # score a held-out mini-dataset under true vs shifted t_nd
    m = 64
    cond_true = jnp.stack([jnp.ones((m,))] * 4 + [jnp.full((m,), 0.5)], -1)
    dt_o = jnp.exp(-1.5 + 0.4 * jax.random.normal(jax.random.fold_in(key, 3), (m,)))
    x_o = jnp.stack([0.5 + dt_o, jnp.zeros((m,))], -1)
    lp_true = float(est.log_prob(x_o, cond_true).sum())
    cond_hi = cond_true.at[:, 4].set(0.5 + 0.15)  # onset above some rts
    lp_hi = float(est.log_prob(x_o, cond_hi).sum())
    assert lp_true > lp_hi + 100.0, (lp_true, lp_hi)


# ---------------------------------------------------------------------------
# Conditional location-scale layer (MNLEConfig.cond_affine: the round-4 fix
# for over-smoothed near-deterministic conditional decision-time densities)
# ---------------------------------------------------------------------------
def _affine_est(key=47, **kw):
    cfg = MNLEConfig(
        condition_dim=9, num_categories=3, rt_rep="shifted_log",
        censor_rt=True, cond_affine=True, **SMALL, **kw,
    )
    return build_mnle(jax.random.key(key), cfg), cfg


def _with_random_affine(est, key=52, scale=0.05):
    """Copy of ``est`` with a nontrivial condition-dependent affine head
    (build_mnle now zero-inits the head to the identity, so fresh params
    would leave the affine path untested)."""
    k1, k2 = jax.random.split(jax.random.key(key))
    kern = jnp.asarray(est.params["affine_head"]["kernel"])
    p = dict(est.params)
    p["affine_head"] = {
        "kernel": scale * jax.random.normal(k1, kern.shape, kern.dtype),
        "bias": 0.3 * jax.random.normal(k2, (2,), jnp.float32),
    }
    return est.__class__(
        cfg=est.cfg, params=p, cond_mean=est.cond_mean, cond_std=est.cond_std,
        x_mean=est.x_mean, x_std=est.x_std, train_meta=None,
    )


def _with_fixed_affine(est, mu=0.7, ls=0.4):
    """Copy of ``est`` whose affine head outputs exactly (mu, ls)."""
    p = dict(est.params)
    p["affine_head"] = {
        "kernel": jnp.zeros_like(jnp.asarray(est.params["affine_head"]["kernel"])),
        "bias": jnp.array([mu, ls], jnp.float32),
    }
    return est.__class__(
        cfg=est.cfg, params=p, cond_mean=est.cond_mean, cond_std=est.cond_std,
        x_mean=est.x_mean, x_std=est.x_std, train_meta=None,
    )


def test_cond_affine_exact_identity():
    """With the affine head pinned to constants (mu, ls), the flow density
    must equal the affine-free flow (same spline weights) evaluated at the
    affinely pulled-back coordinate, minus ls — the exact change of
    variables. Sampling must be the inverse map on the same base draw."""
    from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLENet

    mu, ls = 0.7, 0.4
    est_a, cfg_a = _affine_est()
    est_a = _with_fixed_affine(est_a, mu, ls)
    cfg0 = MNLEConfig(
        condition_dim=9, num_categories=3, rt_rep="shifted_log",
        censor_rt=True, **SMALL,
    )
    net_a, net_0 = MNLENet(cfg_a), MNLENet(cfg0)

    B = 33
    u = jnp.linspace(-3.0, 3.0, B)
    c = jnp.abs(jax.random.normal(jax.random.key(48), (B, 9))) + 0.1
    oh = jax.nn.one_hot(jnp.zeros((B,), jnp.int32), 3)
    lp_a = net_a.flow_log_prob(est_a.params, u, c, oh)
    lp_0 = net_0.flow_log_prob(est_a.params, (u - mu) * jnp.exp(-ls), c, oh)
    np.testing.assert_allclose(
        np.asarray(lp_a), np.asarray(lp_0) - ls, rtol=1e-5, atol=1e-5
    )
    key = jax.random.key(49)
    s_a = net_a.flow_sample(est_a.params, key, c, oh)
    s_0 = net_0.flow_sample(est_a.params, key, c, oh)
    np.testing.assert_allclose(
        np.asarray(s_a), np.asarray(s_0) * np.exp(ls) + mu,
        rtol=1e-5, atol=1e-5,
    )


def test_cond_affine_identity_at_init():
    """Zero-init of the affine head's kernel AND bias (advisor round-4
    finding): a freshly built cond-affine estimator is exactly the plain
    spline-chain density at init — (mu, log_sigma) = (0, 0) for every
    condition."""
    from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLENet

    est_a, cfg_a = _affine_est()
    assert not np.any(np.asarray(est_a.params["affine_head"]["kernel"]))
    assert not np.any(np.asarray(est_a.params["affine_head"]["bias"]))
    cfg0 = MNLEConfig(
        condition_dim=9, num_categories=3, rt_rep="shifted_log",
        censor_rt=True, **SMALL,
    )
    net_a, net_0 = MNLENet(cfg_a), MNLENet(cfg0)
    B = 17
    u = jnp.linspace(-2.5, 2.5, B)
    c = jnp.abs(jax.random.normal(jax.random.key(51), (B, 9))) + 0.1
    oh = jax.nn.one_hot(jnp.ones((B,), jnp.int32), 3)
    lp_a = net_a.flow_log_prob(est_a.params, u, c, oh)
    lp_0 = net_0.flow_log_prob(est_a.params, u, c, oh)
    np.testing.assert_allclose(
        np.asarray(lp_a), np.asarray(lp_0), rtol=1e-6, atol=1e-6
    )


def test_cond_affine_normalizes():
    """Exact -ls log-det: the full density must still integrate to
    1 - P(censored)."""
    est, cfg = _affine_est()
    est = _with_random_affine(est)  # nontrivial affine (init is identity)
    theta = jnp.array([0.5, 0.4, 1.2, 8.0, 0.31], jnp.float32)
    pulses = jnp.where(
        jax.random.uniform(jax.random.key(50), (4,)) < 0.5, 1.0, -1.0
    )
    cond = jnp.concatenate([theta, pulses])
    dts = jnp.exp(jnp.linspace(jnp.log(1e-5), jnp.log(200.0), 8000))
    total = 0.0
    for c in (0, 1):
        rts = float(theta[4]) + dts
        x = jnp.stack([rts, jnp.full_like(rts, c)], -1)
        lp = jax.jit(est.log_prob)(x, jnp.broadcast_to(cond, (rts.shape[0], 9)))
        total += jnp.trapezoid(jnp.exp(lp), rts)
    logits = est._net.choice_logits(
        est.params,
        est._net.make_context(
            est.params, (cond - est.cond_mean) / est.cond_std, cond
        ),
    )
    p_cens = float(jnp.exp(logits[2]))
    assert abs(float(total) + p_cens - 1.0) < 0.02, (
        f"sum over non-censored = {float(total)}, P(cens) = {p_cens}"
    )


def test_cond_affine_save_load_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    est, cfg = _affine_est()
    est = _with_random_affine(est)  # nontrivial affine (init is identity)
    save_model(est, RUN_CONFIG_PARAMS, filename="affine.npz")
    est2 = load_model("affine.npz")
    assert est2.cfg.cond_affine is True
    x = jnp.array([[0.9, 1.0], [2.0, 0.0], [8.0, 2.0]])
    c = jnp.abs(jax.random.normal(jax.random.key(52), (3, 9))) + 0.1
    c = c.at[:, 4].set(0.3)
    np.testing.assert_allclose(
        np.asarray(est.log_prob(x, c)), np.asarray(est2.log_prob(x, c)),
        rtol=1e-6,
    )
