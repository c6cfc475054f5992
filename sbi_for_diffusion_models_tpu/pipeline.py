"""End-to-end pipeline: simulate -> train MNLE -> MCMC -> SBC.

API parity with the reference driver (reference:
rt_choice_model_pipeline.py:34-153): ``build_prior_theta`` and ``main`` with
the same prior family, stage order, output filenames, and ``$OUTDIR``
convention — but every compute stage runs on device (see the per-module docs
for the designs).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import jax
import numpy as np

from .analysis import can_plot, pairplot
from .data_simulator import (
    simulate_observed_session,
    simulate_training_set_with_conditions,
    summarize_trials,
)
from .distributions import Beta, LogNormal, MultipleIndependent
from .mnle import run_inference_mcmc, run_sbc, save_model, train_mnle
from .models.rt_choice_model import n_pulses_max_from_schedule, pulse_schedule
from .proposals import ExtendedProposal, PulseSequenceProposal
from .run_config import RUN_CONFIG_PARAMS, RunConfig
from .utils.rng import as_key

__all__ = ["build_prior_theta", "main"]

THETA_LABELS = ["a0", "lam", "v", "B", "tau"]


def build_prior_theta() -> MultipleIndependent:
    """Prior over theta = [a0, lam, v, B, tau]
    (reference rt_choice_model_pipeline.py:34-46):
    Beta(2,2) a0; LogNormal(-1,1) lam; LogNormal(0,1) v; LogNormal(2.75,0.5) B;
    Beta(2,2) tau (placeholder, as in the reference :44)."""
    return MultipleIndependent(
        [
            Beta(2.0, 2.0),  # a0_frac in (0,1)
            LogNormal(-1.0, 1.0),  # lam > 0
            LogNormal(0.0, 1.0),  # v > 0
            LogNormal(2.75, 0.5),  # B > 0
            Beta(2.0, 2.0),  # tau placeholder
        ]
    )


def main(cfg: RunConfig = RUN_CONFIG_PARAMS, *, seed: int = 0) -> dict:
    """Run the full pipeline (reference rt_choice_model_pipeline.py:48-150)."""
    from .utils.metrics import MetricsLogger

    t_start = time.time()
    key = as_key(seed)
    outdir = Path(os.environ.get("OUTDIR", "mnle_outputs"))
    outdir.mkdir(parents=True, exist_ok=True)
    metrics = MetricsLogger(outdir / "metrics.jsonl")

    n_max, steps_per_pulse = pulse_schedule()
    n_pulses = n_pulses_max_from_schedule(n_max, steps_per_pulse)
    print(f"[pipeline] n_max={n_max} steps_per_pulse={steps_per_pulse} P={n_pulses}")

    prior_theta = build_prior_theta()
    pulse_proposal = PulseSequenceProposal(n_pulses, cfg.P_SUCCESS, seed=0)
    proposal_z = ExtendedProposal(prior_theta, pulse_proposal)

    # 1. Simulate the training set (reference :64-75).
    t0 = time.time()
    z_train, x_train = simulate_training_set_with_conditions(
        cfg, proposal_z, seed=jax.random.fold_in(key, 1)
    )
    summarize_trials("train", x_train)
    sim_wall = time.time() - t0
    metrics.log("simulate", "wall_s", sim_wall)
    metrics.log(
        "simulate", "nominal_trial_steps_per_s",
        cfg.NUM_SIMULATIONS * n_max / max(sim_wall, 1e-9),
    )

    # 2. Train the MNLE (reference :78-82).
    t0 = time.time()
    density_estimator = train_mnle(
        cfg, proposal_z, z_train, x_train, seed=jax.random.fold_in(key, 2)
    )
    metrics.log("train", "wall_s", time.time() - t0)
    save_model(density_estimator, cfg)

    # 3. Observed session from a prior draw (reference :85-99).
    theta_true = prior_theta.sample(jax.random.fold_in(key, 3), (1,))[0]
    print(f"[pipeline] theta_true = {np.asarray(theta_true).round(4).tolist()}")
    x_o, pulses_o = simulate_observed_session(
        theta_true,
        cfg.NUM_TRIALS_OBS,
        mu_sensory=cfg.MU_SENSORY,
        p_success=cfg.P_SUCCESS,
        log_rt=cfg.LOG_RT_MANUALLY,
        seed=123,
    )
    summarize_trials("observed", x_o)

    # 4. MCMC posterior (reference :102-113).
    t0 = time.time()
    samples = run_inference_mcmc(
        cfg,
        prior_theta,
        density_estimator,
        x_o,
        pulses_o,
        seed=jax.random.fold_in(key, 4),
    )
    mcmc_wall = time.time() - t0
    metrics.log("mcmc", "wall_s", mcmc_wall)
    metrics.log(
        "mcmc", "posterior_samples_per_s", cfg.POSTERIOR_SAMPLES / max(mcmc_wall, 1e-9)
    )

    # 5. Save artifacts with the reference's filenames (reference :116-131).
    np.save(outdir / "posterior_samples_theta.npy", np.asarray(samples))
    print(f"[pipeline] wrote {outdir / 'posterior_samples_theta.npy'}")
    if can_plot("the posterior pairplot"):
        pairplot(
            np.asarray(samples),
            points=np.asarray(theta_true),
            labels=THETA_LABELS,
            save_path=outdir / "pairplot_theta.png",
        )

    # 6. SBC (reference :134-150).
    t0 = time.time()
    sbc = run_sbc(
        cfg,
        prior_theta,
        density_estimator,
        outdir=outdir,
        seed=jax.random.fold_in(key, 5),
    )
    metrics.log("sbc", "wall_s", time.time() - t0)

    metrics.log("pipeline", "total_wall_s", time.time() - t_start)
    print(f"[pipeline] total wall-clock: {time.time() - t_start:.1f}s")
    return {
        "density_estimator": density_estimator,
        "theta_true": np.asarray(theta_true),
        "posterior_samples": np.asarray(samples),
        "sbc": sbc,
    }


SMOKE_CONFIG = RUN_CONFIG_PARAMS.replace(
    NUM_SIMULATIONS=2000,
    TRAIN_BATCH_SIZE=512,
    TRAIN_MAX_EPOCHS=30,
    TRAIN_STOP_AFTER_EPOCHS=8,
    MNLE_HIDDEN_FEATURES=64,
    MNLE_NUM_TRANSFORMS=4,
    NUM_TRIALS_OBS=20,
    NUM_CHAINS=4,
    WARMUP_STEPS=60,
    POSTERIOR_SAMPLES=200,
    SBC_NUM_DATASETS=2,
    SBC_POST_SAMPLES=100,
    # At 25 draws/chain the min-ESS gate flags every dataset, so the full
    # escalation ladder would triple the smoke SBC's sampling cost for no
    # signal; one remediation round keeps the gate exercised but cheap.
    SBC_REMEDIATE_ROUNDS=1,
)


def _cli(argv=None):
    import argparse

    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()

    p = argparse.ArgumentParser(description="Run the full SBI pipeline.")
    p.add_argument(
        "--smoke",
        action="store_true",
        help="small-scale config (~2-4 min): fewer sims/epochs/chains",
    )
    p.add_argument(
        "--preset",
        choices=("calibrated", "reference"),
        default="calibrated",
        help="'calibrated' (default): the stack the SBC oracle passes with "
        "(run_config.CALIBRATED_CONFIG — shifted-log censored MNLE at 10M "
        "sims, PT6 + tau-slice NUTS); 'reference': the reference's exact "
        "default field values (reference run_config.py:4-44), which the "
        "repo's own calibration index shows mis-calibrated at scale",
    )
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.smoke:
        cfg = SMOKE_CONFIG
    elif args.preset == "calibrated":
        from .run_config import CALIBRATED_CONFIG

        cfg = CALIBRATED_CONFIG
    else:
        cfg = RUN_CONFIG_PARAMS
    main(cfg, seed=args.seed)


if __name__ == "__main__":
    _cli()
