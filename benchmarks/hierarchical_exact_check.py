"""Exact-likelihood control for the hierarchical coverage deficit.

Round-3 accelerator blocks measured mu coverage 0.750 vs nominal 0.9 (log_tau
0.875, calibrated) with the MNLE surrogate likelihood
(artifacts/hierarchical_coverage_pt_{a,b}.json). Two candidate causes were
left open: (a) something in the hierarchy/harness/sampler chain, (b) MNLE
surrogate bias folding S-fold into the population location.

This control settles the attribution: identical hierarchy (same
moment-matched ``HierarchicalModel``, same non-centered parameterisation,
same ``mcmc_transform`` bijection inside the potential, same ``run_nuts``
driver and interval logic as benchmarks/hierarchical_coverage.py), but the
subject data are Gaussian observations of the CONSTRAINED subject
parameters with a known exact likelihood:

    y_st ~ Normal(theta_s, sigma_d)      theta_s = bij.forward(u_s)

Generative and inference model now match EXACTLY, so interval-level SBC
guarantees nominal coverage for ANY number of subjects — "few-subject
hyperprior sensitivity" cannot depress coverage when the model matches; it
only widens intervals. Therefore:

  - nominal coverage here  -> harness + sampler exonerated; the real-run mu
    deficit is estimator-level (MNLE bias, the same family as the isolated
    single-subject tau bias), answer to BENCH_NOTES round-3 open question.
  - a deficit here         -> the hierarchy/sampler chain itself is broken
    and the round-4 S=8 power test would be confounded.

Reference parity anchor: the reference has no hierarchical tier at all
(it fits rats independently, src/notebooks/pulse_ddm_model.ipynb cells
7-9); this validates a capability extension (BASELINE.json config #5).

Usage (CPU, ~minutes): python benchmarks/hierarchical_exact_check.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Runs on CPU: this control is cheap, and the GPU stays free for one
# process. Force before any backend initialisation.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--subjects", type=int, default=4)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--samples", type=int, default=300)
    p.add_argument("--level", type=float, default=0.9)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--obs-noise-frac", type=float, default=1.0,
                   help="observation sd as a fraction of the constrained "
                        "prior sd per dim (1.0 ~ the information regime of "
                        "20 real trials)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str,
                   default="artifacts/hierarchical_exact_check.json")
    args = p.parse_args()

    from sbi_for_diffusion_models_tpu.distributions import mcmc_transform
    from sbi_for_diffusion_models_tpu.inference.diagnostics import split_r_hat
    from sbi_for_diffusion_models_tpu.inference.nuts import run_nuts
    from sbi_for_diffusion_models_tpu.models.hierarchical import (
        HierarchicalModel,
    )
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta

    prior = build_prior_theta()
    model = HierarchicalModel.from_prior(prior)
    bij = mcmc_transform(prior)
    D = model.theta_dim
    S, T, B, C = args.subjects, args.trials, args.reps, args.chains
    key = jax.random.key(args.seed)

    # Observation noise scaled to the constrained prior spread per dim.
    theta_draws = prior.sample(jax.random.key(123), (8192,))
    sigma_obs = (
        args.obs_noise_frac
        * jnp.std(jnp.asarray(theta_draws, jnp.float32), axis=0)
    )

    # ---- generative pass: EXACTLY the inference model's hyperprior --------
    k_mu, k_tau, k_eps, k_y = jax.random.split(key, 4)
    mu_t = model.mu_loc + model.mu_scale * jax.random.normal(k_mu, (B, D))
    lt_t = model.log_tau_loc + model.log_tau_scale * jax.random.normal(
        k_tau, (B, D)
    )
    eps_t = jax.random.normal(k_eps, (B, S, D))
    u_t = mu_t[:, None, :] + jnp.exp(lt_t)[:, None, :] * eps_t
    theta_t = bij.forward(u_t)  # (B, S, D) constrained
    y = theta_t[:, :, None, :] + sigma_obs * jax.random.normal(
        k_y, (B, S, T, D)
    )

    # ---- joint potential (rows = rep x chain, dataset via data) -----------
    log_sigma = jnp.log(sigma_obs)
    _half_log_2pi = 0.5 * float(np.log(2.0 * np.pi))

    def target(q, rep):
        u_s = model.subject_u(q, S)
        theta_s = bij.forward(u_s)  # (S, D)
        y_r = jnp.take(y, rep, axis=0)  # (S, T, D)
        resid = (y_r - theta_s[:, None, :]) / sigma_obs
        ll = jnp.sum(-log_sigma - _half_log_2pi - 0.5 * resid**2)
        return model.log_prior(q, S) + ll

    dim = model.dim(S)
    center = jnp.concatenate(
        [model.mu_loc, model.log_tau_loc, jnp.zeros(S * D, jnp.float32)]
    )
    scale = jnp.concatenate(
        [model.mu_scale, model.log_tau_scale, jnp.ones(S * D, jnp.float32)]
    )
    rows = B * C
    init_q = center[None, :] + 0.1 * scale[None, :] * jax.random.normal(
        jax.random.fold_in(key, 1), (rows, dim)
    )
    rep_ids = jnp.repeat(jnp.arange(B), C)

    t0 = time.time()
    samples, info = run_nuts(
        jax.random.fold_in(key, 2), target, init_q,
        num_warmup=args.warmup, num_samples=args.samples,
        max_depth=args.max_depth, data=rep_ids, segment_length=50,
    )
    wall = time.time() - t0

    raw = np.asarray(samples).reshape(B, C, args.samples, dim)
    lo_q, hi_q = (1 - args.level) / 2, 1 - (1 - args.level) / 2
    cover_mu = np.zeros((B, D), bool)
    cover_lt = np.zeros((B, D), bool)
    rhat_worst = np.zeros(B)
    for r in range(B):
        flat = raw[r].reshape(-1, dim)
        mu_lo, mu_hi = np.quantile(flat[:, :D], [lo_q, hi_q], axis=0)
        lt_lo, lt_hi = np.quantile(flat[:, D:2 * D], [lo_q, hi_q], axis=0)
        mt, lt = np.asarray(mu_t[r]), np.asarray(lt_t[r])
        cover_mu[r] = (mt >= mu_lo) & (mt <= mu_hi)
        cover_lt[r] = (lt >= lt_lo) & (lt <= lt_hi)
        rhat_worst[r] = float(np.max(split_r_hat(raw[r, :, :, : 2 * D])))

    n = B * D
    cov_mu, cov_lt = float(cover_mu.mean()), float(cover_lt.mean())
    se = float(np.sqrt(args.level * (1 - args.level) / n))
    # The D dims within a rep share the same data and chains, so treating
    # all B*D indicators as independent is anti-conservative (ADVICE round
    # 3). Cluster-robust SE from the B independent reps: SD of the per-rep
    # mean coverage / sqrt(B). The pass gate uses the larger of the two.
    se_mu = float(cover_mu.mean(1).std(ddof=1) / np.sqrt(B)) if B > 1 else se
    se_lt = float(cover_lt.mean(1).std(ddof=1) / np.sqrt(B)) if B > 1 else se
    gate_mu = max(se, se_mu)
    gate_lt = max(se, se_lt)
    report = {
        "reps": B, "subjects": S, "trials": T, "chains": C,
        "warmup": args.warmup, "samples_per_chain": args.samples,
        "max_tree_depth": args.max_depth,
        "obs_noise_frac": args.obs_noise_frac,
        "nominal_level": args.level,
        "coverage_mu": cov_mu,
        "coverage_log_tau": cov_lt,
        "coverage_mu_per_dim": cover_mu.mean(0).tolist(),
        "coverage_log_tau_per_dim": cover_lt.mean(0).tolist(),
        "binomial_se": se,
        "cluster_se_mu": se_mu,
        "cluster_se_log_tau": se_lt,
        "worst_rhat": float(rhat_worst.max()),
        "rhat_per_rep": rhat_worst.tolist(),
        "wall_s": wall,
        "backend": jax.default_backend(),
        "pass": bool(
            abs(cov_mu - args.level) < 3 * gate_mu
            and abs(cov_lt - args.level) < 3 * gate_lt
        ),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    print(
        f"[exact_check] mu={cov_mu:.3f} log_tau={cov_lt:.3f} "
        f"(nominal {args.level}, SE {se:.3f}, worst R-hat "
        f"{rhat_worst.max():.3f}) -> {'PASS' if report['pass'] else 'FAIL'}"
    )


if __name__ == "__main__":
    main()
