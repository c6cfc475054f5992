"""Statistical validation of the hierarchical tier: hyperparameter
credible-interval coverage (round-2 VERDICT item 6).

The hierarchical model (models/hierarchical.py) extends the reference —
which fits each rat independently (reference
src/notebooks/pulse_ddm_model.ipynb cells 7-9) — with a joint population
posterior. "Runs" was shown in round 2 (artifacts/hierarchical_demo.json);
this benchmark shows "works": over R repetitions, draw (mu, log_tau) from
the EXACT hyperprior the inference uses, simulate S subjects x T trials,
run joint NUTS, and record whether the central credible interval covers
the generating hyperparameter. If the joint model + sampler are calibrated,
coverage matches the nominal level (this is interval-level SBC).

Coverage is assessed in the unconstrained sampling space, where mu and
log_tau are defined; every repetition reuses one compiled NUTS program
(identical shapes), so repetitions cost sampling time only.

Also reports the posterior-mean population error per repetition, to put the
round-2 demo's mean_abs_rel_error = 0.489 (6 subjects x 30 trials, narrowed
hyperprior) in context: with few subjects the population-location posterior
is dominated by between-subject spread, so a large point-estimate error is
expected and says nothing about calibration — coverage is the right metric.

Writes artifacts/hierarchical_coverage.json.

Usage: python benchmarks/hierarchical_coverage.py [--reps 20] [--subjects 4]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import jax
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--subjects", type=int, default=4)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=250)
    p.add_argument("--samples", type=int, default=300)
    p.add_argument("--level", type=float, default=0.9)
    p.add_argument("--max-depth", type=int, default=10,
                   help="NUTS max tree depth; 8 roughly halves rep cost "
                        "(verify worst R-hat stays ~1) ")
    p.add_argument("--model", type=str, default="mnle_1m_censor.npz",
                   help="saved model filename; a comma-separated list loads "
                        "a deep ensemble (mnle.MNLEEnsemble mixture "
                        "likelihood), which duck-types log_prob_fn "
                        "through the hierarchical potential")
    p.add_argument("--pt-replicas", type=int, default=1,
                   help="parallel-tempering replicas per chain; >1 fixes the "
                        "worst-rep R-hat~2 multimodal stalls plain NUTS shows "
                        "(BENCH_NOTES round-3 hierarchical section)")
    p.add_argument("--pt-beta-min", type=float, default=0.04)
    p.add_argument("--batch-reps", action="store_true",
                   help="fold all repetitions into ONE vmapped NUTS launch "
                        "(rows = reps x chains x replicas) — the one-launch "
                        "mode; sequential reps only pay off when partial "
                        "results matter more than wall-clock")
    p.add_argument("--segment-length", type=int, default=None,
                   help="NUTS transitions per device launch (default: 50 "
                        "sequential, 8 with --batch-reps — a cap set on "
                        "earlier hardware for many-row launches, not "
                        "measured on the GPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str,
                   default="artifacts/hierarchical_coverage.json")
    args = p.parse_args()

    from sbi_for_diffusion_models_tpu.inference.diagnostics import (
        split_r_hat,
    )
    from sbi_for_diffusion_models_tpu.mnle import load_model
    from sbi_for_diffusion_models_tpu.models.hierarchical import (
        HierarchicalModel,
        run_hierarchical_inference,
        simulate_hierarchical_sessions,
    )
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta

    prior = build_prior_theta()
    model = HierarchicalModel.from_prior(prior)
    if "," in args.model:
        from sbi_for_diffusion_models_tpu.mnle import load_ensemble

        est = load_ensemble(args.model)
        print(f"[hier_cov] {len(est.members)}-member ensemble: {args.model}")
    else:
        est = load_model(args.model)
    D = model.theta_dim
    S = args.subjects
    lo_q = (1.0 - args.level) / 2.0
    hi_q = 1.0 - lo_q

    cover_mu = np.zeros((args.reps, D), bool)
    cover_lt = np.zeros((args.reps, D), bool)
    rhat_worst = np.zeros(args.reps)
    mean_err = np.zeros(args.reps)
    t_start = time.time()

    sims = [
        simulate_hierarchical_sessions(
            prior, S, args.trials, model=model, seed=args.seed + 1000 + r,
            return_hyperparams=True, hyper_shrink=1.0,
        )
        for r in range(args.reps)
    ]

    seg = args.segment_length or (8 if args.batch_reps else 50)

    batched_raw = None
    if args.batch_reps:
        xs = np.stack([s[1] for s in sims])  # (B, S, T, 2)
        pss = np.stack([s[2] for s in sims])  # (B, S, T, P)
        res_all = run_hierarchical_inference(
            est, prior, xs, pss, model=model,
            num_chains=args.chains, num_warmup=args.warmup,
            num_samples=args.samples, seed=args.seed + 2000,
            max_tree_depth=args.max_depth, verbose=True,
            segment_length=seg,
            pt_replicas=args.pt_replicas, pt_beta_min=args.pt_beta_min,
        )
        batched_raw = res_all["raw"]  # (B, C, N, dim)

    for r in range(args.reps):
        theta_true, x, pulses, (mu_t, lt_t) = sims[r]
        if batched_raw is not None:
            raw = batched_raw[r]
        else:
            res = run_hierarchical_inference(
                est, prior, x, pulses, model=model,
                num_chains=args.chains, num_warmup=args.warmup,
                num_samples=args.samples, seed=args.seed + 2000 + r,
                max_tree_depth=args.max_depth, verbose=False,
                segment_length=seg,
                pt_replicas=args.pt_replicas, pt_beta_min=args.pt_beta_min,
            )
            raw = res["raw"]  # (C, N, dim)
        flat = raw.reshape(-1, raw.shape[-1])
        mu_s = flat[:, :D]
        lt_s = flat[:, D : 2 * D]
        mu_lo, mu_hi = np.quantile(mu_s, [lo_q, hi_q], axis=0)
        lt_lo, lt_hi = np.quantile(lt_s, [lo_q, hi_q], axis=0)
        mu_t = np.asarray(mu_t)
        lt_t = np.asarray(lt_t)
        cover_mu[r] = (mu_t >= mu_lo) & (mu_t <= mu_hi)
        cover_lt[r] = (lt_t >= lt_lo) & (lt_t <= lt_hi)
        rhat_worst[r] = float(np.max(split_r_hat(raw[:, :, : 2 * D])))
        mean_err[r] = float(
            np.mean(np.abs(mu_s.mean(0) - mu_t) / np.maximum(np.abs(mu_t), 0.1))
        )
        print(
            f"[hier_cov] rep {r + 1}/{args.reps}: "
            f"mu covered {int(cover_mu[r].sum())}/{D}, "
            f"log_tau covered {int(cover_lt[r].sum())}/{D}, "
            f"worst R-hat {rhat_worst[r]:.3f} "
            f"({time.time() - t_start:.0f}s)",
            flush=True,
        )
        # Partial results after every rep: a timeout/crash must not lose the
        # completed repetitions (reps are ~5 min each on CPU).
        partial = Path(args.out).with_suffix(".partial.json")
        partial.parent.mkdir(parents=True, exist_ok=True)
        partial.write_text(json.dumps({
            "reps_done": r + 1,
            "coverage_mu": float(cover_mu[: r + 1].mean()),
            "coverage_log_tau": float(cover_lt[: r + 1].mean()),
            "worst_rhat_per_rep": rhat_worst[: r + 1].tolist(),
        }))

    n = args.reps * D
    cov_mu = float(cover_mu.mean())
    cov_lt = float(cover_lt.mean())
    # Binomial SE at the nominal level for n intervals per block.
    se = float(np.sqrt(args.level * (1 - args.level) / n))
    report = {
        "reps": args.reps,
        "subjects": S,
        "trials": args.trials,
        "chains": args.chains,
        "warmup": args.warmup,
        "max_tree_depth": args.max_depth,
        "pt_replicas": args.pt_replicas,
        "pt_beta_min": args.pt_beta_min,
        "batch_reps": bool(args.batch_reps),
        "seed": args.seed,
        "samples_per_chain": args.samples,
        "nominal_level": args.level,
        "coverage_mu": cov_mu,
        "coverage_log_tau": cov_lt,
        # Per-dimension coverage (theta dims: a0, lam, v, B, tau): if the mu
        # deficit concentrates on one dim (e.g. tau, the known estimator-level
        # rank bias from single-subject SBC), the cause is surrogate bias
        # folding S-fold into the population location — not the hierarchy.
        "coverage_mu_per_dim": cover_mu.mean(0).tolist(),
        "coverage_log_tau_per_dim": cover_lt.mean(0).tolist(),
        "binomial_se": se,
        "n_intervals_per_block": n,
        "worst_rhat_per_rep": rhat_worst.tolist(),
        "mean_abs_rel_error_mu_per_rep": mean_err.tolist(),
        "model_file": args.model,
        "wall_s": time.time() - t_start,
        # Within 3 binomial SEs of nominal for both hyperparameter blocks.
        "pass": bool(
            abs(cov_mu - args.level) < 3 * se
            and abs(cov_lt - args.level) < 3 * se
        ),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(
        f"[hier_cov] coverage: mu={cov_mu:.3f} log_tau={cov_lt:.3f} "
        f"(nominal {args.level}, SE {se:.3f}) -> "
        f"{'PASS' if report['pass'] else 'FAIL'} -> {out}"
    )


if __name__ == "__main__":
    main()
