"""Full-scale calibration run: train MNLE at a real simulation budget, then
batched SBC with quantitative uniformity checks.

This is the framework's statistical correctness oracle (SURVEY.md section 4):
uniform SBC rank histograms <=> the learned likelihood + NUTS posterior are
jointly calibrated, matching the reference pipeline's only end-to-end
validation (reference README.md:93-117) but with chi-square/KS statistics
instead of eyeballing.

Usage: python benchmarks/calibration_run.py [--sims 200000] [--datasets 32]
Writes artifacts + a JSON summary under artifacts/calibration/.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sims", type=int, default=200_000)
    p.add_argument("--datasets", type=int, default=32)
    p.add_argument("--post-samples", type=int, default=1000)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--warmup", type=int, default=150)
    p.add_argument("--trials-obs", type=int, default=50)
    p.add_argument("--outdir", type=str, default="artifacts/calibration")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--group-size", type=int, default=4)
    p.add_argument("--method", type=str, default=None,
                   choices=("nuts", "slice"), help="MCMC transition kernel")
    p.add_argument("--target-accept", type=float, default=None)
    # Parallel tempering (inference/nuts.ReplicaExchange): replicas per
    # chain on a geometric beta ladder; the cure for the rugged multimodal
    # (a0, v, B, t_nd) landscape (BENCH_NOTES round-2 "real root cause").
    p.add_argument("--pt-replicas", type=int, default=None)
    p.add_argument("--pt-beta-min", type=float, default=None)
    p.add_argument("--pt-swap-every", type=int, default=None)
    # Within-basin t_nd slice mixer for hard-onset likelihoods
    # (inference/mcmc.make_dim_slice; see run_config.MCMC_TAU_SLICE).
    p.add_argument("--tau-slice", action="store_true")
    # Estimator capacity knobs (reference hard-codes 128/10/24, mnle.py:36-38).
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--transforms", type=int, default=None)
    p.add_argument("--bins", type=int, default=None)
    p.add_argument("--trunk-depth", type=int, default=None)
    p.add_argument("--embed-dim", type=int, default=None,
                   help="pulse summary-embedding width (0 disables)")
    p.add_argument("--embed-mode", type=str, default=None,
                   choices=("replace", "append"),
                   help="swap the raw pulse block for the embedding, or keep "
                        "it and append (append + --embed-dim 0 = physics "
                        "features alone)")
    p.add_argument("--grid-anchor", type=str, default=None,
                   choices=("absolute", "tnd"))
    p.add_argument("--rt-rep", type=str, default=None,
                   choices=("log", "shifted_log", "pulse"),
                   help="RT representation (pulse = slot/phase grid "
                        "factorization; implies --censor-rt)")
    p.add_argument("--censor-rt", action="store_true",
                   help="censored-RT likelihood (choice==2 -> categorical only)")
    p.add_argument("--log-theta", action="store_true",
                   help="log-reparameterize the LogNormal condition dims "
                        "(lam, v, B) before z-scoring (MNLE_LOG_THETA_DIMS="
                        "(1,2,3)); targets the shared v/B SBC shrinkage")
    p.add_argument("--tail-sharp-k", type=float, default=None,
                   help="left-tail sharpening strength k (MNLE_TAIL_SHARP_K;"
                        " doubly-exponential near-onset decay, the round-4 "
                        "tau-bias fix); 0/unset = off")
    p.add_argument("--tail-sharp-c", type=float, default=None,
                   help="sharpening onset c in standardized flow units "
                        "(MNLE_TAIL_SHARP_C, default -3.5)")
    p.add_argument("--cond-affine", action="store_true",
                   help="conditional location-scale layer before the spline "
                        "chain (MNLE_COND_AFFINE; the round-4 fix for "
                        "over-smoothed near-deterministic conditions)")
    p.add_argument(
        "--reuse-model",
        action="store_true",
        help="load a saved model from MODEL_DIR instead of retraining",
    )
    p.add_argument(
        "--train-only",
        action="store_true",
        help="simulate + train + save the model, then stop before SBC "
        "(writes <outdir>/train_summary.json); lets cheap estimator gates "
        "— e.g. benchmarks/likelihood_slope.py — run before committing a "
        "multi-hour SBC window to the model (round-4 VERDICT #2)",
    )
    p.add_argument(
        "--model",
        type=str,
        default="mnle_calibration.npz",
        help="model filename (with --reuse-model) / save name (without); "
        "a comma-separated list (with --reuse-model) loads a deep "
        "ensemble (mnle.MNLEEnsemble mixture likelihood)",
    )
    p.add_argument(
        "--ensemble",
        type=int,
        default=1,
        help="train K members on fresh simulation draws (seed offsets) and "
        "run SBC with the K-mixture likelihood; members saved as "
        "<model>.mK.npz",
    )
    args = p.parse_args()

    from sbi_for_diffusion_models_tpu.analysis import sbc_uniformity_stats
    from sbi_for_diffusion_models_tpu.data_simulator import (
        simulate_training_set_with_conditions,
        summarize_trials,
    )
    from sbi_for_diffusion_models_tpu.mnle import run_sbc, save_model, train_mnle
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import (
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu.proposals import (
        ExtendedProposal,
        PulseSequenceProposal,
    )
    from sbi_for_diffusion_models_tpu.run_config import RUN_CONFIG_PARAMS

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    cfg = RUN_CONFIG_PARAMS.replace(
        NUM_SIMULATIONS=args.sims,
        NUM_TRIALS_OBS=args.trials_obs,
        NUM_CHAINS=args.chains,
        WARMUP_STEPS=args.warmup,
        SBC_NUM_DATASETS=args.datasets,
        SBC_POST_SAMPLES=args.post_samples,
        TRAIN_BATCH_SIZE=4096,
        # Depth cap kept from earlier hardware, where deep many-chain
        # launches failed; not measured on the GPU.
        MCMC_MAX_TREE_DEPTH=8,
    )
    if args.method:
        cfg = cfg.replace(MCMC_METHOD=args.method)
    if args.target_accept is not None:
        cfg = cfg.replace(MCMC_TARGET_ACCEPT=args.target_accept)
    if args.pt_replicas is not None:
        cfg = cfg.replace(MCMC_PT_REPLICAS=args.pt_replicas)
    if args.tau_slice:
        cfg = cfg.replace(MCMC_TAU_SLICE=True)
    if args.pt_beta_min is not None:
        cfg = cfg.replace(MCMC_PT_BETA_MIN=args.pt_beta_min)
    if args.pt_swap_every is not None:
        cfg = cfg.replace(MCMC_PT_SWAP_EVERY=args.pt_swap_every)
    arch = {
        "MNLE_HIDDEN_FEATURES": args.hidden,
        "MNLE_NUM_TRANSFORMS": args.transforms,
        "MNLE_NUM_BINS": args.bins,
        "MNLE_TRUNK_DEPTH": args.trunk_depth,
        "MNLE_EMBED_DIM": args.embed_dim,
        "MNLE_EMBED_MODE": args.embed_mode,
    }
    cfg = cfg.replace(**{k: v for k, v in arch.items() if v is not None})
    if args.rt_rep:
        cfg = cfg.replace(MNLE_RT_REP=args.rt_rep)
    if args.grid_anchor:
        cfg = cfg.replace(MNLE_GRID_ANCHOR=args.grid_anchor)
    if args.censor_rt or args.rt_rep in ("pulse", "shifted_log"):
        cfg = cfg.replace(MNLE_CENSOR_RT=True)
    if args.log_theta:
        cfg = cfg.replace(MNLE_LOG_THETA_DIMS=(1, 2, 3))
    if args.tail_sharp_k is not None:
        cfg = cfg.replace(MNLE_TAIL_SHARP_K=args.tail_sharp_k)
    if args.tail_sharp_c is not None:
        cfg = cfg.replace(MNLE_TAIL_SHARP_C=args.tail_sharp_c)
    if args.cond_affine:
        cfg = cfg.replace(MNLE_COND_AFFINE=True)
    prior = build_prior_theta()
    P = n_pulses_max_from_schedule(*pulse_schedule())
    proposal = ExtendedProposal(prior, PulseSequenceProposal(P, cfg.P_SUCCESS))

    if args.reuse_model:
        from sbi_for_diffusion_models_tpu.mnle import load_ensemble, load_model

        if "," in args.model:
            est = load_ensemble(args.model)
            print(
                f"[calibration] reusing saved {len(est.members)}-member "
                f"ensemble: {args.model}"
            )
        else:
            est = load_model(args.model)
            print(f"[calibration] reusing saved {args.model}")
        sim_wall = train_wall = 0.0
    elif args.ensemble > 1:
        from sbi_for_diffusion_models_tpu.mnle import MNLEEnsemble

        members, sim_wall, train_wall = [], 0.0, 0.0
        stem = args.model[: -len(".npz")] if args.model.endswith(".npz") else args.model
        for k in range(args.ensemble):
            t0 = time.time()
            z, x = simulate_training_set_with_conditions(
                cfg, proposal, seed=args.seed + 1000 * k
            )
            sim_wall += time.time() - t0
            t0 = time.time()
            m = train_mnle(cfg, proposal, z, x, seed=args.seed + 1 + 1000 * k)
            train_wall += time.time() - t0
            save_model(m, cfg, filename=f"{stem}.m{k}.npz")
            print(
                f"[calibration] member {k + 1}/{args.ensemble} trained "
                f"(val {m.train_meta.get('best_val_loss'):.4f})"
            )
            members.append(m)
        est = MNLEEnsemble(members)
    else:
        t0 = time.time()
        z, x = simulate_training_set_with_conditions(cfg, proposal, seed=args.seed)
        sim_wall = time.time() - t0
        summarize_trials("calibration-train", x)
        print(f"[calibration] simulated {args.sims} trials in {sim_wall:.1f}s")

        t0 = time.time()
        est = train_mnle(cfg, proposal, z, x, seed=args.seed + 1)
        train_wall = time.time() - t0
        print(f"[calibration] trained in {train_wall:.1f}s")
        save_model(est, cfg, filename=args.model)

    if args.train_only:
        train_summary = {
            "model_file": args.model,
            "sims": args.sims,
            "sim_wall_s": sim_wall,
            "train_wall_s": train_wall,
            "train_meta": est.train_meta if hasattr(est, "train_meta") else None,
        }
        outdir.mkdir(parents=True, exist_ok=True)
        (outdir / "train_summary.json").write_text(
            json.dumps(train_summary, indent=2, default=float)
        )
        print(f"[calibration] --train-only: wrote {outdir}/train_summary.json")
        return

    t0 = time.time()
    sbc = run_sbc(
        cfg, prior, est, outdir=outdir, seed=args.seed + 2,
        group_size=args.group_size,
    )
    sbc_wall = time.time() - t0

    stats = sbc_uniformity_stats(sbc["ranks"], args.post_samples)
    # Mixed-only uniformity (round-3 VERDICT #2): the headline p-values must
    # be attributable to converged chains. The driver already remediated
    # flagged datasets (run_config.SBC_REMEDIATE); any still flagged after
    # remediation are excluded here and reported separately.
    flagged_final = np.asarray(sbc.get("flagged_final") or [], dtype=int)
    stats_mixed = None
    if flagged_final.size:
        good = np.setdiff1d(np.arange(args.datasets), flagged_final)
        if good.size >= 8:
            stats_mixed = sbc_uniformity_stats(
                np.asarray(sbc["ranks"])[good], args.post_samples
            )
    # True simulation budget comes from the model's own training metadata
    # when reusing a saved model — round 1 wrote the CLI default here, making
    # the summaries inconsistent with the runs that produced them.
    train_meta = est.train_meta or {}
    sims_actual = train_meta.get("num_train", args.sims if not args.reuse_model else None)
    summary = {
        "sims": sims_actual,
        "model_file": args.model,
        "train_meta": train_meta,
        "datasets": args.datasets,
        "post_samples": args.post_samples,
        "chains": args.chains,
        "sim_wall_s": sim_wall,
        "train_wall_s": train_wall,
        "sbc_wall_s": sbc_wall,
        "ks_pvalues": stats["ks_pvalues"],
        "chi2_pvalues": stats["chi2_pvalues"],
        "ks_pvalues_mixed_only": (
            stats_mixed["ks_pvalues"] if stats_mixed else None
        ),
        "chi2_pvalues_mixed_only": (
            stats_mixed["chi2_pvalues"] if stats_mixed else None
        ),
        "remediation": sbc.get("remediation"),
        "flagged_final": flagged_final.tolist(),
        "ranks_mean": np.asarray(sbc["ranks"]).mean(0).tolist(),
        "backend": jax.default_backend(),
        "warmup": args.warmup,
        "pt": {
            "replicas": cfg.MCMC_PT_REPLICAS,
            "beta_min": cfg.MCMC_PT_BETA_MIN,
            "swap_every": cfg.MCMC_PT_SWAP_EVERY,
            "swap_accept": sbc.get("swap_accept"),
        },
        # Per-dataset mixing health of the pooled ranks (VERDICT round-2
        # item 2): ranks pooled from unmixed chains silently bias the
        # uniformity numbers, so flag them here. Full per-dataset arrays:
        # sbc_mixing_diagnostics.npz in outdir.
        "mixing": {
            "rhat_max": float(np.nanmax(sbc["rhat_max"]))
            if np.asarray(sbc["rhat_max"]).size
            else None,
            "min_ess": float(np.nanmin(sbc["min_ess"]))
            if np.asarray(sbc["min_ess"]).size
            else None,
            "n_datasets_rhat_gt_1p05": int(
                np.sum(np.asarray(sbc["rhat_max"]) > 1.05)
            ),
            "n_datasets_rhat_gt_1p2": int(
                np.sum(np.asarray(sbc["rhat_max"]) > 1.2)
            ),
            "divergences_total": float(
                np.nansum(np.asarray(sbc.get("divergences_per_dataset", [])))
            )
            if np.asarray(sbc.get("divergences_per_dataset", [])).size
            else None,
            "n_datasets_divergent": int(
                np.nansum(
                    np.asarray(sbc.get("divergences_per_dataset", [])) > 0
                )
            )
            if np.asarray(sbc.get("divergences_per_dataset", [])).size
            else None,
        },
    }
    (outdir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    min_p = min(stats["ks_pvalues"])
    print(
        f"[calibration] min KS p-value across dims: {min_p:.4f} "
        f"({'PASS' if min_p > 0.01 else 'MISCALIBRATED'})"
    )


if __name__ == "__main__":
    main()
