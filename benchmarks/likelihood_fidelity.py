"""Direct likelihood-fidelity check: MNLE samples vs simulator draws.

At matched (theta, stimulus) conditions, draws from the trained MNLE should be
distributed like fresh simulator runs: same choice frequencies, same RT
distribution per choice. This checks the learned likelihood itself, separate
from the SBC posterior check (miscalibration there could hide in the
sampler; this isolates the estimator).

Usage (GPU): MODEL_DIR=... python benchmarks/likelihood_fidelity.py
Writes artifacts/likelihood_fidelity.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()
import jax.numpy as jnp
import numpy as np


def main():
    from scipy import stats as sps

    from sbi_for_diffusion_models_tpu.mnle import load_model
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
        rt_choice_model_simulator_torch,
    )
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta

    est = load_model("mnle_large_budget.npz")
    prior = build_prior_theta()
    P = n_pulses_max_from_schedule(*pulse_schedule())
    key = jax.random.key(0)
    N = 30_000
    results = []
    for i in range(4):  # four random (theta, stimulus) conditions
        k = jax.random.fold_in(key, i)
        theta = prior.sample(jax.random.fold_in(k, 0), (1,))[0]
        s = generate_pulse_matrix(jax.random.fold_in(k, 1), 1, P)
        theta_rep = jnp.tile(theta, (N, 1))
        s_rep = jnp.broadcast_to(s, (N, P))

        sim = np.asarray(
            rt_choice_model_simulator_torch(
                theta_rep, rng=jax.random.fold_in(k, 2), pulse_sides=s_rep
            )
        )
        cond = jnp.concatenate([theta_rep, s_rep], axis=-1)
        mnle = np.asarray(
            jax.jit(est.sample)(jax.random.fold_in(k, 3), cond)
        )

        f_sim = np.bincount(sim[:, 1].astype(int), minlength=3) / N
        f_mnle = np.bincount(np.clip(mnle[:, 1].astype(int), 0, 2), minlength=3) / N
        # RT distribution comparison on the dominant choice.
        c = int(np.argmax(f_sim))
        rt_sim = sim[sim[:, 1] == c, 0]
        rt_mnle = mnle[mnle[:, 1] == c, 0]
        ks = sps.ks_2samp(rt_sim, rt_mnle)
        results.append(
            {
                "theta": np.asarray(theta).round(4).tolist(),
                "choice_freq_sim": f_sim.round(4).tolist(),
                "choice_freq_mnle": f_mnle.round(4).tolist(),
                "choice_freq_max_abs_diff": float(np.abs(f_sim - f_mnle).max()),
                "rt_ks_stat": float(ks.statistic),
                "rt_median_sim": float(np.median(rt_sim)),
                "rt_median_mnle": float(np.median(rt_mnle)),
            }
        )
        print(json.dumps(results[-1]), flush=True)

    out = {
        "n_per_condition": N,
        "max_choice_freq_diff": max(r["choice_freq_max_abs_diff"] for r in results),
        "max_rt_ks_stat": max(r["rt_ks_stat"] for r in results),
        "conditions": results,
    }
    Path("artifacts").mkdir(exist_ok=True)
    Path("artifacts/likelihood_fidelity.json").write_text(json.dumps(out, indent=2))
    print(
        f"[fidelity] max choice-freq diff {out['max_choice_freq_diff']:.4f}, "
        f"max RT KS stat {out['max_rt_ks_stat']:.4f}"
    )


if __name__ == "__main__":
    main()
