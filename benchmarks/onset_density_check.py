"""Near-onset decision-time density check: is the learned RT density too
heavy just above the non-decision-time onset?

Round-3 decomposition (BENCH_NOTES): the SBC tau rank bias is
estimator-level; the shifted-log rep fixed the below-onset leak by 9 orders
but tau still failed at 96-dataset power, with the residual hypothesised to
be a too-heavy learned decision-time density JUST ABOVE onset. The staged
round-4 [onset] control separates representation from wall-handling via a
full training run — this benchmark answers the same question directly in
sampling space on CPU, with no MCMC and no new training:

For matched (theta, stimulus) conditions, draw N simulator trials and N
MNLE samples per saved model, and compare the mass in decision-time bins
dt = rt - t_nd_true near zero. A model whose density is too heavy above
onset shows bin ratios > 1 in the first ~150 ms; mass BELOW onset
(dt < 0) is the leak the shifted-log rep eliminated by construction.

Reference anchor: the reference never checks its learned likelihood against
the simulator at all (training loss only,
src/sbi_for_diffusion_models/mnle.py:31-50); this is part of the framework's
estimator-validation tier alongside benchmarks/likelihood_fidelity.py.

Usage (CPU): python benchmarks/onset_density_check.py
Writes artifacts/onset_density_check.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# CPU on purpose: this check is sampling-only (flow sampling = small
# matmuls), and the GPU stays free for one process.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import jax.numpy as jnp
import numpy as np

# dt bin edges (seconds) relative to the TRUE t_nd; the first bins are the
# near-onset region the tau bias lives in (pulse interval is 0.25 s).
EDGES = np.array([0.0, 0.05, 0.10, 0.15, 0.25, 0.50, 1.00, 2.00])


LEFT_TAIL_PS = (0.001, 0.01, 0.05, 0.25)


def bin_mass(rt: np.ndarray, t_nd: float, t_max: float) -> dict:
    """Decision-time histogram masses (fractions of ALL draws)."""
    ok = rt < t_max - 1e-6  # non-censored
    dt = rt[ok] - t_nd
    below = float(np.mean(rt < t_nd - 1e-6))
    hist, _ = np.histogram(dt, bins=EDGES)
    return {
        "below_onset": below,
        "censored": float(np.mean(~ok)),
        "bins": (hist / max(len(rt), 1)).tolist(),
    }


def left_tail_excess(rt_sim, rt_est, t_nd, t_max):
    """Model decision-time CDF evaluated at the SIMULATOR's lower quantiles.

    The first-passage time has an effective floor well above zero, so fixed
    near-onset bins are empty for both; what the tau bias mechanism predicts
    is mass smeared into the early-dt gap — i.e. model_CDF(sim_q_p) > p.
    (A left-heavy learned dt density lets the sampler trade t_nd upward
    while still explaining the smallest RTs -> one-sided tau bias.)
    Returns {p: model_cdf_at_sim_quantile} over LEFT_TAIL_PS.
    """
    dt_sim = rt_sim[rt_sim < t_max - 1e-6] - t_nd
    dt_est = rt_est[rt_est < t_max - 1e-6] - t_nd
    # Both arrays are CONDITIONAL on non-censoring: a differing censored
    # fraction between simulator and model shifts the nominal-p anchor
    # slightly (the per-condition censor fraction is recorded in bin_mass).
    # An all-censored condition has no decision-time draws at all — record
    # null rather than NaN-poisoning the headline mean (ADVICE round 3).
    if dt_sim.size == 0 or dt_est.size == 0:
        return {str(p_): None for p_ in LEFT_TAIL_PS}
    out = {}
    for p_ in LEFT_TAIL_PS:
        q = float(np.quantile(dt_sim, p_))
        out[str(p_)] = float(np.mean(dt_est <= q))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=30_000)
    p.add_argument("--conditions", type=int, default=4)
    p.add_argument(
        "--models",
        type=str,
        default="mnle_10m_shifted_logt.npz,mnle_1m_censor.npz,mnle_10m.npz",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str,
                   default="artifacts/onset_density_check.json")
    args = p.parse_args()

    from sbi_for_diffusion_models_tpu.mnle import load_model
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
        rt_choice_model_simulator_torch,
    )
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu.constants import T_MAX

    t_max = float(T_MAX)
    prior = build_prior_theta()
    P = n_pulses_max_from_schedule(*pulse_schedule())
    key = jax.random.key(args.seed)
    N = args.n

    # Conditions: mid-range t_nd so the near-onset bins sit away from both
    # the RT floor and the censor boundary.
    conds = []
    i = 0
    while len(conds) < args.conditions:
        k = jax.random.fold_in(key, i)
        i += 1
        theta = prior.sample(jax.random.fold_in(k, 0), (1,))[0]
        if not (0.25 <= float(theta[4]) <= 0.75):
            continue
        s = generate_pulse_matrix(jax.random.fold_in(k, 1), 1, P)
        conds.append((k, theta, s))

    sims = []
    for k, theta, s in conds:
        t0 = time.time()
        theta_rep = jnp.tile(theta, (N, 1))
        s_rep = jnp.broadcast_to(s, (N, P))
        sim = np.asarray(
            rt_choice_model_simulator_torch(
                theta_rep, rng=jax.random.fold_in(k, 2), pulse_sides=s_rep
            )
        )
        sims.append(sim)
        print(
            f"[onset] simulated condition t_nd={float(theta[4]):.3f} "
            f"({time.time() - t0:.0f}s)",
            flush=True,
        )

    report = {"n": N, "bin_edges": EDGES.tolist(), "models": {}}
    for name in args.models.split(","):
        name = name.strip()
        try:
            est = load_model(name)
        except Exception as e:  # a missing saved model shouldn't kill the run
            report["models"][name] = {"error": str(e)}
            continue
        rows = []
        sample_fn = jax.jit(est.sample)
        for (k, theta, s), sim in zip(conds, sims):
            theta_rep = jnp.tile(theta, (N, 1))
            s_rep = jnp.broadcast_to(s, (N, P))
            cond = jnp.concatenate([theta_rep, s_rep], axis=-1)
            mnle = np.asarray(sample_fn(jax.random.fold_in(k, 3), cond))
            t_nd = float(theta[4])
            m_sim = bin_mass(sim[:, 0], t_nd, t_max)
            m_est = bin_mass(mnle[:, 0], t_nd, t_max)
            tail = left_tail_excess(sim[:, 0], mnle[:, 0], t_nd, t_max)
            rows.append({
                "t_nd": t_nd,
                "sim": m_sim,
                "mnle": m_est,
                "left_tail_cdf_at_sim_q": tail,
            })
            t1 = tail["0.01"]
            print(
                f"[onset] {name} t_nd={t_nd:.3f}: model CDF at sim q1% = "
                f"{'n/a (all censored)' if t1 is None else format(t1, '.4f')} "
                f"(nominal 0.01), below-onset "
                f"sim={m_sim['below_onset']:.2e} mnle={m_est['below_onset']:.2e}",
                flush=True,
            )
        excess_1pct = [
            r["left_tail_cdf_at_sim_q"]["0.01"]
            for r in rows
            if r["left_tail_cdf_at_sim_q"]["0.01"] is not None
        ]
        report["models"][name] = {
            # train_meta only records num_train/epochs/val-loss; the RT
            # representation lives on the model config (ADVICE round 3).
            "rep": est.cfg.rt_rep,
            "conditions": rows,
            # Headline: mean model mass below the simulator's 1% decision-
            # time quantile (nominal 0.01); >> 0.01 = left-heavy dt density,
            # the tau-bias mechanism.
            "mean_left_tail_mass_at_sim_q1pct": (
                float(np.mean(excess_1pct)) if excess_1pct else None
            ),
            "max_below_onset_mass": max(
                r["mnle"]["below_onset"] for r in rows
            ),
        }

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    for name, m in report["models"].items():
        if "error" in m:
            print(f"[onset] {name}: {m['error']}")
        else:
            mlt = m["mean_left_tail_mass_at_sim_q1pct"]
            print(
                f"[onset] {name}: mean left-tail mass at sim q1% = "
                f"{'n/a' if mlt is None else format(mlt, '.4f')} "
                f"(nominal 0.0100), max below-onset mass "
                f"{m['max_below_onset_mass']:.2e}"
            )
    print(f"[onset] wrote {out}")


if __name__ == "__main__":
    main()
