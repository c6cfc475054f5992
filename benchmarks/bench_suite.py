"""Extended benchmark suite: every hot path, one JSON line per metric.

Complements `bench.py` (single headline line). Run on the GPU:
`python benchmarks/bench_suite.py`. Timings wait with `jax.block_until_ready`.

Metrics:
  sim_<kernel>            — nominal DDM trial-steps/s at several batch sizes
                            (the kernel ``dispatch_sim_kernel`` picks)
  train_step              — MNLE optimizer steps/s at the default batch (4096)
  mnle_logprob            — estimator log_prob rows/s (the MCMC inner op)
  nuts                    — posterior samples/s on a 50-trial MNLE potential
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, reps=3, **kw):
    jax.block_until_ready(fn(*args, **kw))  # warm / compile
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return best


def emit(metric, value, unit, **extra):
    print(json.dumps({"metric": metric, "value": value, "unit": unit, **extra}))


def bench_sim(batches=(16384, 131072, 524288)):
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import (
        dispatch_sim_kernel,
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
        resolve_sim_kernel,
    )

    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    key = jax.random.key(0)
    run = dispatch_sim_kernel()
    kernels = {
        resolve_sim_kernel(): lambda th, s, k: run(
            th, s, k, mu_sensory=1.0, collapse_rate=0.0,
            steps_per_pulse=spp, n_max=n_max,
        )
    }
    for N in batches:
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
        pulses = generate_pulse_matrix(jax.random.fold_in(key, 5), N, P)
        for name, fn in kernels.items():
            dt = timeit(fn, theta, pulses, jax.random.fold_in(key, 9))
            emit(f"sim_{name}", N * n_max / dt, "trial-steps/s", batch=N, wall_s=dt)


def bench_train_and_logprob():
    import optax

    from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig, build_mnle

    est = build_mnle(jax.random.key(0), MNLEConfig(condition_dim=85))
    key = jax.random.key(1)
    B = 4096
    z = jax.random.normal(jax.random.fold_in(key, 0), (B, 85))
    x = jnp.stack(
        [jnp.exp(jax.random.normal(jax.random.fold_in(key, 1), (B,))),
         jax.random.randint(jax.random.fold_in(key, 2), (B,), 0, 3).astype(jnp.float32)],
        -1,
    )

    def loss_fn(params, x, z):
        return -jnp.mean(est.log_prob_fn(params, x, z))

    tx = optax.adam(5e-4)
    opt_state = tx.init(est.params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, z)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    dt = timeit(lambda: step(est.params, opt_state)[2])
    emit("train_step", 1.0 / dt, "steps/s", batch=B, wall_s=dt)

    lp = jax.jit(lambda x, z: est.log_prob(x, z))
    dt = timeit(lp, x, z)
    emit("mnle_logprob", B / dt, "rows/s", batch=B, wall_s=dt)

    # The MCMC inner op: per-trial log-prob summed over a 50-trial session,
    # value+grad w.r.t. theta, forward-only and with the NUTS gradient.
    T = 50
    x50, z50 = x[:T], z[:T]
    theta0 = jnp.abs(jax.random.normal(jax.random.fold_in(key, 7), (5,))) + 0.3
    for kern in ["xla"]:
        def potential(theta):
            cond = jnp.concatenate(
                [jnp.broadcast_to(theta, (T, 5)), z50[:, 5:]], -1
            )
            return jnp.sum(est.log_prob_fn(est.params, x50, cond))

        fwd = jax.jit(potential)
        dt = timeit(fwd, theta0)
        emit(f"potential_fwd_{kern}", 1.0 / dt, "calls/s", trials=T, wall_s=dt)
        vg = jax.jit(jax.value_and_grad(potential))
        dt = timeit(lambda th: vg(th)[0], theta0)
        emit(f"potential_grad_{kern}", 1.0 / dt, "calls/s", trials=T, wall_s=dt)
        # Batched over chains (the shape NUTS actually runs).
        for C in (16, 128):
            vgs = jax.jit(jax.vmap(jax.value_and_grad(potential)))
            ths = jnp.abs(jax.random.normal(jax.random.fold_in(key, 8), (C, 5))) + 0.3
            dt = timeit(lambda t_: vgs(t_)[0], ths)
            emit(
                f"potential_grad_{kern}_c{C}", C / dt, "chain-grads/s",
                trials=T, chains=C, wall_s=dt,
            )


def bench_nuts():
    from sbi_for_diffusion_models_tpu.mnle import run_inference_mcmc
    from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig, build_mnle
    from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu.run_config import RUN_CONFIG_PARAMS

    # depth 8: a cap set on earlier hardware, not measured on the GPU.
    cfg = RUN_CONFIG_PARAMS.replace(
        NUM_CHAINS=8, WARMUP_STEPS=100, POSTERIOR_SAMPLES=1000,
        MCMC_MAX_TREE_DEPTH=8,
    )
    prior = build_prior_theta()
    est = build_mnle(jax.random.key(0), MNLEConfig(condition_dim=85))
    theta_true = prior.sample(jax.random.key(1), (1,))[0]
    x_o, pulses_o = simulate_observed_session(theta_true, cfg.NUM_TRIALS_OBS, seed=123)
    t0 = time.perf_counter()
    samples = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, seed=2, verbose=False)
    jax.block_until_ready(samples)
    wall = time.perf_counter() - t0  # includes compile: reported separately
    t0 = time.perf_counter()
    samples = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, seed=3, verbose=False)
    jax.block_until_ready(samples)
    dt = time.perf_counter() - t0
    emit(
        "nuts", cfg.POSTERIOR_SAMPLES / dt, "posterior-samples/s",
        chains=cfg.NUM_CHAINS, trials=cfg.NUM_TRIALS_OBS,
        wall_s=dt, compile_plus_first_run_s=wall,
    )


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--profile", type=str, default=None,
        help="capture a jax.profiler trace of one pass into this directory",
    )
    ap.add_argument(
        "--sweep", action="store_true",
        help="full trial-steps/s-vs-batch sweep",
    )
    ap.add_argument("--skip-nuts", action="store_true")
    a = ap.parse_args()

    emit("device", 0, jax.devices()[0].device_kind)
    batches = (
        (4096, 16384, 65536, 131072, 262144, 524288, 1048576)
        if a.sweep
        else (16384, 131072, 524288)
    )
    if a.profile:
        with jax.profiler.trace(a.profile):
            bench_sim(batches)
            bench_train_and_logprob()
        print(json.dumps({"metric": "profile_dir", "value": 0, "unit": a.profile}))
    else:
        bench_sim(batches)
        bench_train_and_logprob()
    if not a.skip_nuts:
        bench_nuts()
