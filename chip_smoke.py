"""Bring-up check: the whole program, once, on one NVIDIA GPU.

Runs the main path through the functions a user calls —
``simulate_training_set_with_conditions`` -> ``train_mnle`` ->
``simulate_observed_session`` -> ``run_inference_mcmc`` -> ``run_sbc`` — at
the full width of the calibrated estimator (``CALIBRATED_CONFIG``: MNLE with
128 hidden units, 10 RQ-spline transforms, 24 bins, shifted-log censored RT,
log-theta conditioning; PT with 6 replicas, tau-slice and grid hop over 4
chains, 50 trials per session) and the committed weights
``artifacts/models/mnle_10m_shifted_logt_affine.npz``.

Each phase prints one JSON object: its wall time, its compile time (JAX's
trace + lower + backend-compile events inside the phase), the
``memory_analysis()`` of the phase's largest program (compiled here at the
phase's shapes), the device's peak memory so far, and its checks. Any
failed check raises, and the script exits non-zero without a result line.

    python chip_smoke.py               # phases (a)-(f) on one GPU
    python chip_smoke.py --four-cards  # potential + batched SBC over 4 GPUs vs 1

Cuts, stated: phase (c) trains 2 epochs on 200k simulations (the calibrated
budget is 10M); phase (e) runs 100 warmup + 200 draws per chain; phase (f)
runs SBC over 8 datasets x 200 draws after 50 warmup steps, without the
mixing remediation (the calibrated run is 96 x 600 after 200 warmup steps,
with up to three remediation rounds); the four-card check runs 8 x 40
after 20 warmup steps without the tau-slice move.

XLA's GEMM autotuning is turned off (``--xla_gpu_autotune_level=0``, unless
``XLA_FLAGS`` already sets a level) to shorten the compiles of the sampler
programs, whose matrix products are small; phase (a) records the flags.

The last line is ``{"ok": true, "device": {...}}``. Without a GPU the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "out" / "chip_smoke"  # untracked arrays behind the checks
MODEL_FILE = "mnle_10m_shifted_logt_affine.npz"

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_s: dict[int, float] = {}  # per thread: compiles run in the caller


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        t = threading.get_ident()
        _compile_s[t] = _compile_s.get(t, 0.0) + duration


def compile_s() -> float:
    """Seconds this thread has spent tracing, lowering and compiling."""
    return _compile_s.get(threading.get_ident(), 0.0)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {
        k: int(getattr(ma, k))
        for k in (
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "temp_size_in_bytes",
            "generated_code_size_in_bytes",
        )
    }


@contextmanager
def phase(name: str):
    """Time a phase; print its record only if it completes."""
    import jax

    rec = {"phase": name}
    c0, t0 = compile_s(), time.perf_counter()
    yield rec
    rec["wall_s"] = time.perf_counter() - t0
    rec["compile_s"] = compile_s() - c0
    stats = jax.devices()[0].memory_stats() or {}
    rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(json.dumps(rec), flush=True)


def best_time(fn, reps: int = 3) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def load_committed(dtype=None):
    """The committed model on the current default device, its arrays cast to
    ``dtype`` when one is given (float64 for the CPU reference)."""
    import jax
    import jax.numpy as jnp

    import sbi_for_diffusion_models_tpu as sdm
    from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLE

    est = sdm.load_model(MODEL_FILE)
    if dtype is None:
        return est
    cast = lambda a: jnp.asarray(a, dtype)
    return MNLE(cfg=est.cfg, params=jax.tree.map(cast, est.params),
                cond_mean=cast(est.cond_mean), cond_std=cast(est.cond_std),
                x_mean=cast(est.x_mean), x_std=cast(est.x_std))


def value_err(v, ref) -> float:
    """Worst error relative to max(1, |ref|)."""
    import numpy as np

    return float(np.max(np.abs(v - ref) / np.maximum(np.abs(ref), 1.0)))


def grad_errs(g, ref):
    """Relative error of each row's gradient vector."""
    import numpy as np

    return np.linalg.norm(g - ref, axis=-1) / np.maximum(
        np.linalg.norm(ref, axis=-1), 1e-30)


def tolerances(value: float, grad_median: float) -> dict:
    """Phase (d)'s rule, given a float32 reference's errors against float64:
    a float32 result passes within max(1e-4, 4x) its worst log-prob row
    error and max(1e-5, 2x) its median gradient error. The factors are 1.25x
    the largest GPU/CPU ratios over 8 seeds x 2 shapes, rounded up to 2, 3,
    4, 6 or 8; TF32 Dense layers miss both by 7x or more at every reading.

    The worst gradient is not held to a rule. The potential's gradient jumps
    at isolated points: one trial's gradient changes by O(10) under a 1e-6
    relative change of theta or of its RT, so whether a chain lands on one
    side or the other is float32 rounding, not accuracy."""
    return {
        "value": max(1e-4, 4 * value),
        "grad_median": max(1e-5, 2 * grad_median),
    }


def potential_fn(est, prior, R: int, beta_min: float):
    """Tempered PT potential of ``mnle._run_sbc_batched`` as a function of
    (u, x_o, s_o, beta): prior + log|J| + beta * sum_i log p(x_i | theta, s_i)."""
    import jax.numpy as jnp

    from sbi_for_diffusion_models_tpu.distributions import mcmc_transform

    bij = mcmc_transform(prior)

    def logp(u, x_o, s_o, beta):
        theta = bij.forward(u)
        cond = jnp.concatenate(
            [jnp.broadcast_to(theta, (s_o.shape[0], theta.shape[-1])), s_o], -1
        )
        ll = jnp.sum(est.log_prob_fn(est.params, x_o, cond))
        return prior.log_prob(theta) + bij.forward_log_det(u) + beta * ll

    return logp, bij


# ---------------------------------------------------------------------------
def phase_device():
    import jax

    with phase("a_device") as rec:
        d = jax.devices()[0]
        rec["platform"] = d.platform
        rec["device_kind"] = d.device_kind
        rec["count"] = len(jax.devices())
        rec["xla_flags"] = os.environ.get("XLA_FLAGS", "")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
        rec["nvidia_smi"] = smi
    print("\n".join(smi), flush=True)


def phase_simulator():
    """(b) Triton-route kernel vs the scan reference at the real schedule."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import sbi_for_diffusion_models_tpu as sdm
    from sbi_for_diffusion_models_tpu.ops.ddm_pallas import ddm_rt_choice_pallas
    from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_rt_choice_scan

    n_max, spp = sdm.pulse_schedule()
    P = sdm.n_pulses_max_from_schedule(n_max, spp)
    kw = dict(steps_per_pulse=spp, n_max=n_max)
    prior = sdm.build_prior_theta()
    dt = float(sdm.constants.DT_CHOICE)

    with phase("b_simulator") as rec:
        n_th, per = 8, 16384
        theta = jnp.repeat(prior.sample(jax.random.key(5), (n_th,)), per, axis=0)
        s = sdm.generate_pulse_matrix(jax.random.key(6), n_th * per, P)
        rec["memory"] = memory(
            ddm_rt_choice_pallas.lower(theta, s, jax.random.key(0), **kw).compile()
        )

        # Zero noise: both follow the identical deterministic recurrence.
        xp = np.asarray(ddm_rt_choice_pallas(theta, s, jax.random.key(1), mu_sensory=0.0, **kw))
        xs = np.asarray(ddm_rt_choice_scan(theta, s, jax.random.key(2), mu_sensory=0.0, **kw))
        drt = np.abs(xp[:, 0] - xs[:, 0])
        zero = {
            "choice_mismatch": int((xp[:, 1] != xs[:, 1]).sum()),
            "hit_step_mismatch": int((drt > 0.5 * dt).sum()),
            "rt_max_abs_diff": float(drt.max()),
        }
        rec["zero_noise"] = zero
        check(zero["choice_mismatch"] == 0 and zero["hit_step_mismatch"] == 0
              and zero["rt_max_abs_diff"] <= 1e-6, f"zero-noise parity {zero}")

        # Noise on: distributional parity per theta.
        xp = np.asarray(ddm_rt_choice_pallas(theta, s, jax.random.key(3), **kw)).reshape(n_th, per, 2)
        xs = np.asarray(ddm_rt_choice_scan(theta, s, jax.random.key(4), **kw)).reshape(n_th, per, 2)
        np.savez_compressed(OUT / "b_noise_on.npz", kernel=xp, scan=xs)
        qs = np.asarray([0.1, 0.5, 0.9])
        rng = np.random.default_rng(0)
        frac_z, q_ratio = 0.0, 0.0
        for i in range(n_th):
            for c in (0, 1, 2):
                p1, p2 = (xp[i, :, 1] == c).mean(), (xs[i, :, 1] == c).mean()
                se = math.sqrt((p1 * (1 - p1) + p2 * (1 - p2)) / per)
                frac_z = max(frac_z, abs(p1 - p2) / max(se, 1e-12) if p1 != p2 else 0.0)
            # Standard errors of the RT quantiles by bootstrap: the RT
            # distribution clusters at pulse arrivals, where a density-based
            # SE is unreliable.
            diff = np.quantile(xp[i, :, 0], qs) - np.quantile(xs[i, :, 0], qs)
            var = 0.0
            for sample in (xp[i, :, 0], xs[i, :, 0]):
                boot = np.quantile(sample[rng.integers(0, per, (200, per))], qs, axis=1)
                var = var + boot.var(axis=1)
            q_ratio = max(q_ratio, float(np.max(np.abs(diff) / (2 * dt + 4 * np.sqrt(var)))))
        rec["noise_on"] = {"max_fraction_z": frac_z, "max_quantile_diff_over_tol": q_ratio}
        check(frac_z <= 4.0, f"choice/censor fractions differ by {frac_z:.2f} SE")
        check(q_ratio <= 1.0, f"RT quantiles differ by {q_ratio:.2f} x tolerance")

        for N in (131072, 4096):
            th = prior.sample(jax.random.key(7), (N,))
            sN = sdm.generate_pulse_matrix(jax.random.key(8), N, P)
            t_k = best_time(lambda: ddm_rt_choice_pallas(th, sN, jax.random.key(9), **kw))
            t_s = best_time(lambda: ddm_rt_choice_scan(th, sN, jax.random.key(9), **kw))
            rec[f"N{N}"] = {
                "kernel_s": t_k, "scan_s": t_s,
                "kernel_trial_steps_per_s": N * n_max / t_k,
                "scan_trial_steps_per_s": N * n_max / t_s,
            }


def phase_train(cfg, prior, proposal):
    """(c) training-set generation + train_mnle at full width."""
    import jax
    import numpy as np

    import sbi_for_diffusion_models_tpu as sdm
    from sbi_for_diffusion_models_tpu.mnle import _make_loss_fn

    with phase("c_train") as rec:
        t0 = time.perf_counter()
        z, x = sdm.simulate_training_set_with_conditions(
            cfg, proposal, seed=jax.random.key(1), verbose=False
        )
        jax.block_until_ready(x)
        rec["simulate_s"] = time.perf_counter() - t0
        rec["num_simulations"] = int(x.shape[0])
        t0 = time.perf_counter()
        est = sdm.train_mnle(cfg, proposal, z, x, seed=jax.random.key(2), verbose=False)
        rec["train_s"] = time.perf_counter() - t0
        tr, vl = est.train_meta["train_loss_history"], est.train_meta["val_loss_history"]
        rec["train_loss"], rec["val_loss"] = tr, vl
        check(all(np.isfinite(tr + vl)), "non-finite loss")
        check(len(vl) == cfg.TRAIN_MAX_EPOCHS, f"ran {len(vl)} epochs")
        check(tr[-1] < tr[0] and vl[-1] < vl[0], f"loss did not fall: {tr} {vl}")
        B = cfg.TRAIN_BATCH_SIZE
        step = jax.jit(jax.value_and_grad(_make_loss_fn(est)))
        rec["memory"] = memory(step.lower(est.params, x[:B], z[:B]).compile())
    return est


@contextmanager
def dense_precision(precision):
    """Trace the MNLE's Dense layers at ``precision`` instead of HIGHEST."""
    from sbi_for_diffusion_models_tpu.nets import mnle_net

    saved, mnle_net._PRECISION = mnle_net._PRECISION, precision
    try:
        yield
    finally:
        mnle_net._PRECISION = saved


def within(errs: dict, tol: dict) -> bool:
    return all(errs[k] <= tol[k] for k in tol)


def potential_readings(cfg, prior, seeds):
    """Errors of the PT potential of the committed model against float64.

    For each seed (one observed session and one draw of chain positions) and
    each NUTS shape (the PT batch, and 128 untempered chains), value and
    gradient are taken four ways: on the default device in float32 (the
    program's path), on the default device with TF32 Dense layers (a loss of
    HIGHEST the rule has to catch), on the in-process CPU in float32 (the
    reference the rule scales), and on the CPU in float64 (the truth).
    Each reading holds every variant's worst log-prob row error (relative to
    max(1, |log p|)), median and worst per-chain gradient error."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import sbi_for_diffusion_models_tpu as sdm
    from sbi_for_diffusion_models_tpu.inference.nuts import geometric_ladder

    cpu = jax.devices("cpu")[0]
    T, R = cfg.NUM_TRIALS_OBS, cfg.MCMC_PT_REPLICAS
    shapes = (("pt_4x6", cfg.NUM_CHAINS * R, True), ("chains_128", 128, False))
    control = jax.lax.DotAlgorithmPreset.TF32_TF32_F32

    def build(dtype=jnp.float32):
        # Built under the current default device, so the CPU copies hold no
        # array of the device copy.
        est = load_committed(None if dtype == jnp.float32 else dtype)
        logp, bij = potential_fn(est, sdm.build_prior_theta(), R, cfg.MCMC_PT_BETA_MIN)
        vg = jax.vmap(jax.value_and_grad(logp), in_axes=(0, None, None, 0))

        def rows(u, x_o, s_o):
            n = u.shape[0]
            cond = jnp.concatenate(
                [jnp.broadcast_to(bij.forward(u)[:, None], (n, T, 5)),
                 jnp.broadcast_to(s_o, (n,) + s_o.shape)], -1)
            return est.log_prob_fn(est.params, jnp.broadcast_to(x_o, (n,) + x_o.shape), cond)

        return jax.jit(vg), jax.jit(rows), bij

    vg_g, rows_g, bij = build()
    vg_t, rows_t, _ = build()  # traced under ``control`` only
    with jax.default_device(cpu):
        vg_c, rows_c, _ = build()
        with jax.enable_x64(True):
            vg_64, rows_64, _ = build(jnp.float64)
    ladder = np.asarray(geometric_ladder(R, cfg.MCMC_PT_BETA_MIN), np.float32)

    def errs(g, r, ref):
        eg = grad_errs(g, ref[0])
        return {"value": value_err(r, ref[1]), "grad_median": float(np.median(eg)),
                "grad_max": float(np.max(eg))}

    readings, memory_pt, timings = [], None, {}
    for seed in seeds:
        key = jax.random.key(seed)
        theta_true = prior.sample(key, (1,))[0]
        x_o, s_o = sdm.simulate_observed_session(theta_true, T, seed=seed)
        x_o, s_o = np.asarray(x_o), np.asarray(s_o)
        for name, n, tempered in shapes:
            theta = prior.sample(jax.random.fold_in(key, 1), (n,))
            u = np.asarray(bij.inverse(theta))
            beta = np.resize(ladder, n) if tempered else np.ones(n, np.float32)
            args = (u, x_o, s_o, beta)
            v_g, g_g = jax.device_get(vg_g(*args))
            r_g = np.asarray(rows_g(u, x_o, s_o))
            with dense_precision(control):
                _, g_t = jax.device_get(vg_t(*args))
                r_t = np.asarray(rows_t(u, x_o, s_o))
            with jax.default_device(cpu):
                _, g_c = jax.device_get(vg_c(*args))
                r_c = np.asarray(rows_c(u, x_o, s_o))
                with jax.enable_x64(True):
                    a64 = tuple(np.asarray(a, np.float64) for a in args)
                    _, g_64 = jax.device_get(vg_64(*a64))
                    r_64 = np.asarray(rows_64(*a64[:3]))
            np.savez_compressed(OUT / f"d_{name}_seed{seed}.npz", gpu=r_g, cpu=r_c,
                                tf32=r_t, f64=r_64, grad_gpu=g_g, grad_cpu=g_c,
                                grad_tf32=g_t, grad_f64=g_64)
            ref = (g_64, r_64)
            readings.append({
                "seed": seed, "shape": name, "rows": n * T,
                "finite": bool(np.isfinite(v_g).all() and np.isfinite(g_g).all()),
                "gpu_vs_cpu_logprob_row_max_abs_diff": float(np.abs(r_g - r_c).max()),
                "gpu_vs_cpu_grad_max_rel_diff": float(np.max(grad_errs(g_g, g_c))),
                "gpu": errs(g_g, r_g, ref),
                "cpu": errs(g_c, r_c, ref),
                "control": errs(g_t, r_t, ref),
            })
            if name not in timings:
                compiled = vg_g.lower(*args).compile()
                timings[name] = best_time(lambda: compiled(*args), reps=10)
                if memory_pt is None:
                    memory_pt = memory(compiled)
    return readings, timings, memory_pt


D_SEEDS = (13, 14, 15)  # phase (d): one observed session and chain draw each


def phase_potential(cfg, prior):
    """(d) value and gradient of the PT potential for the committed model,
    GPU against the in-process CPU backend, at NUTS shapes, over
    ``D_SEEDS``.

    Two float32 backends do not agree to float32 rounding here (the CPU
    itself is ~1e-3 from float64 per log-prob row), so each is measured
    against float64 on the CPU and the GPU must be as accurate as the CPU
    by ``tolerances``. The same potential with TF32 Dense layers must fail
    that rule: it shows the rule can see a loss of ``Precision.HIGHEST``."""
    with phase("d_potential") as rec:
        readings, timings, rec["memory"] = potential_readings(cfg, prior, D_SEEDS)
        rec["value_and_grad_s"] = timings
        rec["readings"] = readings
        for r in readings:
            r["tolerance"] = tol = tolerances(r["cpu"]["value"], r["cpu"]["grad_median"])
            where = f"seed {r['seed']}, {r['shape']}"
            check(r["finite"], f"{where}: non-finite potential")
            check(within(r["gpu"], tol), f"{where}: GPU {r['gpu']} outside {tol}")
            check(not within(r["control"], tol),
                  f"{where}: the TF32 control {r['control']} passed {tol}")
    return rec


def phase_mcmc(cfg, prior, est, pot: dict):
    """(e) run_inference_mcmc with the calibrated sampler."""
    import jax
    import numpy as np

    import sbi_for_diffusion_models_tpu as sdm
    from sbi_for_diffusion_models_tpu.inference.diagnostics import (
        effective_sample_size,
        split_r_hat,
    )

    C, W, S = cfg.NUM_CHAINS, 100, 200
    mcfg = cfg.replace(WARMUP_STEPS=W, POSTERIOR_SAMPLES=C * S)
    with phase("e_mcmc") as rec:
        theta_true = prior.sample(jax.random.key(21), (1,))[0]
        x_o, s_o = sdm.simulate_observed_session(theta_true, cfg.NUM_TRIALS_OBS, seed=22)
        c0, t0 = compile_s(), time.perf_counter()
        samples, info = sdm.run_inference_mcmc(
            mcfg, prior, est, x_o, s_o, seed=23, verbose=False, return_info=True
        )
        samples = np.asarray(samples)
        wall = time.perf_counter() - t0
        chains = samples.reshape(S, C, -1).swapaxes(0, 1)
        check(samples.shape == (C * S, 5) and np.isfinite(samples).all(), "bad samples")
        rec["split_rhat_max"] = float(np.max(split_r_hat(chains)))
        rec["min_ess"] = float(np.min(effective_sample_size(chains)))
        rec["divergences"] = int(np.sum(info["diverging"]))
        # Leapfrog steps per transition of the vmapped batch: the slowest row.
        steps = float(np.mean(np.max(np.asarray(info["num_steps"]), axis=0)))
        transition_s = (wall - (compile_s() - c0)) / (W + S)
        rec["transition_s"] = transition_s
        rec["leapfrog_steps_per_transition"] = steps
        t_vg = pot["value_and_grad_s"]["pt_4x6"]
        rec["logprob_share_of_transition"] = steps * t_vg / transition_s
        # The potential at this phase's 24 rows: phase (d)'s program.
        rec["memory"] = pot["memory"]


def rec_memory_pt(cfg, prior, est, rows: int):
    import jax
    import jax.numpy as jnp

    logp, _ = potential_fn(est, prior, cfg.MCMC_PT_REPLICAS, cfg.MCMC_PT_BETA_MIN)
    vg = jax.jit(jax.vmap(jax.value_and_grad(logp), in_axes=(0, 0, 0, 0)))
    T = cfg.NUM_TRIALS_OBS
    return memory(vg.lower(
        jnp.zeros((rows, 5)), jnp.zeros((rows, T, 2)), jnp.zeros((rows, T, 80)),
        jnp.ones((rows,)),
    ).compile())


def phase_sbc(cfg, prior, est, name="f_sbc", mesh=None, draws=200):
    """(f) batched SBC through run_sbc."""
    import numpy as np

    import sbi_for_diffusion_models_tpu as sdm

    D, S = 8, draws
    with phase(name) as rec:
        res = sdm.run_sbc(
            cfg, prior, est, num_datasets=D, num_posterior_samples=S,
            outdir=OUT / name, seed=31, verbose=False, mesh=mesh,
        )
        ranks = np.asarray(res["ranks"])
        check(ranks.shape == (D, 5), f"ranks shape {ranks.shape}")
        check(bool(((ranks >= 0) & (ranks <= S)).all()), "ranks out of range")
        rec["datasets"], rec["draws"] = D, S
        rec["ranks"] = ranks.tolist()
        rec["rhat_max"] = [float(v) for v in res["rhat_max"]]
        rec["min_ess"] = [float(v) for v in res["min_ess"]]
        rec["divergences"] = [float(v) for v in res["divergences_per_dataset"]]
        rec["still_flagged"] = res["flagged_final"]
        rows = D * cfg.NUM_CHAINS * cfg.MCMC_PT_REPLICAS
        rec["memory"] = rec_memory_pt(cfg, prior, est, rows)
    return rec


def phase_sharded_potential(cfg, prior, est, mesh):
    """(g) the PT potential at the folded (dataset x chain x replica) rows of
    the batched SBC, sharded over the mesh against one card. Both are
    measured against float64 on the CPU, and the sharded result must be as
    accurate as the one-card result by phase (d)'s rule."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    import sbi_for_diffusion_models_tpu as sdm
    from sbi_for_diffusion_models_tpu.inference.nuts import geometric_ladder

    D, R, T = 8, cfg.MCMC_PT_REPLICAS, cfg.NUM_TRIALS_OBS
    rows = D * cfg.NUM_CHAINS * R
    with phase("g_sharded_potential") as rec:
        logp, bij = potential_fn(est, prior, R, cfg.MCMC_PT_BETA_MIN)
        vg = jax.jit(jax.vmap(jax.value_and_grad(logp)))
        thetas = prior.sample(jax.random.key(41), (D,))
        sessions = [sdm.simulate_observed_session(thetas[i], T, seed=100 + i) for i in range(D)]
        rep = lambda a: np.repeat(np.stack([np.asarray(b) for b in a]), rows // D, axis=0)
        args = (
            np.asarray(bij.inverse(prior.sample(jax.random.key(42), (rows,)))),
            rep([x for x, _ in sessions]), rep([s for _, s in sessions]),
            np.tile(np.asarray(geometric_ladder(R, cfg.MCMC_PT_BETA_MIN), np.float32), rows // R),
        )
        v1, g1 = jax.device_get(vg(*args))
        axis = mesh.axis_names[0]
        sharded = [
            jax.device_put(a, NamedSharding(mesh, PartitionSpec(axis, *([None] * (a.ndim - 1)))))
            for a in args
        ]
        v4, g4 = jax.device_get(vg(*sharded))
        with jax.default_device(jax.devices("cpu")[0]), jax.enable_x64(True):
            logp64, _ = potential_fn(load_committed(jnp.float64), sdm.build_prior_theta(),
                                     R, cfg.MCMC_PT_BETA_MIN)
            vg64 = jax.jit(jax.vmap(jax.value_and_grad(logp64)))
            v64, g64 = jax.device_get(vg64(*(np.asarray(a, np.float64) for a in args)))
        errs = {}
        for name, v, g in (("one_card", v1, g1), ("four_cards", v4, g4)):
            eg = grad_errs(g, g64)
            errs[name] = {"value": value_err(v, v64), "grad_median": float(np.median(eg)),
                          "grad_max": float(np.max(eg))}
        tol = tolerances(errs["one_card"]["value"], errs["one_card"]["grad_median"])
        rec["rows"] = rows
        rec["potential_max_rel_diff"] = value_err(v4, v1)
        rec["grad_max_rel_diff"] = float(np.max(grad_errs(g4, g1)))
        rec["one_card_vs_f64"], rec["four_cards_vs_f64"] = errs["one_card"], errs["four_cards"]
        rec["tolerance"] = tol
        check(np.isfinite(v4).all() and np.isfinite(g4).all(), "non-finite sharded potential")
        check(all(errs["four_cards"][k] <= tol[k] for k in tol),
              f"sharded potential less accurate than one card: {errs} vs {tol}")


def four_cards(cfg, prior, est):
    """The sharded potential against one card, then the batched SBC on one
    card and sharded over 4. The two SBC runs go at the same time, each in
    its own thread, so that their sampler programs compile side by side;
    their walls overlap and share card 0, so they show that both finish, not
    which is faster."""
    import jax

    from sbi_for_diffusion_models_tpu.parallel.mesh import default_mesh

    check(len(jax.devices()) >= 4, f"need 4 GPUs, found {len(jax.devices())}")
    mesh = default_mesh(4)
    phase_sharded_potential(cfg, prior, est, mesh)
    # Stated cuts for the cross-card check: 20 warmup steps, 8 datasets x 40
    # draws, no tau-slice (a smaller sampler program to compile).
    sbc_cfg = cfg.replace(WARMUP_STEPS=20, MCMC_TAU_SLICE=False)
    with ThreadPoolExecutor(2) as pool:
        one = pool.submit(phase_sbc, sbc_cfg, prior, est, name="h_sbc_one_card", draws=40)
        four = pool.submit(phase_sbc, sbc_cfg, prior, est, name="i_sbc_four_cards",
                           mesh=mesh, draws=40)
        return one.result(), four.result()


# ---------------------------------------------------------------------------
def result_line(devices) -> str:
    """The last line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the SBC path sharded over 4 GPUs, against one")
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_gpu_autotune_level=0").strip()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2

    os.environ["MODEL_DIR"] = str(ROOT / "artifacts" / "models")
    OUT.mkdir(parents=True, exist_ok=True)
    import sbi_for_diffusion_models_tpu as sdm
    from sbi_for_diffusion_models_tpu.proposals import (
        ExtendedProposal,
        PulseSequenceProposal,
    )
    from sbi_for_diffusion_models_tpu.run_config import CALIBRATED_CONFIG
    from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    # Stated cut: SBC without the mixing remediation (the calibrated run
    # re-samples flagged datasets over up to three escalating rounds).
    cfg = CALIBRATED_CONFIG.replace(SBC_REMEDIATE=False)
    prior = sdm.build_prior_theta()

    phase_device()
    if args.four_cards:
        four_cards(cfg, prior, sdm.load_model(MODEL_FILE))
    else:
        phase_simulator()
        n_max, spp = sdm.pulse_schedule()
        P = sdm.n_pulses_max_from_schedule(n_max, spp)
        proposal = ExtendedProposal(prior, PulseSequenceProposal(P, cfg.P_SUCCESS, seed=0))
        phase_train(
            cfg.replace(NUM_SIMULATIONS=200_000, TRAIN_BATCH_SIZE=4096,
                        TRAIN_MAX_EPOCHS=2),
            prior, proposal,
        )
        pot = phase_potential(cfg, prior)
        est = sdm.load_model(MODEL_FILE)
        phase_mcmc(cfg, prior, est, pot)
        phase_sbc(cfg.replace(WARMUP_STEPS=50), prior, est)
    print(result_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
