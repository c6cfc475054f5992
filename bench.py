"""Simulator benchmark: DDM trial-steps/sec on one device.

Runs the pulse-DDM simulator kernel that ``dispatch_sim_kernel`` picks (the
fused Pallas kernel on the GPU, the XLA scan elsewhere) on the reference's
default workload shape (T_MAX=8s, dt=5e-4 -> 16,000 steps/trial, P=80 pulse
slots; reference constants.py:2-5) over a large trial batch and reports
nominal trial-steps per second (trials x n_max / wall), the workload-defined
metric from BASELINE.json. vs_baseline is the ratio to the 1e8
trial-steps/s/chip target of BASELINE.json (the reference itself publishes
no numbers — BASELINE.md).

Both kernels early-exit once every trial in their granule has absorbed
(ddm_scan.py: whole-batch chunk skip; ddm_pallas.py: per-block while-loop),
so the nominal number counts steps the hardware never ran. The JSON line
therefore ALSO reports ``executed_trial_steps_per_sec``: executed work is
derived exactly from the outputs — activity is monotone (absorption is
permanent, the decision window fixed), so a granule runs
ceil(max_trial done_step / chunk) chunks, where done_step = (rt - t_nd)/dt is
recoverable per trial from the returned RT.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"executed_trial_steps_per_sec", "executed_fraction", "kernel", "device"}.
"""

import json
import time

import jax
import jax.numpy as jnp


def main():
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import (
        dispatch_sim_kernel,
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
        resolve_sim_kernel,
    )
    from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)

    N = 131_072  # trial batch per kernel launch
    key = jax.random.key(0)
    # Realistic prior-scale parameters (reference rt_choice_model_pipeline.py:34-46).
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

    kernel_name = resolve_sim_kernel()
    kernel = dispatch_sim_kernel()

    def run(k):
        return kernel(
            theta, pulses, k,
            mu_sensory=1.0, collapse_rate=0.0,
            steps_per_pulse=spp, n_max=n_max,
        )

    # Warmup / compile.
    jax.block_until_ready(run(jax.random.fold_in(key, 100)))

    reps = 5
    t0 = time.perf_counter()
    for r in range(reps):
        out = run(jax.random.fold_in(key, 200 + r))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps

    # Executed trial-steps, derived exactly from the last rep's outputs (see
    # module docstring). done_step = hit_step for absorbed trials and the
    # censor window n_steps otherwise — both equal round((rt - t_nd)/dt_sim)
    # because rt = clip(t_nd + done_step*dt, 1e-6, T_MAX) never saturates
    # (done_step <= floor((T_MAX - t_nd)/dt)); ddm_scan.py:216-218.
    import numpy as np

    from sbi_for_diffusion_models_tpu.constants import DT_CHOICE
    from sbi_for_diffusion_models_tpu.ops.ddm_pallas import BLOCK_TRIALS
    from sbi_for_diffusion_models_tpu.ops.ddm_scan import sanitize_theta

    rt = np.asarray(out[:, 0], dtype=np.float64)
    t_nd = np.asarray(sanitize_theta(theta)[4], dtype=np.float64)
    done_step = np.rint((rt - t_nd) / float(DT_CHOICE))
    # Granule: one while-loop per block of trials for the Pallas kernel, one
    # lax.cond per chunk over the WHOLE batch for the scan; chunk = one pulse
    # interval in both.
    granule = BLOCK_TRIALS if kernel_name == "pallas" else N
    granule_max = done_step.reshape(-1, granule).max(axis=1)
    executed = float((np.ceil(granule_max / spp) * spp * granule).sum())

    trial_steps = N * n_max
    value = trial_steps / dt
    target = 1e8  # >=1e8 DDM trial-steps/sec/chip (BASELINE.json)
    device = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "ddm_trial_steps_per_sec_per_chip",
                "value": value,
                "unit": "trial-steps/s",
                "vs_baseline": value / target,
                "executed_trial_steps_per_sec": executed / dt,
                "executed_fraction": executed / trial_steps,
                "kernel": kernel_name,
                "device": {"platform": device.platform, "kind": device.device_kind},
            }
        )
    )


if __name__ == "__main__":
    main()
