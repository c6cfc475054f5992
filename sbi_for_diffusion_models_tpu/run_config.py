"""Experiment configuration.

Field names and defaults mirror the reference ``RunConfig``
(reference: src/sbi_for_diffusion_models/run_config.py:4-44) so downstream code
written against the reference keeps working. The dataclass is frozen and
hashable, which makes it safe to close over in jitted functions (it is static,
never traced).

Extension knobs (prefixed ``SIM_`` / ``MNLE_`` / ``MCMC_`` / ``TRAIN_`` /
``SBC_``) extend the reference config without renaming anything the
reference defines.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RunConfig:
    # Data / simulator settings (reference run_config.py:7-8)
    MU_SENSORY: float = 1.0
    P_SUCCESS: float = 0.75

    # Training settings (reference run_config.py:11-12)
    NUM_SIMULATIONS: int = 10_000
    TRAIN_BATCH_SIZE: int = 4096

    # Start small; likelihood approximation bias can grow when summing over
    # many trials (reference run_config.py:15).
    NUM_TRIALS_OBS: int = 50

    # We recommend log-transforming RT but NOT the categorical choice
    # (reference run_config.py:18).
    LOG_RT_MANUALLY: bool = False

    # Apply log to the continuous column inside the density estimator
    # (reference run_config.py:24-25).
    SBI_LOG_TRANSFORM_X: bool = True
    Z_SCORE_X: str | None = "independent"

    # MCMC settings (reference run_config.py:28-30)
    NUM_CHAINS: int = 2
    WARMUP_STEPS: int = 100
    POSTERIOR_SAMPLES: int = 1000

    # Optional likelihood tempering for debugging only (1.0 = true posterior;
    # reference run_config.py:36-37).
    TEMPERATURE: float = 1.0
    THETA_TRUE_FROM_PRIOR: bool = True

    # SBC settings (reference run_config.py:40-41)
    SBC_NUM_DATASETS: int = 10
    SBC_POST_SAMPLES: int = 1500

    # ------------------------------------------------------------------
    # Extensions (not present in the reference).
    # ------------------------------------------------------------------
    # MNLE architecture (reference hard-codes these at mnle.py:36-38).
    MNLE_HIDDEN_FEATURES: int = 128
    MNLE_NUM_TRANSFORMS: int = 10
    MNLE_NUM_BINS: int = 24
    MNLE_TAIL_BOUND: float = 5.0
    # Number of discrete choice categories. 0 = infer from the training data
    # (max observed + 1, floored at 3 for {0, 1, censored}); set explicitly
    # for variants whose rare categories may be absent from a finite
    # training draw.
    MNLE_NUM_CATEGORIES: int = 0
    # Depth of the conditioner MLPs (categorical head + flow trunk); the
    # reference's sbi nets are 2 layers deep.
    MNLE_TRUNK_DEPTH: int = 2
    # Pulse summary-embedding width: >0 routes the P-dim pulse block of the
    # condition through a learned embedding net (plus physics-motivated
    # leak-decayed summary features) before the heads; 0 = raw condition,
    # matching the reference's flat 85-dim input (reference mnle.py:31-39).
    MNLE_EMBED_DIM: int = 0
    MNLE_EMBED_DEPTH: int = 2
    # "replace" swaps the raw pulse block for [embedding, features] (lossy);
    # "append" keeps the raw block and appends [embedding?, features]
    # (with MNLE_EMBED_DIM=0 appends the physics features alone).
    MNLE_EMBED_MODE: str = "replace"
    # Censored-RT likelihood: censored trials (choice == 2, RT pinned at the
    # window end, reference rt_choice_model.py:208-218) contribute only
    # P(choice | z) instead of a smoothed point-mass density. False = the
    # reference estimator's behavior.
    MNLE_CENSOR_RT: bool = False
    # RT representation: "log" (reference-style flow over log RT),
    # "shifted_log" (flow over log decision time log(rt - t_nd): the hard
    # response onset is built into the representation, fixing the "log"
    # rep's measured onset-leak t_nd bias at high budget — see
    # nets/mnle_net.MNLEConfig.rt_rep; requires MNLE_CENSOR_RT), or "pulse"
    # (physics-informed slot/phase factorization on the pulse grid; requires
    # MNLE_CENSOR_RT). See nets/mnle_net.MNLEConfig.rt_rep.
    # STATUS ("pulse"): research scaffolding — statistically UNCALIBRATED.
    # Every measured 96-dataset SBC run failed rank uniformity (KS p down to
    # 4e-16; artifacts/calibration_pulseabs_*_96), and train_mnle warns on
    # use. Kept because its sharpness exposed the t_nd multimodality.
    MNLE_RT_REP: str = "log"
    # Grid anchor for the pulse rep: "absolute" (theta-independent slots +
    # circular phase flow; smooth potential) or "tnd" (slots anchored at the
    # trial's t_nd; exact atom pinning but a discontinuous potential).
    MNLE_GRID_ANCHOR: str = "absolute"
    # Condition dims to log-transform before z-scoring (conditioning-only
    # reparameterization, no density correction). () = reference behavior
    # (raw z-scoring). (1, 2, 3) = the pipeline prior's LogNormal dims
    # (lam, v, B, pipeline.build_prior_theta) — raw z-scoring parks their
    # tails (v up to ~26 = +12 sigma) in trunk saturation, producing the
    # measured shared SBC shrinkage corr(v_true, v_rank) = +0.2..0.4
    # (artifacts/calibration_*_96 round 3 analysis).
    MNLE_LOG_THETA_DIMS: tuple = ()
    # Left-tail sharpening of the flow coordinate (round-4): a fixed
    # monotone pre-transform giving the learned (log-)decision-time density
    # the doubly-exponential near-onset decay of true diffusion first
    # passage, which a Gaussian-base flow structurally lacks — the root
    # cause of the one-sided tau SBC bias that survives the exact-onset
    # shifted_log rep (nets/mnle_net.MNLEConfig.tail_sharp_k). 0 = off.
    MNLE_TAIL_SHARP_K: float = 0.0
    # None = auto: set just below the training data's left edge in
    # standardized flow units (q0.001 - 0.25), so observed decision times
    # are untouched and only the below-support region is suppressed.
    MNLE_TAIL_SHARP_C: Optional[float] = None
    # Conditional location-scale layer before the spline chain (round-4):
    # lets near-deterministic conditional decision-time densities sharpen
    # via one -log_sigma term instead of extreme spline derivatives — the
    # measured over-smoothing mechanism behind the residual one-sided tau
    # SBC bias (nets/mnle_net.MNLEConfig.cond_affine).
    MNLE_COND_AFFINE: bool = False

    # MNLE training loop.
    TRAIN_LEARNING_RATE: float = 5e-4
    TRAIN_VALIDATION_FRACTION: float = 0.1
    TRAIN_STOP_AFTER_EPOCHS: int = 20      # early-stopping patience
    TRAIN_MAX_EPOCHS: int = 500

    # MCMC engine: "nuts" (flagship), "hmc", or "slice".
    MCMC_METHOD: str = "nuts"
    MCMC_MAX_TREE_DEPTH: int = 10
    MCMC_TARGET_ACCEPT: float = 0.8
    MCMC_THIN: int = 1
    # Pulse-grid mode hop: the true pulse-DDM posterior is near-periodically
    # multimodal in t_nd (RT grid aliasing, period = PULSE_INTERVAL); this
    # enables a Metropolis shift move between the modes inside NUTS/slice
    # (inference/mcmc.make_grid_hop). Valid MCMC; strictly improves mixing.
    MCMC_GRID_HOP: bool = True
    # Within-basin t_nd mixer: a gradient-free 1-D slice update of the
    # unconstrained t_nd coordinate after every NUTS transition
    # (inference/mcmc.make_dim_slice, composed with the grid hop). Built
    # for hard-onset likelihoods (MNLE_RT_REP="shifted_log" zeroes the
    # density at t_nd >= min rt): leapfrog diverges at that wall while a
    # slice interval shrinks off it (measured: calibration_shifted10m_96
    # split-R-hat up to 1.9e5 on 24/96 datasets without it). Off by
    # default; costs up to ~37 extra potential evals per transition.
    MCMC_TAU_SLICE: bool = False
    # Interval width in UNCONSTRAINED space (Beta-support t_nd maps through
    # a logit, where the posterior scale is O(0.1-1)).
    MCMC_TAU_SLICE_WIDTH: float = 1.0
    # Parallel tempering (replica exchange): >1 runs that many replicas per
    # chain on a geometric inverse-temperature ladder down to
    # MCMC_PT_BETA_MIN, with DEO swap sweeps every MCMC_PT_SWAP_EVERY
    # transitions (inference/nuts.ReplicaExchange). The cure for the rugged
    # multimodal (a0, v, B, t_nd) landscape that leaves trajectory samplers
    # basin-stuck (BENCH_NOTES round-2 "real root cause"); composes with
    # MCMC_GRID_HOP. 1 = off.
    MCMC_PT_REPLICAS: int = 1
    MCMC_PT_BETA_MIN: float = 0.1
    MCMC_PT_SWAP_EVERY: int = 1
    # NUTS -> slice auto-fallback on adaptation failure (divergence storm /
    # catastrophic R-hat). Off reproduces a fixed-kernel run exactly — used
    # by benchmarks/golden_parity.py --mimic-reference to replicate the
    # reference's fixed pyro-NUTS behavior (reference mnle.py:82-90).
    MCMC_AUTO_FALLBACK: bool = True

    # SBC mixing gate (round-3 VERDICT #2): pooled ranks from unmixed
    # chains silently bias the headline uniformity p-values, so the batched
    # SBC driver flags datasets whose cold chains show split-R-hat above
    # SBC_RHAT_GATE or min-ESS below SBC_MIN_ESS_GATE and re-runs up to
    # SBC_REMEDIATE_MAX of them for up to SBC_REMEDIATE_ROUNDS escalating
    # rounds (round r: warmup x 2r, PT beta_min / 2^r, and — when
    # SBC_REMEDIATE_TAU_INIT — a min-RT-informed t_nd init, since
    # t_nd < min(rt) by construction). Remediated draws are substituted
    # unconditionally (the escalated config strictly dominates, so this is
    # not a cherry-pick) and uniformity is reported both pooled and
    # mixed-only. (The reference prints per-dataset progress and pools
    # blindly, reference mnle.py:218.)
    SBC_RHAT_GATE: float = 1.05
    SBC_MIN_ESS_GATE: float = 8.0
    SBC_REMEDIATE: bool = True
    SBC_REMEDIATE_MAX: int = 32
    SBC_REMEDIATE_ROUNDS: int = 3
    SBC_REMEDIATE_TAU_INIT: bool = True

    # Simulator kernel: "auto" (the fused Pallas kernel on the GPU, scan
    # elsewhere), "scan" (pure XLA), or "pallas" (ops/ddm_pallas.py; GPU only).
    SIM_KERNEL: str = "auto"
    # Steps per early-exit chunk; pulse-aligned (200 steps = 1 pulse interval).
    SIM_CHUNK_STEPS: int = 200

    def replace(self, **kwargs) -> "RunConfig":
        """Non-mutating override, replacing the reference's ``_CfgShim``
        pattern (reference mnle.py:166-177)."""
        return dataclasses.replace(self, **kwargs)


RUN_CONFIG_PARAMS = RunConfig()

# The calibrated stack (round-4 VERDICT #5): the defaults above keep the
# reference's field values for API/shape parity (reference run_config.py:4-44),
# but the repo's own calibration evidence (artifacts/CALIBRATION_INDEX.md)
# shows that estimator/sampler stack mis-calibrated at scale. This preset is
# the configuration the SBC oracle is run against — shifted-log RT
# representation with censoring, log-reparameterized LogNormal condition
# dims, and the PT6 + tau-slice sampler tier — at the 10M-simulation budget
# the evidence was gathered at. ``pipeline --preset calibrated`` (and the
# README quick-start) use it.
CALIBRATED_CONFIG = RUN_CONFIG_PARAMS.replace(
    NUM_SIMULATIONS=10_000_000,
    MNLE_CENSOR_RT=True,
    MNLE_RT_REP="shifted_log",
    MNLE_LOG_THETA_DIMS=(1, 2, 3),
    NUM_CHAINS=4,
    WARMUP_STEPS=200,
    MCMC_PT_REPLICAS=6,
    MCMC_PT_BETA_MIN=0.04,
    MCMC_TAU_SLICE=True,
)
