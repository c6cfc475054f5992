"""Hierarchical multi-subject pulse-DDM: per-subject theta under a population
prior, with joint NUTS over (population, subjects).

A capability extension over the reference (BASELINE.json config
"Hierarchical multi-subject DDM: per-subject theta, many-chain MCMC sharded
over a device mesh"); the reference fits one theta per session only
(reference: src/sbi_for_diffusion_models/mnle.py:52-95) and its notebooks fit
rats independently (reference: src/notebooks/pulse_ddm_model.ipynb cells 7-9).

Model (non-centered, in the unconstrained space of the single-subject prior's
``mcmc_transform`` bijection):

    mu_d     ~ Normal(m0_d, s0_d)          population location, d = 1..5
    log tau_d~ Normal(lt0_d, st0_d)        population scale
    eps_sd   ~ Normal(0, 1)                subject offsets (non-centered)
    u_sd     = mu_d + tau_d * eps_sd
    theta_s  = bijector.forward(u_s)       back to constrained DDM params
    x_s      ~ MNLE likelihood conditioned on (theta_s, pulses_s)

The joint parameter vector is [mu (5), log_tau (5), eps (S*5)]; every term is
a pure function, so the whole posterior runs as vmapped (and mesh-sharded)
NUTS chains.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..distributions import Bijector, Distribution, mcmc_transform
from ..utils.rng import as_key

__all__ = [
    "HierarchicalModel",
    "simulate_hierarchical_sessions",
    "run_hierarchical_inference",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass(frozen=True)
class HierarchicalModel:
    """Population hyperprior + the subject-level bijection."""

    theta_dim: int
    mu_loc: jnp.ndarray  # (D,) prior mean of population location
    mu_scale: jnp.ndarray
    log_tau_loc: jnp.ndarray
    log_tau_scale: jnp.ndarray

    @staticmethod
    def from_prior(
        prior: Distribution,
        mu_frac: float = 0.75,
        tau_frac: float = 0.4,
        num_moment_samples: int = 8192,
        seed: int = 0,
    ) -> "HierarchicalModel":
        """Moment-match the hyperprior to the single-subject prior.

        The implied subject distribution u_sd = mu_d + tau_d * eps_sd must
        put its mass where the MNLE surrogate was TRAINED (the single-subject
        prior), because the surrogate is only a faithful likelihood there.
        We estimate the prior's unconstrained per-dim moments (mean_d,
        std_d) by pushing ``num_moment_samples`` prior draws through the
        ``mcmc_transform`` bijection (deterministic key), then set

            mu_d      ~ Normal(mean_d, mu_frac * std_d)
            log tau_d ~ Normal(log(tau_frac * std_d), 0.4)

        so the marginal subject variance is ~(mu_frac^2 + tau_frac^2 *
        e^{0.32}) * std_d^2 ~ 0.78 std_d^2 — inside the trained support.

        The previous default (mu_loc = 0, mu_scale = 1.5) was centered
        wrongly for log-scale dims — e.g. the B prior LogNormal(2.75, 0.5)
        has unconstrained mean 2.75, so hyperprior draws put subjects at
        B ~ 1 where the estimator never saw data; measured effect:
        hyperparameter-coverage mu ~ 0.4 at nominal 0.9 and the round-2
        demo's 49% population error.
        """
        bij = mcmc_transform(prior)
        D = bij.dim
        theta = prior.sample(jax.random.key(seed), (num_moment_samples,))
        u = bij.inverse(jnp.asarray(theta, jnp.float32))
        mean_u = jnp.mean(u, axis=0)
        std_u = jnp.std(u, axis=0)
        return HierarchicalModel(
            theta_dim=D,
            mu_loc=mean_u.astype(jnp.float32),
            mu_scale=(mu_frac * std_u).astype(jnp.float32),
            log_tau_loc=jnp.log(tau_frac * std_u).astype(jnp.float32),
            log_tau_scale=jnp.full((D,), 0.4, jnp.float32),
        )

    # -- packing ------------------------------------------------------------
    def dim(self, num_subjects: int) -> int:
        return 2 * self.theta_dim + num_subjects * self.theta_dim

    def unpack(self, q: jnp.ndarray, num_subjects: int):
        D = self.theta_dim
        mu = q[:D]
        log_tau = q[D : 2 * D]
        eps = q[2 * D :].reshape(num_subjects, D)
        return mu, log_tau, eps

    def subject_u(self, q: jnp.ndarray, num_subjects: int) -> jnp.ndarray:
        mu, log_tau, eps = self.unpack(q, num_subjects)
        return mu[None, :] + jnp.exp(log_tau)[None, :] * eps

    def log_prior(self, q: jnp.ndarray, num_subjects: int) -> jnp.ndarray:
        mu, log_tau, eps = self.unpack(q, num_subjects)

        def normal_lp(x, loc, scale):
            return jnp.sum(
                -jnp.log(scale) - _LOG_SQRT_2PI - 0.5 * ((x - loc) / scale) ** 2
            )

        return (
            normal_lp(mu, self.mu_loc, self.mu_scale)
            + normal_lp(log_tau, self.log_tau_loc, self.log_tau_scale)
            + jnp.sum(-_LOG_SQRT_2PI - 0.5 * eps**2)
        )


def simulate_hierarchical_sessions(
    prior: Distribution,
    num_subjects: int,
    trials_per_subject: int,
    *,
    model: Optional[HierarchicalModel] = None,
    mu_sensory: float = 1.0,
    p_success: float = 0.75,
    seed=0,
    return_hyperparams: bool = False,
    hyper_shrink: float = 0.5,
):
    """Draw per-subject theta from the hierarchy and simulate all sessions in
    one batched kernel call. Returns (theta_true (S, D), x (S, T, 2),
    pulses (S, T, P)); with ``return_hyperparams`` also the generating
    ``(mu, log_tau)`` in the unconstrained space — the ground truth for
    hyperparameter coverage checks (benchmarks/hierarchical_coverage.py)."""
    from .rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
        rt_choice_model_simulator_torch,
    )

    key = as_key(seed)
    bij = mcmc_transform(prior)
    if model is None:
        model = HierarchicalModel.from_prior(prior)
    D = model.theta_dim
    k_mu, k_tau, k_eps, k_stim, k_sim = jax.random.split(key, 5)
    # hyper_shrink < 1 draws hyperparameters from a narrowed hyperprior —
    # convenient for demos (keeps subjects in a plausible range) but NOT
    # valid for coverage checks, which require sampling the exact
    # hyperprior the inference uses (hyper_shrink=1.0).
    mu = model.mu_loc + model.mu_scale * hyper_shrink * jax.random.normal(
        k_mu, (D,)
    )
    log_tau = (
        model.log_tau_loc
        + model.log_tau_scale * hyper_shrink * jax.random.normal(k_tau, (D,))
    )
    tau = jnp.exp(log_tau)
    eps = jax.random.normal(k_eps, (num_subjects, D))
    theta_true = bij.forward(mu[None, :] + tau[None, :] * eps)

    S, T = num_subjects, trials_per_subject
    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    pulses = generate_pulse_matrix(k_stim, S * T, P, p_success=p_success)
    theta_rep = jnp.repeat(theta_true, T, axis=0)
    x = rt_choice_model_simulator_torch(
        theta_rep, rng=k_sim, mu_sensory=mu_sensory, pulse_sides=pulses
    )
    out = (theta_true, x.reshape(S, T, 2), pulses.reshape(S, T, P))
    if return_hyperparams:
        return out + ((mu, log_tau),)
    return out


def run_hierarchical_inference(
    density_estimator,
    prior: Distribution,
    x: jnp.ndarray,  # (S, T, 2) packed [rt, choice]
    pulses: jnp.ndarray,  # (S, T, P)
    *,
    model: Optional[HierarchicalModel] = None,
    num_chains: int = 8,
    num_warmup: int = 300,
    num_samples: int = 500,
    max_tree_depth: int = 10,
    target_accept: float = 0.8,
    pt_replicas: int = 1,
    pt_beta_min: float = 0.04,
    segment_length: int = 50,
    mesh=None,
    seed=0,
    verbose: bool = True,
) -> dict:
    """Joint NUTS over (mu, log_tau, eps_{1..S}); chains vmapped, and sharded
    over a mesh when one is given. Returns population and per-subject draws in
    constrained theta space.

    ``pt_replicas`` > 1 runs each chain as a parallel-tempering replica group
    on a geometric likelihood ladder (inference/nuts.ReplicaExchange) and
    returns the cold rung. The joint posterior inherits the subject-level
    t_nd grid multimodality (BENCH_NOTES round-2 "real root cause"):
    measured plain-NUTS coverage reps show worst split-R-hat up to ~2 on
    hard datasets, the same pathology PT fixed for single-subject SBC.

    ``x`` may carry an extra leading axis B of independent datasets —
    shapes (B, S, T, 2) / (B, S, T, P) — in which case all B inferences
    run as ONE vmapped NUTS launch (rows = B * chains * replicas, each row
    conditioned on its dataset through run_nuts's per-chain ``data``; same
    fold the SBC driver uses for datasets, mnle._run_sbc_batched) and every
    returned array gains the leading B axis. This collapses B sequential
    NUTS runs into one launch, which is what keeps the hyperparameter-
    coverage benchmark (B ~ 10 repetitions) to one compiled sampler.
    """
    from ..inference.nuts import ReplicaExchange, geometric_ladder, run_nuts

    key = as_key(seed)
    bij = mcmc_transform(prior)
    if model is None:
        model = HierarchicalModel.from_prior(prior)
    x = jnp.asarray(x, jnp.float32)
    pulses = jnp.asarray(pulses, jnp.float32)
    batched = x.ndim == 4
    xs = x if batched else x[None]
    ps = pulses if batched else pulses[None]
    B, S, T, _ = xs.shape
    D = model.theta_dim
    est = density_estimator

    # One batched log-prob call over all S*T trial rows per potential
    # evaluation (a per-trial nested vmap evaluated S x T tiny forwards per
    # leapfrog). MNLEEnsemble duck-types log_prob_fn, so the mixture
    # likelihood threads through the hierarchy unchanged.
    def lp_fn(x_rows, cond):
        return est.log_prob_fn(est.params, x_rows, cond)
    P_dim = ps.shape[-1]

    def ll_rep(q, rep):
        """MNLE data likelihood of dataset ``rep`` — the tempered term
        under PT."""
        x_r = jnp.take(xs, rep, axis=0).reshape(S * T, 2)
        s_r = jnp.take(ps, rep, axis=0).reshape(S * T, P_dim)
        u_s = model.subject_u(q, S)  # (S, D)
        theta_s = bij.forward(u_s)
        theta_rows = jnp.repeat(theta_s, T, axis=0)  # (S*T, D)
        cond = jnp.concatenate([theta_rows, s_r], axis=-1)
        return jnp.sum(lp_fn(x_r, cond))

    def ll_fn(q):
        return ll_rep(q, 0)

    def base_fn(q):
        """Hyperprior + per-subject bijection Jacobian (untempered): the
        likelihood is over theta but NUTS runs in (mu, log_tau, eps), so
        log|d theta / d u| enters once per subject."""
        u_s = model.subject_u(q, S)
        jac = jax.vmap(bij.forward_log_det)(u_s).sum()
        return model.log_prior(q, S) + jac

    def logp(q):
        return base_fn(q) + ll_fn(q)

    dim = model.dim(S)
    # Initialize at the hyperprior center (mu_loc is NOT zero for log-scale
    # dims — e.g. the B dim's unconstrained mean is 2.75), jittered at ~1/10
    # of each block's prior scale so chains start overdispersed-but-plausible.
    center = jnp.concatenate(
        [model.mu_loc, model.log_tau_loc, jnp.zeros(S * D, jnp.float32)]
    )
    scale = jnp.concatenate(
        [model.mu_scale, model.log_tau_scale, jnp.ones(S * D, jnp.float32)]
    )
    R = int(pt_replicas)
    rows = B * num_chains * R
    init_q = center[None, :] + 0.1 * scale[None, :] * jax.random.normal(
        jax.random.fold_in(key, 0), (rows, dim)
    )

    kw = dict(
        num_warmup=num_warmup, num_samples=num_samples,
        max_depth=max_tree_depth, target_accept=target_accept,
        # Per-launch work scales with rows x segment_length x 2^depth.
        # Batched (many-row) runs pass a short segment_length to bound each
        # launch; the cap was set on earlier hardware and is not measured
        # on the GPU.
        segment_length=segment_length,
    )
    target = logp
    if batched:
        # Row order: dataset-major, then chain, then rung — replica groups
        # stay CONTIGUOUS with the cold rung first (ReplicaExchange contract).
        rep_ids = jnp.repeat(jnp.arange(B), num_chains * R)
        if R > 1:
            betas = jnp.tile(jnp.asarray(geometric_ladder(R, pt_beta_min)),
                             B * num_chains)

            def target(q, d):  # noqa: F811 — tempered, per-row dataset
                return base_fn(q) + d["beta"] * ll_rep(q, d["rep"])

            kw["data"] = {"beta": betas, "rep": rep_ids}
            kw["exchange"] = ReplicaExchange(
                n_replicas=R, betas=betas,
                ll_fn=lambda q, d: ll_rep(q, d["rep"]), swap_every=1,
            )
        else:

            def target(q, d):  # noqa: F811 — per-row dataset
                return base_fn(q) + ll_rep(q, d["rep"])

            kw["data"] = {"rep": rep_ids}
    elif R > 1:
        betas = jnp.tile(jnp.asarray(geometric_ladder(R, pt_beta_min)),
                         num_chains)  # chain-major groups, cold rung first

        def target(q, beta):  # noqa: F811 — tempered joint density
            return base_fn(q) + beta * ll_fn(q)

        kw["data"] = betas
        kw["exchange"] = ReplicaExchange(
            n_replicas=R, betas=betas,
            ll_fn=lambda q, beta: ll_fn(q), swap_every=1,
        )

    if mesh is not None:
        from ..parallel.mesh import sharded_run_nuts

        samples, info = sharded_run_nuts(
            jax.random.fold_in(key, 1), target, init_q, mesh=mesh, **kw
        )
    else:
        samples, info = run_nuts(
            jax.random.fold_in(key, 1), target, init_q, **kw
        )
    if R > 1:  # keep the cold (beta = 1) rung of each replica group
        samples = samples.reshape(B * num_chains, R, num_samples, dim)[:, 0]

    # (B*C, N, dim) -> constrained summaries (leading B axis kept iff the
    # input carried one).
    C, N = num_chains, num_samples
    flat = samples.reshape(B * C * N, dim)
    u_subj = jax.vmap(lambda q: model.subject_u(q, S))(flat)  # (BCN, S, D)
    theta_subj = bij.forward(u_subj)
    mu_pop = bij.forward(flat[:, :D])  # population location mapped to theta space
    if verbose:
        ap = float(jnp.mean(info["accept_prob"]))
        dv = int(jnp.sum(info["diverging"]))
        print(
            f"[hierarchical] datasets={B} chains={C} draws={N} subjects={S} "
            f"mean_accept={ap:.3f} divergences={dv}"
        )
    if batched:
        raw = np.asarray(samples).reshape(B, C, N, dim)
        theta_out = np.asarray(theta_subj).reshape(B, C * N, S, D)
        mu_out = np.asarray(mu_pop).reshape(B, C * N, D)
    else:
        raw = np.asarray(samples)
        theta_out = np.asarray(theta_subj)  # (C*N, S, D)
        mu_out = np.asarray(mu_pop)  # (C*N, D)
    return {
        "raw": raw,
        "theta_subjects": theta_out,
        "population_theta": mu_out,
        "swap_accept": info.get("swap_accept") if R > 1 else None,
        "info": info,
    }
