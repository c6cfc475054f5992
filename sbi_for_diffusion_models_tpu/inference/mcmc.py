"""MCMCPosterior: the user-facing sampler wrapper.

API parity with sbi's ``MCMCPosterior`` as the reference uses it
(reference: src/sbi_for_diffusion_models/mnle.py:77-93): construct with a
potential, a proposal (for initialization, ``init_strategy="proposal"``), and
a theta transform; call ``.sample((S,), x=x_o)`` to get S posterior draws.

Design: the potential is a pure function, so the whole MCMC run —
warmup adaptation and sampling for all chains — is one compiled program.
Chains are vmapped; the per-chain draw budget is ceil(S / num_chains) and
chains are interleaved into the flat (S, D) output, matching the reference's
chain-pooled return (reference mnle.py:89-95).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..distributions import Bijector, Distribution
from ..utils.rng import as_key
from .nuts import ReplicaExchange, geometric_ladder, run_nuts
from .slice import run_slice

__all__ = ["MCMCPosterior"]


class MCMCPosterior:
    def __init__(
        self,
        potential_fn,
        proposal: Distribution,
        theta_transform: Bijector,
        *,
        method: str = "nuts",
        num_chains: int = 2,
        warmup_steps: int = 100,
        thin: int = 1,
        max_tree_depth: int = 10,
        target_accept: float = 0.8,
        init_strategy: str = "proposal",
        num_workers: int = 1,
        verbose: bool = True,
        auto_fallback: bool = True,
        fallback_divergence_rate: float = 0.10,
        fallback_r_hat: float = 1.5,
        mode_hop=None,
        pt_replicas: int = 1,
        pt_beta_min: float = 0.1,
        pt_swap_every: int = 1,
    ):
        if method not in ("nuts", "nuts_pyro", "hmc", "slice", "slice_np_vectorized"):
            raise ValueError(f"unknown MCMC method {method!r}")
        if init_strategy not in ("proposal", "resample"):
            # sbi also offers "sir"/"latest_sample"; anything we don't
            # implement is rejected instead of silently running "proposal".
            raise ValueError(
                f"unknown init_strategy {init_strategy!r}: "
                "expected 'proposal' or 'resample'"
            )
        self.potential = potential_fn
        self.proposal = proposal
        self.bij = theta_transform
        self.method = {"nuts_pyro": "nuts", "slice_np_vectorized": "slice"}.get(
            method, method
        )
        self.num_chains = int(num_chains)
        self.warmup_steps = int(warmup_steps)
        self.thin = int(thin)
        self.max_tree_depth = int(max_tree_depth)
        self.target_accept = float(target_accept)
        self.init_strategy = init_strategy
        self.verbose = verbose
        # NUTS -> slice auto-fallback (the reference notebooks' operational
        # recipe, ryans_test.ipynb cell 4: try nuts_pyro, fall back to
        # slice_np_vectorized): trigger on divergence storms or failed
        # mixing (split R-hat), both signs of adaptation failure on stiff
        # learned-likelihood geometry.
        self.mode_hop = mode_hop
        # Parallel tempering (replica exchange): pt_replicas > 1 runs that
        # many replicas per chain on a geometric beta ladder down to
        # pt_beta_min, swapping states between adjacent rungs (DEO sweeps)
        # every pt_swap_every transitions — the cure for the rugged
        # multimodal pulse-DDM landscape that leaves trajectory samplers
        # basin-stuck (see inference/nuts.ReplicaExchange). NUTS-only.
        self.pt_replicas = int(pt_replicas)
        self.pt_beta_min = float(pt_beta_min)
        self.pt_swap_every = int(pt_swap_every)
        if self.pt_replicas > 1 and self.method not in ("nuts", "hmc"):
            raise ValueError(
                "pt_replicas > 1 requires the NUTS driver (parallel "
                "tempering is not wired into run_slice)"
            )
        self.auto_fallback = bool(auto_fallback)
        self.fallback_divergence_rate = float(fallback_divergence_rate)
        self.fallback_r_hat = float(fallback_r_hat)
        self.used_fallback = False
        self._last_info: Optional[dict] = None

    # -- potential in unconstrained space ----------------------------------
    def _logp_u(self, u):
        theta = self.bij.forward(u)
        return self.potential.potential_fn(theta) + self.bij.forward_log_det(u)

    def _init_positions(self, key, n: int | None = None) -> jnp.ndarray:
        """Chain starts. "proposal": draw from the proposal (reference
        mnle.py:85). "resample": draw a pool from the proposal, weight by the
        potential, and resample the starts (sbi's importance-resampling
        init) — chains start in the posterior's bulk, shortening warmup."""
        n = self.num_chains if n is None else int(n)
        if self.init_strategy == "proposal":
            theta0 = self.proposal.sample(key, (n,))
            return self.bij.inverse(jnp.asarray(theta0, jnp.float32))
        k_pool, k_pick = jax.random.split(key)
        pool_size = max(32 * n, 256)
        pool = jnp.asarray(
            self.proposal.sample(k_pool, (pool_size,)), jnp.float32
        )
        logw = jax.jit(jax.vmap(self.potential.potential_fn))(pool)
        logw = jnp.where(jnp.isfinite(logw), logw, -jnp.inf)
        idx = jax.random.categorical(k_pick, logw, shape=(n,))
        return self.bij.inverse(pool[idx])

    def _split_logp(self):
        """(base_fn, ll_fn) in u-space with logp_u(u) = base(u) + ll(u),
        where ``ll`` is the term a tempering beta multiplies. When the
        potential exposes the (prior, likelihood) split (e.g.
        ThetaOnlyPosteriorPotential), only the likelihood is tempered and
        the prior stays — every rung is then a proper distribution. For an
        opaque potential the whole density is tempered (base = 0), which is
        valid PT whenever the prior-included target is proper."""
        pot = self.potential
        if hasattr(pot, "prior") and hasattr(pot, "likelihood"):

            def base(u):
                theta = self.bij.forward(u)
                return pot.prior.log_prob(theta) + self.bij.forward_log_det(u)

            def ll(u):
                theta = self.bij.forward(u)
                lik = pot.likelihood.log_lik_fn(
                    pot.likelihood.estimator.params,
                    pot.x_o,
                    theta.reshape(1, -1),
                )[0]
                return lik / pot.temperature

            return base, ll
        return (lambda u: jnp.float32(0.0)), self._logp_u

    def _nuts_failed(self, samples_u, info) -> bool:
        """Health check behind the NUTS -> slice auto-fallback."""
        if not bool(jnp.all(jnp.isfinite(samples_u))):
            return True
        div_rate = float(jnp.mean(info["diverging"].astype(jnp.float32)))
        if div_rate > self.fallback_divergence_rate:
            return True
        if self.num_chains >= 2 and samples_u.shape[1] >= 10:
            from .diagnostics import split_r_hat

            if float(np.max(split_r_hat(np.asarray(samples_u)))) > self.fallback_r_hat:
                return True
        return False

    def sample(
        self,
        sample_shape: Tuple[int, ...],
        x=None,
        *,
        key=None,
        seed: int | None = 0,
        show_progress_bars: bool = False,
    ) -> jnp.ndarray:
        """Draw ``sample_shape[0]`` pooled posterior samples (S, D)."""
        if x is not None and hasattr(self.potential, "set_x_o"):
            self.potential.set_x_o(x)
        num_samples = int(sample_shape[0])
        key = as_key(key if key is not None else seed)
        k_init, k_run = jax.random.split(key)

        per_chain = math.ceil(num_samples / self.num_chains)
        R = self.pt_replicas

        if self.method in ("nuts", "hmc") and R > 1:
            # Parallel tempering: C cold chains, each with R contiguous
            # replicas (cold rung first) on a geometric beta ladder; beta
            # rides in ``data`` so one compiled logp serves every rung, and
            # DEO swap sweeps run between transitions inside run_nuts.
            init_u = self._init_positions(k_init, self.num_chains * R)
            base_fn, ll_fn = self._split_logp()
            ladder = geometric_ladder(R, self.pt_beta_min)
            betas = jnp.tile(jnp.asarray(ladder, jnp.float32), self.num_chains)

            def logp_pt(u, beta):
                return base_fn(u) + beta * ll_fn(u)

            exchange = ReplicaExchange(
                n_replicas=R,
                betas=betas,
                ll_fn=lambda u, beta: ll_fn(u),
                swap_every=self.pt_swap_every,
            )
            samples_u, info = run_nuts(
                k_run,
                logp_pt,
                init_u,
                num_warmup=self.warmup_steps,
                num_samples=per_chain,
                max_depth=self.max_tree_depth,
                target_accept=self.target_accept,
                thin=self.thin,
                data=betas,
                mode_hop=self.mode_hop,
                exchange=exchange,
            )
            # Keep only the cold (beta = 1) rung of each replica group.
            # No slice auto-fallback here: plain slice would be a strict
            # downgrade from a tempered ensemble on multimodal targets.
            C, _, D = (
                self.num_chains,
                samples_u.shape[1],
                samples_u.shape[-1],
            )
            samples_u = samples_u.reshape(C, R, per_chain, D)[:, 0]
        elif self.method in ("nuts", "hmc"):
            init_u = self._init_positions(k_init)
            samples_u, info = run_nuts(
                k_run,
                self._logp_u,
                init_u,
                num_warmup=self.warmup_steps,
                num_samples=per_chain,
                max_depth=self.max_tree_depth,
                target_accept=self.target_accept,
                thin=self.thin,
                mode_hop=self.mode_hop,
            )
            if self.auto_fallback and self._nuts_failed(samples_u, info):
                self.used_fallback = True
                print(
                    "[mcmc] NUTS unhealthy (divergence storm / failed "
                    "mixing); falling back to the vectorized slice sampler "
                    "(reference recipe, ryans_test.ipynb cell 4)"
                )
                samples_u, info = run_slice(
                    jax.random.fold_in(k_run, 1),
                    self._logp_u,
                    init_u,
                    num_warmup=self.warmup_steps,
                    num_samples=per_chain,
                    thin=self.thin,
                    mode_hop=self.mode_hop,
                )
        else:
            init_u = self._init_positions(k_init)
            samples_u, info = run_slice(
                k_run,
                self._logp_u,
                init_u,
                num_warmup=self.warmup_steps,
                num_samples=per_chain,
                thin=self.thin,
                mode_hop=self.mode_hop,
            )
        self._last_info = info

        # (C, S_per, D) -> interleave chains -> (C * S_per, D) -> trim to S.
        theta = self.bij.forward(samples_u)
        pooled = jnp.swapaxes(theta, 0, 1).reshape(-1, theta.shape[-1])
        out = pooled[:num_samples]
        if self.verbose and self.method == "nuts" and "diverging" in info:
            ap = float(jnp.mean(info["accept_prob"]))
            dv = int(jnp.sum(info["diverging"]))
            print(
                f"[mcmc] nuts: chains={self.num_chains} draws/chain={per_chain} "
                f"mean_accept={ap:.3f} divergences={dv}"
            )
        if self.verbose and self.num_chains >= 2 and per_chain >= 10:
            from .diagnostics import summarize_chains

            self._last_diagnostics = summarize_chains(
                np.asarray(theta), verbose=True
            )
        return out

    @property
    def last_info(self) -> Optional[dict]:
        return self._last_info


def make_grid_hop(
    bij, index: int, delta: float, multiples=(-2, -1, 1, 2), bounds=None
):
    """Metropolis mode-hop for KNOWN periodic posterior structure.

    The pulse-DDM posterior is near-periodically multimodal in t_nd: shifting
    t_nd by one pulse interval Delta while re-attributing every trial's hit
    to the adjacent pulse leaves the likelihood almost unchanged (the RT
    grid rt = t_nd + k*Delta aliases), so trajectory-based samplers get
    stuck in one t_nd mode (observed: split-R-hat up to ~300 with ZERO
    divergences). This move proposes theta' = theta with theta[index]
    shifted by m*Delta (m drawn uniformly from symmetric ``multiples``) and
    accepts with the exact posterior ratio — a valid MH kernel in theta
    space (the proposal is symmetric there, so bijector terms cancel except
    through the evaluated densities; see run_nuts ``mode_hop``).

    Returns ``hop(key, u, logp, g, vg_fn) -> (u, logp, g)`` operating on the
    UNCONSTRAINED state used by run_nuts/run_slice: logp/g are u-space
    values including the bijector log-det, so the theta-space ratio is
    recovered by subtracting ``bij.forward_log_det`` on both sides.
    Out-of-support proposals are rejected exactly (target density zero).

    ``bounds``: optional (lo, hi) support of theta[index]. When None it is
    derived from the bijector's per-dimension support metadata
    (distributions.Bijector: interval -> (lo, hi), positive -> (0, inf),
    real -> (-inf, inf)), so the hop is correct for any prior — not just
    the 5-param model's Beta-supported t_nd in (0, 1).
    """
    delta = float(delta)
    mults = jnp.asarray(multiples, jnp.float32)
    if bounds is None:
        kind = bij._kinds[index]
        if kind == "interval":
            bounds = (float(bij._lo[index]), float(bij._hi[index]))
        elif kind == "positive":
            bounds = (0.0, float("inf"))
        else:
            bounds = (float("-inf"), float("inf"))
    lo_b, hi_b = float(bounds[0]), float(bounds[1])
    # Margin keeps proposals strictly inside finite edges (the bijector's
    # inverse clips at the boundary, which would break detailed balance).
    span = hi_b - lo_b
    margin = 1e-6 * span if np.isfinite(span) else 1e-6
    lo_g = lo_b + margin if np.isfinite(lo_b) else lo_b
    hi_g = hi_b - margin if np.isfinite(hi_b) else hi_b

    def hop(key, u, logp, g, vg_fn):
        k_m, k_a = jax.random.split(key)
        m = mults[jax.random.randint(k_m, (), 0, mults.shape[0])]
        theta = bij.forward(u)
        theta_new = theta.at[index].add(m * delta)
        valid = (theta_new[index] > lo_g) & (theta_new[index] < hi_g)
        theta_safe = jnp.where(valid, theta_new, theta)
        u_prop = bij.inverse(theta_safe)
        logp_prop, g_prop = vg_fn(u_prop)
        log_ratio = (logp_prop - bij.forward_log_det(u_prop)) - (
            logp - bij.forward_log_det(u)
        )
        accept = valid & (
            jnp.log(jax.random.uniform(k_a)) < jnp.minimum(log_ratio, 0.0)
        )
        pick = lambda a, b: jnp.where(accept, a, b)
        return pick(u_prop, u), pick(logp_prop, logp), jax.tree.map(pick, g_prop, g)

    return hop


def make_dim_slice(index: int, width: float = 1.0, max_stepout: int = 6,
                   max_shrink: int = 24):
    """Gradient-free slice update of ONE unconstrained coordinate.

    Neal (2003) stepping-out + shrinkage on ``u[index]``, targeting the
    full conditional of the u-space density run_nuts samples (``logp``
    already includes the bijector log-det, so no extra Jacobian terms).
    Built for potentials with hard walls: the shifted-log RT representation
    makes the likelihood exactly zero for t_nd >= min_i rt_i, a boundary
    leapfrog trajectories slam into (calibration_shifted10m_96: divergence
    spikes, split-R-hat up to 1.9e5 on 24/96 datasets) while a slice
    interval simply shrinks off the wall. Intended to compose with
    make_grid_hop (cross-mode) as the within-basin t_nd mixer; plugs into
    the same ``mode_hop`` hook of run_nuts/run_slice (hop(key, u, logp, g,
    vg_fn) -> (u, logp, g), applied once per transition).

    Exactness notes: stepping out uses Neal's LIMITED procedure (Neal 2003
    fig. 3): the total expansion budget m = 2*max_stepout is split randomly
    between the sides, J ~ U{0..m-1} to the left and K = m-1-J to the
    right. The randomized split is what makes the kernel reversible when
    the budget binds — a deterministic expand-both-sides-to-cap rule is NOT
    a valid slice kernel in the binding regime (the interval reachable from
    x0 would not equal the interval reachable from x1), which is exactly
    the regime a hard wall creates. Exercised by the cap-binding invariance
    test (narrow width, wide target). The shrinkage loop is capped at
    max_shrink; on the (never observed at default settings) cap hit the
    move returns the current state, which is a valid (identity) kernel.
    Non-finite proposals are treated as density zero, so -inf walls and
    NaN regions are rejected without branching.

    Cost: <= 2*max_stepout + max_shrink + 1 potential evaluations per
    call (each through ``vg_fn``; gradients are discarded during the
    search and recomputed once at the accepted point).
    """
    from jax import lax

    w = float(width)

    def _lp(vg_fn, u, x):
        lp, _ = vg_fn(u.at[index].set(x))
        return jnp.where(jnp.isfinite(lp), lp, -jnp.inf)

    m_total = 2 * int(max_stepout)

    def move(key, u, logp, g, vg_fn):
        k_y, k_off, k_j, k_sh = jax.random.split(key, 4)
        x0 = u[index]
        # Slice level under the current (finite) logp.
        logy = logp + jnp.log1p(-jax.random.uniform(k_y))
        lo0 = x0 - jax.random.uniform(k_off) * w
        hi0 = lo0 + w
        # Neal's randomized per-side budget: J left, K = m-1-J right.
        j_budget = jax.random.randint(k_j, (), 0, m_total)
        k_budget = (m_total - 1) - j_budget

        def expand(sign, edge, budget):
            def body(i, x):
                above = (i < budget) & (_lp(vg_fn, u, x) > logy)
                return jnp.where(above, x + sign * w, x)
            return lax.fori_loop(0, m_total - 1, body, edge)

        lo = expand(-1.0, lo0, j_budget)
        hi = expand(1.0, hi0, k_budget)

        def cond(c):
            _, _, _, done, it, _ = c
            return (~done) & (it < max_shrink)

        def body(c):
            x, lo, hi, _, it, k = c
            k, kk = jax.random.split(k)
            xp = lo + jax.random.uniform(kk) * (hi - lo)
            ok = _lp(vg_fn, u, xp) > logy
            lo = jnp.where(~ok & (xp < x0), xp, lo)
            hi = jnp.where(~ok & (xp >= x0), xp, hi)
            return jnp.where(ok, xp, x), lo, hi, ok, it + 1, k

        x_new, _, _, accepted, _, _ = lax.while_loop(
            cond, body, (x0, lo, hi, jnp.bool_(False), 0, k_sh)
        )
        x_new = jnp.where(accepted, x_new, x0)
        u_new = u.at[index].set(x_new)
        logp_new, g_new = vg_fn(u_new)
        pick = lambda a, b: jnp.where(accepted, a, b)
        return (
            pick(u_new, u),
            pick(logp_new, logp),
            jax.tree.map(pick, g_new, g),
        )

    return move


def compose_moves(*moves):
    """Compose mode_hop-style moves (each preserves the target, so any
    fixed composition does); applied in order with independent sub-keys."""
    moves = [m for m in moves if m is not None]
    if not moves:
        return None
    if len(moves) == 1:
        return moves[0]

    def move(key, u, logp, g, vg_fn):
        for i, m in enumerate(moves):
            u, logp, g = m(jax.random.fold_in(key, i), u, logp, g, vg_fn)
        return u, logp, g

    return move
